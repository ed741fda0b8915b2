"""The parts of a cfbench run: finding a cell's files by name, making
its log, driving the program's set-up and window, and the comparison
with the plain reference that decides ``correct``.

Everything a configuration, traffic mix, cell, family or per-layer
metric brings sits in a file of its own, found by the name that
``BENCHMARK.json`` gives:

- ``configs/<config>.json``: the model, its options and family;
- ``traffic/<mix>.json``: a mix's parameters, read by the generator
  ``traffic/<generator>.py`` that it names;
- ``workloads/<cell>.json``: the cell's limits and what it expects;
- ``families/<family>.py``, ``reference/<family>.py``,
  ``counts/<family>.py``: the program's side, the plain reference and
  the work count of a model family;
- ``metrics/<metric>.py``: one per-layer metric's reader.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import importlib
import importlib.util
import json
import math
import os
import statistics
import sys
import time

import torch

from cfbench import trace as trace_ranges
from cfbench.reference import loop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# top-level module names that no process of the benchmark may hold
FORBIDDEN = ("jax", "jaxlib", "flax", "mymedialite_tpu")


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


class Cell:
    """One workload of ``BENCHMARK.json`` with every file it names."""

    def __init__(self, spec: dict, name: str, root: str = ROOT):
        here = os.path.join(root, "cfbench")
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.name = name
        self.entry = cells[name]
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in spec["configs"]}
        self.config = _json(os.path.join(root, configs[self.entry["config"]]
                                         ["file"]))
        self.mix = _json(os.path.join(here, "traffic",
                                      self.entry["traffic"] + ".json"))
        self.spec_file = _json(os.path.join(here, "workloads",
                                            name + ".json"))
        self.family = self.config["family"]
        self.program = importlib.import_module(
            f"cfbench.families.{self.family}")
        self.reference = importlib.import_module(
            f"cfbench.reference.{self.family}")
        self.counts = importlib.import_module(f"cfbench.counts.{self.family}")
        self.generator = importlib.import_module(
            f"cfbench.traffic.{self.mix['generator']}")
        self.end_to_end = [m for m in spec["end_to_end"]
                           if name in m.get("workloads", [name])]
        self.per_layer = [m for m in spec["per_layer"]
                          if name in m.get("workloads", [name])]

    @property
    def width(self) -> int:
        return int(self.config["hyperparameters"]["num_factors"])


def metric_reader(name: str, root: str = ROOT):
    """The reader module ``metrics/<name>.py`` (names may hold dots)."""
    path = os.path.join(root, "cfbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "cfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def peaks(kind: str):
    return _json(os.path.join(ROOT, "cfbench", "peaks.json")).get(kind)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def make_log(cell: Cell, seed: int, device) -> dict:
    """The cell's log from ``seed``, drawn on ``device``, as host arrays
    (users, items int64, values float32) with its sizes."""
    log = cell.generator.generate(cell.mix, seed, device)
    out = {k: log[k].cpu().numpy() for k in ("users", "items", "values")}
    out.update({k: log[k] for k in ("num_users", "num_items", "num_ratings",
                                    "draws")})
    del log
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def patched(pairs, wrap):
    """Each (module, attribute) of ``pairs`` replaced by ``wrap(fn)``
    inside the block."""
    saved = []
    for mod_name, attr in pairs:
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, attr)
        saved.append((mod, attr, fn))
        setattr(mod, attr, wrap(fn))
    try:
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


def plan_timer(device, spans: list):
    """A wrapper that appends the host seconds of each outermost call
    (to the device's synchronisation) to ``spans``."""
    depth = [0]

    def wrap(fn):
        @functools.wraps(fn)
        def timed(*a, **kw):
            depth[0] += 1
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                depth[0] -= 1
                if depth[0] == 0:
                    sync(device)
                    spans.append(time.perf_counter() - t)
        return timed
    return wrap


def launches(cell: Cell) -> dict:
    """The port's launch counter of each epoch wrapper (``.launches``)."""
    out = {}
    for mod_name, attr in cell.program.EPOCH_WRAPPERS:
        fn = getattr(importlib.import_module(mod_name), attr)
        out[attr] = int(getattr(fn, "launches", 0))
    return out


# the epochs that set-up drives before the window
SETUP_EPOCHS = 2


def program_setup(cell: Cell, log: dict, seed: int, device, plan_s: list):
    """Build the model through the registry and drive it from the seed
    through its first epoch, as ``train()`` with ``num_iter=1`` does
    (``init_model`` then one ``iterate``), reading its public tables
    before and after, then one more epoch so that the window starts
    warm. Returns (model, leaves before, leaves after the first)."""
    model = cell.program.build(cell.config, log, seed, str(device))
    with patched(cell.program.PLAN_FUNCTIONS, plan_timer(device, plan_s)):
        model.init_model()
        start = cell.program.leaves(model)
        model.iterate()
        first = cell.program.leaves(model)
        for _ in range(SETUP_EPOCHS - 1):
            model.iterate()
    sync(device)
    return model, start, first


def window(model, seconds: float, device, state, trace: bool = False):
    """``model.iterate()`` back to back for ``seconds`` on the host clock
    (at least once), at most two epochs queued: before launching epoch n
    the host waits for epoch n-2. Before each launch the tensors that
    ``state(model)`` gives (what ``iterate`` carries from one epoch to
    the next) are copied, in stream order, into one buffer made before
    the window, which so holds at the end the state that the window's
    last epoch started from. Returns (attempted, failed, elapsed s from
    the start to the device's last completion, error text, buffer)."""
    cuda = torch.device(device).type == "cuda"
    kept = [t.clone() for t in state(model)]
    pending = []
    attempted = failed = 0
    error = ""
    rf = torch.profiler.record_function if trace else \
        (lambda name: contextlib.nullcontext())
    sync(device)
    t0 = time.perf_counter()
    with rf(trace_ranges.WINDOW):
        while attempted == 0 or time.perf_counter() - t0 < seconds:
            if len(pending) >= 2:
                pending.pop(0).synchronize()
            attempted += 1
            for k, t in zip(kept, state(model)):
                k.copy_(t)
            try:
                with rf(trace_ranges.EPOCH):
                    model.iterate()
            except Exception:      # an epoch that raises fails
                import traceback
                failed += 1
                error = traceback.format_exc()
                break
            if cuda:
                ev = torch.cuda.Event()
                ev.record()
                pending.append(ev)
        sync(device)
    return attempted, failed, time.perf_counter() - t0, error, kept


def window_leaves(cell: Cell, model, kept) -> tuple:
    """(leaves before, leaves after) the window's last epoch, read
    through the model's public tables; the program's state is spent."""
    end = cell.program.leaves(model)
    return cell.program.leaves_of(model, kept), end


def free_program(model, device):
    del model
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def readings(cell: Cell, log: dict, seed: int, device, start: dict,
             end: dict, ref_start: dict, ref_end: dict) -> dict:
    """The numbers compared, of the program's epoch from ``start`` to
    ``end`` against the reference's same epoch:

    - ``loss_gap``: |loss(end) - loss(ref_end)| / loss(ref_end), the
      family's training loss (``reference/<family>.py loss``);
    - ``change_gap``: by the worst leaf, |‖end - start‖ - ‖ref_end -
      ref_start‖| over the larger of the reference's change of that leaf
      and of the median leaf, leaves the reference moves by less than a
      thousandth of the median leaf's left out.
    """
    ref = cell.reference
    lr = ref.loss(ref_end, log, device)
    lp = ref.loss(end, log, device)
    d_ref = {k: _norm(ref_end[k] - ref_start[k]) for k in ref.LEAVES}
    d_run = {k: _norm(end[k] - start[k]) for k in ref.LEAVES}
    med = statistics.median(d_ref.values())
    kept = [k for k in ref.LEAVES if d_ref[k] >= 1e-3 * med]
    gaps = {k: abs(d_run[k] - d_ref[k]) / max(d_ref[k], med) for k in kept}
    worst = max(gaps, key=gaps.get)
    return dict(loss_gap=abs(lp - lr) / abs(lr), change_gap=gaps[worst],
                worst_leaf=worst, loss=lp, loss_ref=lr,
                change={k: d_run[k] for k in kept},
                change_ref={k: d_ref[k] for k in kept})


def reference_epochs(cell: Cell, log: dict, seed: int, device,
                     runs: list) -> list:
    """The reference's (start, end) leaves of each run, a dict of
    ``reference/<family>.py epoch``'s keywords (``epoch``, ``tables``,
    ``dtype``, ``fault``), run side by side; TF32 off."""
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ref = cell.reference
    prep = ref.prepare(log, cell.config, seed, device)
    out = loop.run_many([ref.epoch(log, cell.config, seed, device, prep,
                                   **kw) for kw in runs])
    sync(device)
    return out


def window_numbers(numbers: dict) -> dict:
    """The window epoch's readings under names of their own."""
    return {"window_" + k: v for k, v in numbers.items()}


def checks(cell: Cell, numbers: dict) -> dict:
    """{name: {"value", "limit"}} of every number the cell limits."""
    limits = cell.spec_file["limits"]
    return {k: {"value": numbers[k], "limit": limits[k]} for k in limits}


def nvidia_smi() -> str:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc}"


def least_time(work: dict, kind: str):
    """(seconds, "bytes" or "operations") of one epoch at the card's
    published peaks, or None for a card without a row in peaks.json."""
    p = peaks(kind)
    if p is None:
        return None
    t_b = work["bytes"] / p["hbm_bytes_per_s"]
    t_o = work["ops"] / p["fp32_flops_per_s"]
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)
