"""One run of one cfbench cell on the card.

    python3 -m cfbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (timed as ``setup_s`` from the process's start): the cell's log
drawn on the card from ``--seed``, the port's model built through its
registry and driven through its first two epochs. The window drives
``iterate()`` back to back for ``--seconds``. Then, with the program
freed, the plain reference works out again the first epoch, from the
log and the seed, and the window's last epoch, from the program's state
that it started from; the comparison of both decides ``correct``. The
last line of standard output is the result; the numbers compared are
the last lines of standard error.
"""

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """The result of one run of ``cell`` on ``device``, its last key
    ``checks``."""
    import torch

    from cfbench import harness as hz
    from cfbench import trace as tr

    log_ = hz.make_log(cell, seed, device)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    log(f"log: {log_['num_users']} users x {log_['num_items']} items, "
        f"{log_['users'].size} distinct pairs of {log_['draws']} draws")
    plan_s = []
    model, start, first = hz.program_setup(cell, log_, seed, device, plan_s)
    launched0 = hz.launches(cell)
    setup_s = time.perf_counter() - t_start
    log(f"setup {setup_s:.3f} s, plan {sum(plan_s):.3f} s; "
        f"{hz.nvidia_smi()}")

    prof = None
    wrappers = cell.program.EPOCH_WRAPPERS if trace else ()

    def ranged(fn):
        def inner(*a, **kw):
            with torch.profiler.record_function(tr.WRAPPER):
                return fn(*a, **kw)
        return inner

    with hz.patched(wrappers, ranged):
        if trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if cuda:
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.__enter__()
            # let the profiler's device tracing settle before the window
            torch.zeros(1, device=device).add_(1)
            hz.sync(device)
            time.sleep(0.1)
        try:
            attempted, failed, elapsed, error, kept = hz.window(
                model, seconds, device, cell.program.state, trace)
        finally:
            if prof is not None:
                prof.__exit__(None, None, None)
    done = attempted - failed
    launched = {k: v - launched0.get(k, 0)
                for k, v in hz.launches(cell).items()}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    log(f"window: {attempted} epochs attempted, {failed} failed, "
        f"{elapsed:.4f} s; launches {launched}; peak device memory "
        f"{peak} B")
    if error:
        log(error)
    before, end = hz.window_leaves(cell, model, kept)
    del kept
    hz.free_program(model, device)

    work = cell.counts.work(log_, cell.width)
    rate_name, rate_unit = cell.program.RATE
    e2e = {"setup_s": (setup_s, "s"),
           rate_name: (work["examples"] * done / elapsed, rate_unit)}
    metrics = {}
    breakdown = None
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": cell.chips, "memory_peak_bytes": int(peak)}
    if trace:
        red = tr.reduce(prof.profiler.kineto_results.events())
        del prof
        device_info.update(busy_s=red["busy_s"], window_s=red["window_s"])
        breakdown = {"device_ops": red["device_ops"],
                     "idle_gaps": red["idle_gaps"]}
        ctx = dict(family=cell.family, work=work, epochs=done,
                   host_window_s=elapsed,
                   traced_epochs=red["wrapped_epochs"],
                   window_s=red["window_s"], busy_s=red["busy_s"],
                   wrapped_s=red["wrapped_s"], plan_s=plan_s,
                   least=hz.least_time(work, kind), peaks=hz.peaks(kind),
                   launched=launched)
        log(f"trace: busy {red['busy_s']:.6f} s of {red['window_s']:.6f} "
            f"s, {red['wrapped_ops']} operations {red['wrapped_s']:.6f} s "
            f"inside {red['wrapped_ranges']} epoch wrapper ranges, "
            f"{red['wrapped_epochs']} of them with device records; least "
            f"epoch {ctx['least']}")
        if red["narrowed"]:
            log("trace: the profiler dropped the device records of an "
                "epoch; busy_s and window_s cover the longest run of "
                "epochs whose records are whole")
        for m in cell.per_layer:
            value = hz.metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            if m["name"] not in e2e:
                raise KeyError(f"no end-to-end metric {m['name']!r} in "
                               f"family {cell.family}")
            value, unit = e2e[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": unit}

    t_ref = time.perf_counter()
    last = hz.SETUP_EPOCHS + attempted
    (r0, r1), (_, rw) = hz.reference_epochs(
        cell, log_, seed, device, [{}, {"epoch": last, "tables": before}])
    t_cmp = time.perf_counter()
    numbers = hz.readings(cell, log_, seed, device, start, first, r0, r1)
    numbers.update(hz.window_numbers(hz.readings(
        cell, log_, seed, device, before, end, before, rw)))
    log(f"reference epoch {t_cmp - t_ref:.3f} s, comparison "
        f"{time.perf_counter() - t_cmp:.3f} s; readings: "
        f"{json.dumps(numbers)}")
    chk = hz.checks(cell, numbers)
    ok = failed == 0 and done > 0 and all(
        hz.finite(c["value"]) and c["value"] <= c["limit"]
        for c in chk.values())
    result = {"correct": ok, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = chk
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from cfbench import harness as hz
    cell = hz.Cell(hz.load_spec(), args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        log(f"cfbench: the cell needs {cell.chips} CUDA device(s); "
            f"available: {torch.cuda.is_available()}, count "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", _T_START)
    found = hz.forbidden_modules()
    if found:
        log(f"cfbench: forbidden modules loaded: {', '.join(found)}")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
