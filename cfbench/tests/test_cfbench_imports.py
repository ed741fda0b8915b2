"""Nothing that a run loads has the top-level name jax, jaxlib, flax or
mymedialite_tpu (the part before the first dot, compared whole: the
port's name begins with the JAX package's), and the reference loads
nothing of the program."""

import subprocess
import sys

from cfbench import harness as hz

RUN = """
import sys, time
from cfbench import harness as hz
from cfbench.run import run_cell
for name in ("biasedmf-k40.netflix", "bprmf-k40-pair.netflix"):
    cell = hz.Cell(hz.load_spec(), name)
    cell.mix = dict(cell.mix, num_users=2000, num_items=900,
                    num_ratings=30000)
    assert run_cell(cell, 9, 0.1, True, "cpu", time.perf_counter())["correct"]
print(" ".join(sorted({m.split(".", 1)[0] for m in sys.modules})))
"""

REFERENCE = """
import sys, json
import numpy as np
from cfbench.reference import chunks, loop, rating, triple
from cfbench.traffic import synthetic_cf
mix = json.load(open("cfbench/traffic/netflix.json"))
mix = dict(mix, num_users=1500, num_items=700, num_ratings=20000)
d = synthetic_cf.generate(mix, 4, "cpu")
log = {k: d[k].numpy() for k in ("users", "items", "values")}
log.update(num_users=1500, num_items=700)
for fam in (rating, triple):
    cfg = json.load(open("cfbench/configs/%s.json" % (
        "biasedmf-k40" if fam is rating else "bprmf-k40-pair")))
    prep = fam.prepare(log, cfg, 4, "cpu")
    (s, e), = loop.run_many([fam.epoch(log, cfg, 4, "cpu", prep)])
    fam.loss(e, log, "cpu")
print(" ".join(sorted({m.split(".", 1)[0] for m in sys.modules})))
"""


def top_names(script):
    out = subprocess.run([sys.executable, "-c", script], cwd=hz.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(out.stdout.split())


def test_a_run_loads_neither_jax_nor_the_jax_package():
    names = top_names(RUN)
    assert "mymedialite_tpu_torch" in names
    assert not names & set(hz.FORBIDDEN), names & set(hz.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    names = top_names(REFERENCE)
    assert "cfbench" in names
    assert not names & {"mymedialite_tpu_torch", *hz.FORBIDDEN}


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "mymedialite_tpu_torch_x", sys)
    assert "mymedialite_tpu_torch_x" not in hz.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in hz.forbidden_modules()
