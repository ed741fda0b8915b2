"""The last line's shape, from runs of small cells on the CPU (the run
without its look for a card), and the run's refusal without a card."""

import json
import os
import subprocess
import sys
import time

import pytest

from cfbench import harness as hz
from cfbench.run import run_cell

SPEC = hz.load_spec()
ROOT = hz.ROOT


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", ["biasedmf-k40.netflix",
                                  "bprmf-k40-pair.netflix"])
def test_result_shape(small_cell, name, trace):
    cell = small_cell(name)
    res = run_cell(cell, 2 ** 31 + 3, 0.3, bool(trace), "cpu",
                   time.perf_counter())
    json.dumps(res)
    keys = list(res)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert res["correct"] is True
    assert res["failed"] == 0 and res["attempted"] >= 1
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    if trace:
        assert set(res["metrics"]) <= {m["name"] for m in cell.per_layer}
        assert "plan_s" in res["metrics"]
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


@pytest.mark.parametrize("name", ["biasedmf-k40.ml25m",
                                  "bprmf-k40-pair.ml25m"])
def test_tiled_cell_is_correct(small_cell, name):
    cell = small_cell(name, users=3000, items=50000, ratings=60000)
    res = run_cell(cell, 12345, 0.2, False, "cpu", time.perf_counter())
    assert res["correct"] is True


def test_no_card_no_result():
    proc = subprocess.run(
        [sys.executable, "-m", "cfbench.run", "--workload",
         "biasedmf-k40.netflix", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
