"""Every configuration, traffic mix, cell and metric is a file found by
its name; a new one is picked up without an edit to any file."""

import json
import os
import shutil

import pytest

from cfbench import harness as hz

SPEC = hz.load_spec()


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_finds_its_files(cell):
    c = hz.Cell(SPEC, cell)
    assert c.config["name"] == c.entry["config"]
    assert c.mix["generator"] == "synthetic_cf"
    assert set(c.spec_file["limits"]) == {"loss_gap", "change_gap",
                                          "window_loss_gap",
                                          "window_change_gap"}
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.program.RATE[0] in names
    assert c.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in SPEC["per_layer"]])
def test_every_metric_has_a_reader_that_agrees_with_the_spec(metric):
    m = {x["name"]: x for x in SPEC["per_layer"]}[metric]
    reader = hz.metric_reader(metric)
    assert (reader.LAYER, reader.UNIT, reader.MOVES) == \
        (m["layer"], m["unit"], m["moves"])
    assert callable(reader.read)


def test_configs_files_are_their_own():
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    for c in SPEC["configs"]:
        cfg = json.load(open(os.path.join(hz.ROOT, c["file"])))
        assert cfg["name"] == c["name"]
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]


def test_a_new_cell_and_metric_are_found_without_an_edit(tmp_path):
    root = tmp_path / "repo"
    shutil.copytree(os.path.join(hz.ROOT, "cfbench"), root / "cfbench")
    spec = json.loads(json.dumps(SPEC))
    # a new mix, configuration, cell and per-layer metric: new files only
    mix = json.load(open(root / "cfbench/traffic/netflix.json"))
    json.dump(dict(mix, num_users=10), open(root / "cfbench/traffic/tiny.json",
                                            "w"))
    cfg = json.load(open(root / "cfbench/configs/biasedmf-k40.json"))
    json.dump(dict(cfg, name="biasedmf-k80"),
              open(root / "cfbench/configs/biasedmf-k80.json", "w"))
    json.dump({"limits": {"loss_gap": 1.0}},
              open(root / "cfbench/workloads/biasedmf-k80.tiny.json", "w"))
    (root / "cfbench/metrics/epochs.py").write_text(
        'LAYER = "model step"\nUNIT = "1"\nMOVES = "setup_s"\n\n\n'
        'def read(ctx):\n    return ctx["epochs"]\n')
    spec["configs"].append({"name": "biasedmf-k80",
                            "file": "cfbench/configs/biasedmf-k80.json"})
    spec["workloads"].append({"name": "biasedmf-k80.tiny",
                              "config": "biasedmf-k80", "traffic": "tiny",
                              "chips": 1})
    spec["per_layer"].append({"name": "epochs", "unit": "1",
                              "layer": "model step", "moves": "setup_s"})
    cell = hz.Cell(spec, "biasedmf-k80.tiny", root=str(root))
    assert cell.mix["num_users"] == 10
    assert cell.spec_file["limits"] == {"loss_gap": 1.0}
    assert "epochs" in {m["name"] for m in cell.per_layer}
    assert hz.metric_reader("epochs", root=str(root)).read({"epochs": 3}) == 3


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        hz.Cell(SPEC, "no-such-cell")
