"""The port never imports jax or the JAX package: a fresh interpreter in
which any import of jax or of ``mymedialite_tpu`` (the name itself or a
submodule; ``mymedialite_tpu_torch`` shares the prefix and stays
allowed) raises runs the port's two CLIs end to end on the CPU (train,
evaluate, save, load; rating prediction with BiasedMatrixFactorization,
item recommendation with BPRMF, WeightedBPRMF and MostPopular) from the
port's own synthetic data, and must exit 0. The rating CLI runs
BiasedMatrixFactorization and SVDPlusPlus."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib.abc
    import sys

    BLOCKED = ("jax", "jaxlib", "mymedialite_tpu")

    def blocked(name):
        return any(name == b or name.startswith(b + ".") for b in BLOCKED)

    class NoJax(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if blocked(name):
                raise ImportError("imported by the port: " + name)
            return None

    sys.meta_path.insert(0, NoJax())

    import os
    from mymedialite_tpu_torch.data.synthetic import (
        split_ratings, synthetic_ratings)
    from mymedialite_tpu_torch.cli import item_recommendation, rating_prediction

    d = os.getcwd()
    train, test = split_ratings(synthetic_ratings(
        num_users=120, num_items=150, num_ratings=3000, seed=2))
    for name, part in (("train", train), ("test", test)):
        with open(f"{d}/{name}.tsv", "w") as f:
            for u, i, v in zip(part.users, part.items, part.values):
                f.write(f"{u}\\t{i}\\t{v:g}\\n")
    base = ["--training-file", f"{d}/train.tsv", "--test-file",
            f"{d}/test.tsv", "--recommender-options",
            "num_factors=6 num_iter=2 device=cpu"]
    assert rating_prediction.main(
        base + ["--save-model", f"{d}/m.model", "--compute-fit"]) == 0
    assert rating_prediction.main(base + ["--load-model", f"{d}/m.model"]) == 0
    svdpp = base + ["--recommender", "SVDPlusPlus"]
    assert rating_prediction.main(svdpp + ["--save-model", f"{d}/s.model"]) == 0
    assert rating_prediction.main(svdpp + ["--load-model", f"{d}/s.model"]) == 0
    items = ["--training-file", f"{d}/train.tsv", "--test-file",
             f"{d}/test.tsv", "--predict-items-number", "5"]
    for name in ("BPRMF", "WeightedBPRMF"):
        opts = ["--recommender", name, "--recommender-options",
                "num_factors=6 num_iter=2 device=cpu"]
        assert item_recommendation.main(
            items + opts + ["--save-model", f"{d}/{name}.model",
                            "--prediction-file", f"{d}/{name}.txt"]) == 0
        assert item_recommendation.main(
            items + opts + ["--load-model", f"{d}/{name}.model"]) == 0
    assert item_recommendation.main(items) == 0
    bad = [m for m in sys.modules if blocked(m)]
    assert not bad, bad
""")


def test_port_runs_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "RMSE" in proc.stdout
    assert proc.stdout.count("SVDPlusPlus num_factors=6") == 2
    assert proc.stdout.count("AUC") == 5
