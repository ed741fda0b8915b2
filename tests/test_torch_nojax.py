"""The port never imports jax: a fresh interpreter in which any import of
jax raises runs the port's CLI end to end on the CPU (train, evaluate,
save, load) and must exit 0."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib.abc
    import sys

    class NoJax(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name == "jax" or name.startswith(("jax.", "jaxlib")):
                raise ImportError("jax imported by the port: " + name)
            return None

    sys.meta_path.insert(0, NoJax())

    import os
    from mymedialite_tpu.data.synthetic import synthetic_ratings, split_ratings
    from mymedialite_tpu_torch.cli import rating_prediction

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
    bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")]
    assert not bad, bad
""")


def test_port_runs_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "RMSE" in proc.stdout
