"""The port never imports jax or the JAX package: a fresh interpreter in
which any import of jax or of ``mymedialite_tpu`` (the name itself or a
submodule; ``mymedialite_tpu_torch`` shares the prefix and stays
allowed) raises runs the port's three CLIs end to end on the CPU (train,
evaluate, save, load; rating prediction with BiasedMatrixFactorization,
SVDPlusPlus, UserItemBaseline, ItemKNN and UserAttributeKNN, item
recommendation with BPRMF, WeightedBPRMF, MostPopular, WRMF, UserKNN and
ItemAttributeKNN, also with ``--user-prediction``, rating-based ranking
with BiasedMatrixFactorization and SigmoidSVDPlusPlus; the incremental
slice: ``--online-evaluation`` with BiasedMatrixFactorization,
UserItemBaseline, BPRMF and MostPopular, the item baselines Zero,
Random, MostPopularByAttributes and BigramRules, the three fold-in
protocols; then the XLA slice: cross-validation in all three CLIs,
BiasedMatrixFactorization with frequency regularization, BPRMF on its
minibatch epoch, ``--search-hp`` and GSVDPlusPlus; then the last eight
names trained, the KDD Cup reader, and the rating CLI under
``--profile``; BiasedMatrixFactorization and BPRMF trained on a mesh of
four CPU devices; the dry run's mesh paths, WRMF's sharded solves and the
data-parallel ranking eval on four CPU devices, and every route of the
multi-process module ``parallel/driver.py`` in its one-process run) from
the port's own synthetic data, and must exit 0; the quality driver
(``quality.py``) imported there, and a few of its rows run in a second
such interpreter."""

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
    from mymedialite_tpu_torch.cli import (
        item_recommendation, rating_based_ranking, rating_prediction)

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
    assert item_recommendation.main(items + ["--user-prediction"]) == 0
    assert rating_based_ranking.main(base + ["--save-model", f"{d}/r.model"]) == 0
    assert rating_based_ranking.main(base + ["--load-model", f"{d}/r.model"]) == 0
    assert rating_based_ranking.main(
        base + ["--recommender", "SigmoidSVDPlusPlus"]) == 0
    with open(f"{d}/genres.tsv", "w") as f:
        for i in range(150):
            f.write(f"{i}\\t{i % 7}\\n")
    for name in ("UserItemBaseline", "ItemKNN", "UserAttributeKNN"):
        opts = base[:-2] + ["--recommender", name, "--recommender-options",
                            "k=20 device=cpu" if "KNN" in name
                            else "device=cpu"]
        if name == "UserAttributeKNN":
            opts += ["--user-attributes", f"{d}/genres.tsv"]
        assert rating_prediction.main(
            opts + ["--save-model", f"{d}/{name}.rating"]) == 0
        assert rating_prediction.main(
            opts + ["--load-model", f"{d}/{name}.rating"]) == 0
    for name, extra in (("WRMF", "num_factors=6 num_iter=2 "), ("UserKNN", ""),
                        ("ItemAttributeKNN", "")):
        opts = ["--recommender", name, "--recommender-options",
                extra + "device=cpu"]
        if name == "ItemAttributeKNN":
            opts += ["--item-attributes", f"{d}/genres.tsv"]
        assert item_recommendation.main(
            items + opts + ["--save-model", f"{d}/{name}.model"]) == 0
        assert item_recommendation.main(
            items + opts + ["--load-model", f"{d}/{name}.model"]) == 0
    # the incremental slice: online evaluation, item baselines, fold-in
    assert rating_prediction.main(base + ["--online-evaluation"]) == 0
    assert rating_prediction.main(
        base[:4] + ["--recommender", "UserItemBaseline",
                    "--online-evaluation", "--recommender-options",
                    "device=cpu"]) == 0
    assert item_recommendation.main(items + ["--online-evaluation"]) == 0
    assert item_recommendation.main(
        items + ["--online-evaluation", "--recommender", "BPRMF",
                 "--recommender-options",
                 "num_factors=6 num_iter=2 device=cpu"]) == 0
    for name, extra in (("Zero", []), ("Random", []),
                        ("MostPopularByAttributes",
                         ["--item-attributes", f"{d}/genres.tsv"]),
                        ("BigramRules", ["--recommender-options",
                                         "device=cpu"])):
        assert item_recommendation.main(
            items + ["--recommender", name] + extra) == 0
    from mymedialite_tpu_torch.eval import foldin
    from mymedialite_tpu_torch.models.registry import create_rating_predictor
    update, held = split_ratings(test, test_fraction=0.5, seed=3)
    model = create_rating_predictor(
        "BiasedMatrixFactorization", "num_factors=6 num_iter=2 device=cpu")
    model.ratings = train
    model.train()
    for protocol in (foldin.evaluate_fold_in,
                     foldin.evaluate_fold_in_complete_retraining,
                     foldin.evaluate_fold_in_incremental_training):
        print("fold-in", protocol(model, update, held))
    # the mesh: BiasedMatrixFactorization and BPRMF on four CPU devices
    from mymedialite_tpu_torch.data.synthetic import posonly_from_ratings
    from mymedialite_tpu_torch.models.registry import create_item_recommender
    from mymedialite_tpu_torch.parallel.mesh import make_mesh
    for create, name, attr, data in (
            (create_rating_predictor, "BiasedMatrixFactorization", "ratings",
             train),
            (create_item_recommender, "BPRMF", "feedback",
             posonly_from_ratings(train))):
        model = create(name, "num_factors=6 num_iter=2 device=cpu")
        model.mesh = make_mesh(devices=["cpu"] * 4)
        setattr(model, attr, data)
        model.train()
        assert type(model._plan).__name__ == "MxuShardedPlan"
        print("\\nmesh", name, model._route(),
              model.predict_batch(test.users[:3], test.items[:3]))
    # the XLA routes and the protocols of the port's XLA slice
    from mymedialite_tpu_torch import hyperopt
    from mymedialite_tpu_torch.ops import plan
    hyperopt.NUM_IT = 3
    train_only = base[:2] + base[4:]
    assert rating_prediction.main(
        train_only + ["--cross-validation", "2", "--recommender-options",
                      "num_factors=6 num_iter=2 frequency_regularization=true"
                      " device=cpu"]) == 0
    assert rating_prediction.main(
        base[:4] + ["--recommender", "UserItemBaseline", "--search-hp",
                    "--recommender-options", "device=cpu"]) == 0
    gsvd = base + ["--recommender", "GSVDPlusPlus", "--item-attributes",
                   f"{d}/genres.tsv"]
    assert rating_prediction.main(gsvd + ["--save-model", f"{d}/g.model"]) == 0
    assert rating_prediction.main(gsvd + ["--load-model", f"{d}/g.model"]) == 0
    assert rating_based_ranking.main(
        train_only + ["--cross-validation", "2"]) == 0
    plan.RESIDENT_ITEM_TABLE_BYTES = 1024
    assert item_recommendation.main(
        items[:2] + ["--cross-validation", "2", "--recommender", "BPRMF",
                     "--recommender-options",
                     "num_factors=6 num_iter=2 device=cpu"]) == 0
    # the last eight names, the KDD Cup reader and --profile
    import numpy as np
    from mymedialite_tpu_torch.data import kddcup2011
    from mymedialite_tpu_torch.data.arrays import PosOnlyData
    from mymedialite_tpu_torch.data.synthetic import synthetic_posonly
    from mymedialite_tpu_torch.models.registry import create_item_recommender
    with open(f"{d}/kdd.txt", "w") as f:
        f.write("3|2\\n5\\t80\\n6\\t90\\n")
    assert len(kddcup2011.read_kddcup_ratings(f"{d}/kdd.txt")) == 2
    timed = synthetic_ratings(num_users=120, num_items=150, num_ratings=3000,
                              seed=2, with_times=True, time_drift=1.0)
    with open(f"{d}/pred.tsv", "w") as f:
        for u, i, v in zip(test.users, test.items, test.values):
            f.write(f"{u}\\t{i}\\t{v:g}\\n")
    users = np.arange(120)
    trust = PosOnlyData(users, (users + 1) % 120, num_users=120,
                        num_items=120)
    fb = synthetic_posonly(num_users=120, num_items=150, num_events=2000,
                           seed=3)
    for name, opts, data in (
            ("TimeAwareBaseline", "num_iter=2", timed),
            ("TimeAwareBaselineWithFrequencies", "num_iter=2", timed),
            ("SocialMF", "num_factors=6 num_iter=3", train),
            ("ExternalRatingPredictor", f"prediction_file={d}/pred.tsv",
             train)):
        model = create_rating_predictor(name, opts + " device=cpu")
        model.user_relation = trust
        model.ratings = data
        model.train()
        print("trained", name, model.predict_batch(test.users[:3],
                                                   test.items[:3]))
    for name, opts in (("MultiCoreBPRMF", "num_factors=6 num_iter=2"),
                       ("LeastSquareSLIM", "num_iter=2"),
                       ("BPRSLIM", "num_iter=1"),
                       ("ExternalItemRecommender",
                        f"prediction_file={d}/pred.tsv")):
        model = create_item_recommender(name, opts + " device=cpu")
        model.feedback = fb
        model.train()
        print("trained", name, model.score_catalog(np.arange(2)).shape)
    assert rating_prediction.main(
        base + ["--profile", f"{d}/trace"]) == 0
    assert any(n.endswith(".pt.trace.json") for n in os.listdir(f"{d}/trace"))
    # the plain mesh routes: the dry run's paths, WRMF's sharded solves
    # and the data-parallel eval on four CPU devices, parallel/driver.py
    from mymedialite_tpu_torch import dryrun
    from mymedialite_tpu_torch.eval.ranking import evaluate_items
    from mymedialite_tpu_torch.parallel import driver
    plan.RESIDENT_ITEM_TABLE_BYTES = 64 << 20
    dryrun.dryrun_multichip(4, ["cpu"] * 4)
    # every route of the multi-process driver, its one-process run
    driver.run("single", 0, 0, f"{d}/routes.npz", "cpu", "small")
    model = create_item_recommender("WRMF", "num_factors=6 num_iter=2 "
                                    "device=cpu")
    model.mesh = make_mesh(devices=["cpu"] * 4)
    model.feedback = fb
    model.train()
    print("\\nmesh eval", evaluate_items(model, fb, fb,
                                         repeated_events=True))
    from mymedialite_tpu_torch import quality  # noqa: F401
    bad = [m for m in sys.modules if blocked(m)]
    assert not bad, bad
""")

# the quality driver (python -m mymedialite_tpu_torch.quality) at --small
# on the CPU, a few of its rows, with both names blocked
QUALITY_SCRIPT = SCRIPT[:SCRIPT.index("\nimport os\n") + 1] + \
    textwrap.dedent("""
    from mymedialite_tpu_torch import quality
    quality.RATING_CONFIGS = [("GlobalAverage", ""), (
        "BiasedMatrixFactorization", "num_factors=4 num_iter=2")]
    quality.TIME_AWARE_CONFIGS = [("TimeAwareBaseline", "num_iter=2")]
    quality.ITEM_CONFIGS = [("MostPopular", ""),
                            ("BPRMF", "num_factors=4 num_iter=2")]
    records = quality.main(["--small", "--device", "cpu"])
    assert len(records) == 5, records
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
    assert proc.stdout.count("SVDPlusPlus num_factors=6") == 5
    assert proc.stdout.count("SigmoidSVDPlusPlus num_factors=6") == 1
    assert proc.stdout.count("GSVDPlusPlus num_factors=6") == 2
    assert proc.stdout.count("AUC") == 24
    assert proc.stdout.count("fold-in RMSE") == 3
    assert proc.stdout.count("\ntrained ") == 8
    assert proc.stdout.count("\nmesh ") == 3
    assert proc.stdout.count(" sharded [") == 2
    assert proc.stdout.count("dryrun paths ok: 1 sharded-blocked-SGD, "
                             "2 flat-SPMD-SGD") == 1
    assert proc.stdout.count("\nroute ") == 13   # the driver's routes
    assert proc.stdout.count("driver-ok single 0") == 1
    assert proc.stdout.count("\nmesh eval AUC") == 1
    assert "frequency_regularization=True" in proc.stdout
    assert proc.stdout.count("\nUserItemBaseline reg_u=") == 4
    # UserItemBaseline: trained, loaded, then its --search-hp line
    for name in ("ItemKNNRating", "UserAttributeKNNRating",
                 "WRMF", "UserKNN", "ItemAttributeKNN"):
        assert proc.stdout.count(f"\n{name} ") == 2, name


def test_quality_driver_runs_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", QUALITY_SCRIPT],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("RMSE") == 3
    assert proc.stdout.count("AUC") == 2
