"""Cross-validation evaluation of the port.

Port of ``mymedialite_tpu/eval/crossval.py`` (reference
``Eval/RatingsCrossValidation.cs:36-171``,
``Eval/ItemsCrossValidation.cs:39-127`` and
``RatingBasedRankingCrossValidation.cs``): a k-fold split, per fold a
clone of the recommender trained and evaluated, the fold results
averaged; the iterative forms train every fold to ``num_iter`` and then
iterate all folds in lockstep, printing the fold-averaged line each
``find_iter`` iterations.

The JAX package runs the folds on host threads (the reference's
``Parallel.ForEach``). The port does so for models on the CPU; on a
CUDA device the folds run one after another, so that they do not share
one stream and the kernel wrappers' launch counters. ``MML_SEQUENTIAL_CV``
runs them in order everywhere, as in the JAX package.
"""

from __future__ import annotations

import os
import sys

import torch

from mymedialite_tpu_torch.data.arrays import PosOnlyData
from mymedialite_tpu_torch.data.splits import crossvalidation_split
from mymedialite_tpu_torch.eval.ranking import evaluate_items
from mymedialite_tpu_torch.eval.rating import compute_fit as _fit
from mymedialite_tpu_torch.eval.rating import evaluate_ratings
from mymedialite_tpu_torch.eval.results import (
    ItemRecommendationResults, RatingPredictionResults,
)


def clone_recommender(recommender):
    """A fresh instance with the same hyperparameters, ``device``
    included (reference Clone() in RatingsCrossValidation.cs:41-68), and
    the same ``mesh``: not a hyperparameter, but the clone trains where
    the recommender does, as the JAX package's folds train on its
    mesh."""
    fresh = type(recommender)()
    names = list(getattr(recommender, "HYPERPARAMS", {}))
    names += list(getattr(recommender, "EXTRA_PARAMS", {}))
    names += ["random_seed", "mesh"]
    for name in names:
        if hasattr(recommender, name):
            setattr(fresh, name, getattr(recommender, name))
    return fresh


def set_additional_feedback(model, test):
    """Transductive predictors (the SVD++ family) receive the test users'
    rated items as implicit feedback (reference RatingsCrossValidation.cs:
    66-67, RatingPrediction.cs:424-425)."""
    if hasattr(model, "additional_feedback"):
        model.additional_feedback = (test.users, test.items)


def folds_in_parallel(recommender) -> bool:
    """Whether the folds may run on host threads: only for a model on the
    CPU (one without a ``device`` keeps its tables on the host)."""
    device = getattr(recommender, "device", "cpu")
    return torch.device(device).type == "cpu"


def run_folds(jobs, parallel: bool = True):
    """Run the per-fold closures, on threads when ``parallel`` (and
    ``MML_SEQUENTIAL_CV`` is unset); results in fold order."""
    if os.environ.get("MML_SEQUENTIAL_CV"):
        parallel = False
    if not parallel or len(jobs) <= 1:
        return [job() for job in jobs]
    from concurrent.futures import ThreadPoolExecutor
    workers = min(len(jobs), os.cpu_count() or 4)
    with ThreadPoolExecutor(max_workers=workers) as ex:
        return [f.result() for f in [ex.submit(job) for job in jobs]]


def _show(fold_results, show: bool):
    if show:
        for f, res in enumerate(fold_results):
            print(f"fold {f} {res}")


def crossvalidate_ratings(recommender, ratings, num_folds: int = 5,
                          compute_fit: bool = False, shuffle: bool = False,
                          rng=None, show_results: bool = False,
                          parallel: bool = True):
    folds = crossvalidation_split(ratings, num_folds, shuffle, rng)

    def fold_job(train, test):
        def job():
            model = clone_recommender(recommender)
            model.ratings = train
            set_additional_feedback(model, test)
            model.train()
            res = evaluate_ratings(model, test)
            if compute_fit:
                res["fit"] = _fit(model)
            return res
        return job

    fold_results = run_folds(
        [fold_job(train, test) for train, test in folds],
        parallel and folds_in_parallel(recommender))
    _show(fold_results, show_results)
    return RatingPredictionResults.average(fold_results)


def crossvalidate_items(recommender, feedback, num_folds: int = 5,
                        test_users=None, candidate_items=None,
                        candidate_item_mode: str = "OVERLAP",
                        shuffle: bool = False, rng=None,
                        show_results: bool = False, parallel: bool = True):
    folds = crossvalidation_split(feedback, num_folds, shuffle, rng)

    def fold_job(train, test):
        def job():
            model = clone_recommender(recommender)
            model.feedback = train
            model.train()
            return evaluate_items(model, test, train, test_users=test_users,
                                  candidate_items=candidate_items,
                                  candidate_item_mode=candidate_item_mode)
        return job

    fold_results = run_folds(
        [fold_job(train, test) for train, test in folds],
        parallel and folds_in_parallel(recommender))
    _show(fold_results, show_results)
    return ItemRecommendationResults.average(fold_results)


def _posonly(data):
    return PosOnlyData(data.users, data.items, num_users=data.num_users,
                       num_items=data.num_items)


def crossvalidate_rating_based_ranking(recommender, ratings,
                                       num_folds: int = 5,
                                       candidate_items=None,
                                       candidate_item_mode: str = "UNION",
                                       shuffle: bool = False, rng=None,
                                       show_results: bool = False,
                                       parallel: bool = True):
    """k-fold over the rating data; each fold trains the rating predictor
    and evaluates it with the item-recommendation protocol (reference
    Eval/RatingBasedRankingCrossValidation.cs)."""
    folds = crossvalidation_split(ratings, num_folds, shuffle, rng)

    def fold_job(train, test):
        def job():
            model = clone_recommender(recommender)
            model.ratings = train
            model.train()
            return evaluate_items(model, _posonly(test), _posonly(train),
                                  candidate_items=candidate_items,
                                  candidate_item_mode=candidate_item_mode)
        return job

    fold_results = run_folds(
        [fold_job(train, test) for train, test in folds],
        parallel and folds_in_parallel(recommender))
    _show(fold_results, show_results)
    return ItemRecommendationResults.average(fold_results)


def _iterative(recommender, folds, setup, evaluate, average, max_iter: int,
               find_iter: int, show_fold_results: bool):
    """The lockstep loop of both iterative forms: each fold's model set
    up and evaluated, then every iteration up to ``max_iter`` applied to
    all folds, evaluated each ``find_iter`` iterations, the averaged
    line printed each iteration."""
    parallel = folds_in_parallel(recommender)

    def setup_job(train, test):
        def job():
            model = setup(train, test)
            return model, evaluate(model, train, test)
        return job

    outs = run_folds([setup_job(train, test) for train, test in folds],
                     parallel)
    models = [m for m, _ in outs]
    fold_results = [r for _, r in outs]
    if show_fold_results:
        for f, res in enumerate(fold_results):
            print(f"fold {f} {res} iteration {models[0].num_iter}",
                  file=sys.stderr)
    print(f"{average(fold_results)} iteration {models[0].num_iter}")

    def iter_job(model, train, test, ev):
        def job():
            model.iterate()
            return evaluate(model, train, test) if ev else None
        return job

    for it in range(models[0].num_iter + 1, max_iter + 1):
        ev = it % find_iter == 0
        outs = run_folds([iter_job(m, train, test, ev) for m, (train, test)
                          in zip(models, folds)], parallel)
        for f, res in enumerate(outs):
            if res is not None:
                fold_results[f] = res
                if show_fold_results:
                    print(f"fold {f} {res} iteration {it}", file=sys.stderr)
        print(f"{average(fold_results)} iteration {it}")
    return average(fold_results)


def iterative_crossvalidate_ratings(recommender, ratings, num_folds: int,
                                    max_iter: int, find_iter: int = 1,
                                    shuffle: bool = False, rng=None,
                                    show_fold_results: bool = False):
    """Iterative CV with a shared iteration counter across folds
    (reference Eval/RatingsCrossValidation.cs:92-171)."""
    def setup(train, test):
        model = clone_recommender(recommender)
        model.ratings = train
        set_additional_feedback(model, test)
        model.train()
        return model

    return _iterative(
        recommender, crossvalidation_split(ratings, num_folds, shuffle, rng),
        setup, lambda model, train, test: evaluate_ratings(model, test),
        RatingPredictionResults.average, max_iter, find_iter,
        show_fold_results)


def iterative_crossvalidate_items(recommender, feedback, num_folds: int,
                                  max_iter: int, find_iter: int = 1,
                                  test_users=None, candidate_items=None,
                                  candidate_item_mode: str = "OVERLAP",
                                  shuffle: bool = False, rng=None,
                                  show_fold_results: bool = False):
    """The item-recommendation mirror (reference
    Eval/ItemsCrossValidation.cs DoIterativeCrossValidation :127+)."""
    def setup(train, test):
        model = clone_recommender(recommender)
        model.feedback = train
        model.train()
        return model

    def evaluate(model, train, test):
        return evaluate_items(model, test, train, test_users=test_users,
                              candidate_items=candidate_items,
                              candidate_item_mode=candidate_item_mode)

    return _iterative(
        recommender, crossvalidation_split(feedback, num_folds, shuffle, rng),
        setup, evaluate, ItemRecommendationResults.average, max_iter,
        find_iter, show_fold_results)
