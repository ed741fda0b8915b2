"""rating_based_ranking — train a rating predictor and evaluate it as a
ranker with the item-recommendation protocol, on the port.

The same flags and result lines as ``mymedialite_tpu/cli/
rating_based_ranking.py`` (reference ``src/Programs/RatingBasedRanking/
RatingBasedRanking.cs:27-117``): rating data in, ranking measures
(AUC, prec@5, ...) out, candidate mode UNION unless a flag picks
another. Covered: train and evaluate, the candidate-item flags,
``--test-users``, ``--find-iter``, ``--save-model`` / ``--load-model``
and ``--cross-validation=K`` (without ``--find-iter``, which the JAX
program refuses too) and ``--profile DIR`` (a ``torch.profiler``
trace of the run). As
in the JAX program, only ``ratings`` is set: the test pairs are not the
SVD++ models' additional feedback here (the rating_prediction CLI does
that).

    python -m mymedialite_tpu_torch.cli.rating_based_ranking \\
        --training-file train.tsv --test-file test.tsv \\
        --recommender BiasedMatrixFactorization \\
        --recommender-options "num_factors=40 num_iter=3 device=cuda"
"""

from __future__ import annotations

import argparse

import numpy as np

from mymedialite_tpu_torch.cli import common
from mymedialite_tpu_torch.cli.rating_prediction import load_ratings
from mymedialite_tpu_torch.data.arrays import PosOnlyData
from mymedialite_tpu_torch.data.statistics import ratings_statistics
from mymedialite_tpu_torch.eval.crossval import (
    crossvalidate_rating_based_ranking,
)
from mymedialite_tpu_torch.eval.ranking import evaluate_items
from mymedialite_tpu_torch.eval.results import ItemRecommendationResults
from mymedialite_tpu_torch.models.base import IterativeModel
from mymedialite_tpu_torch.models.registry import (
    create_rating_predictor, list_rating_predictors,
)
from mymedialite_tpu_torch.utils.params import configure


def build_parser():
    p = argparse.ArgumentParser(
        prog="rating_based_ranking",
        description="MyMediaLite-TPU rating-based item ranking (PyTorch "
                    "port)")
    common.add_common_options(p)
    add = p.add_argument
    add("--test-users", default=None)
    add("--candidate-items", default=None)
    add("--overlap-items", action="store_true")
    add("--all-items", action="store_true")
    add("--in-training-items", action="store_true")
    add("--in-test-items", action="store_true")
    add("--rating-type", choices=["float", "byte"], default="float")
    add("--file-format", choices=["default", "ignore_first_line",
                                  "movielens_1m"], default="default")
    add("--chronological-split", default=None)
    return p


def candidate_mode(args, explicit):
    """Reference RatingBasedRanking.LoadData: default UNION."""
    if explicit is not None:
        return "EXPLICIT"
    if args.in_training_items:
        return "TRAINING"
    if args.in_test_items:
        return "TEST"
    if args.overlap_items:
        return "OVERLAP"
    return "UNION"


def to_posonly(data):
    return PosOnlyData(data.users, data.items, num_users=data.num_users,
                       num_items=data.num_items)


def main(argv=None):
    args = build_parser().parse_args(argv)
    common.handle_info_flags(args, "rating_based_ranking",
                             ItemRecommendationResults.ALL_MEASURES)
    with common.profiling(args):
        return _run(args)


def _run(args):
    timer = common.PhaseTimer()

    name = args.recommender or "BiasedMatrixFactorization"
    try:
        recommender = create_rating_predictor(name)
    except KeyError:
        common.abort(f"Unknown recommender {name!r}. Choose from:\n  " +
                     "\n  ".join(list_rating_predictors()))
    common.seed_everything(args, recommender)
    for opts in (args.recommender_options or []):
        configure(recommender, opts)
    if args.num_iter is not None and hasattr(recommender, "num_iter"):
        recommender.num_iter = args.num_iter

    if not args.training_file and not args.load_model:
        common.abort("Please provide either --training-file=FILE or "
                     "--load-model=FILE.")
    if args.test_file is None and args.cross_validation <= 1:
        common.abort("Please provide either --test-file=FILE or "
                     "--cross-validation=K.")

    user_mapping, item_mapping = common.make_mappings(args)
    common.wire_side_information(args, recommender, user_mapping, item_mapping)
    training_data = load_ratings(args, common.data_path(args,
                                                        args.training_file),
                                 user_mapping, item_mapping)
    test_data = None
    if args.test_file is not None:
        test_data = load_ratings(args, common.data_path(args, args.test_file),
                                 user_mapping, item_mapping)
        n_users = max(training_data.num_users, test_data.num_users)
        n_items = max(training_data.num_items, test_data.num_items)
        training_data = training_data.select(np.arange(len(training_data)),
                                             n_users, n_items)
        test_data = test_data.select(np.arange(len(test_data)), n_users,
                                     n_items)

    explicit = None
    if args.candidate_items:
        with open(common.data_path(args, args.candidate_items)) as f:
            explicit = [item_mapping.to_internal(line.strip())
                        for line in f if line.strip()]
    test_users = None
    if args.test_users:
        with open(common.data_path(args, args.test_users)) as f:
            test_users = [user_mapping.to_internal(line.strip())
                          for line in f if line.strip()]

    recommender.ratings = training_data

    # dataset statistics block (format: Data/Extensions.cs:34-81)
    print(ratings_statistics(training_data, test_data), end="")

    if args.cross_validation > 1:
        if args.find_iter > 0:
            # reference RatingBasedRanking.CheckParameters :64-65
            common.abort("The combination of --cross-validation=K and "
                         "--find-iter is not supported for rating-based "
                         "ranking.")
        print(str(recommender))
        print(str(crossvalidate_rating_based_ranking(
            recommender, training_data, args.cross_validation,
            candidate_items=explicit, candidate_item_mode="UNION",
            rng=np.random.default_rng(args.random_seed or 0),
            show_results=args.show_fold_results)))
        timer.report()
        return 0

    def evaluate():
        return evaluate_items(
            recommender, to_posonly(test_data), to_posonly(training_data),
            test_users=test_users, candidate_items=explicit,
            candidate_item_mode=candidate_mode(args, explicit))

    if args.load_model:
        recommender.load_model(args.load_model)
        recommender.ratings = training_data

    if args.find_iter > 0:
        if not isinstance(recommender, IterativeModel):
            common.abort("Only iterative recommenders support --find-iter=N.")
        print(str(recommender))
        if args.load_model is None:
            timer.measure("training", recommender.train)
        print(f"{evaluate()} iteration {recommender.num_iter}")
        for it in range(recommender.num_iter + 1, args.max_iter + 1):
            timer.measure("iteration", recommender.iterate)
            if it % args.find_iter == 0:
                results, _ = timer.measure("evaluation", evaluate)
                print(f"{results} iteration {it}")
        timer.report()
        return 0

    print(str(recommender), end=" ")
    if args.load_model is None:
        _, train_seconds = timer.measure("training", recommender.train)
        print(f"training_time {common.fmt_seconds(train_seconds)} ", end="")
    results, eval_seconds = timer.measure("evaluation", evaluate)
    print(f"{results} testing_time {common.fmt_seconds(eval_seconds)}")
    if args.save_model:
        recommender.save_model(args.save_model)
    common.save_mappings(args, user_mapping, item_mapping)
    timer.report()
    return 0


if __name__ == "__main__":
    common.run_program(main)
