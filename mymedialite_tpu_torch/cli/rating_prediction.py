"""rating_prediction — train and evaluate rating predictors from the
shell, on the port.

The same flags and result lines as ``mymedialite_tpu/cli/
rating_prediction.py`` (reference ``RatingPrediction.cs:34-442``), built
on the port's CLI helpers (``cli/common.py``). Covered:
the standard train/evaluate path, ``--test-ratio``,
``--chronological-split``, ``--save-model`` / ``--load-model``,
``--prediction-file``, ``--compute-fit`` and ``--find-iter``. The flags
whose protocols are not ported yet (``--cross-validation``,
``--online-evaluation``, ``--search-hp``, ``--profile``) abort with
"not yet ported".

    python -m mymedialite_tpu_torch.cli.rating_prediction \\
        --training-file train.tsv --test-file test.tsv \\
        --recommender BiasedMatrixFactorization \\
        --recommender-options "num_factors=40 num_iter=3 device=cuda"
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from mymedialite_tpu_torch.cli import common
from mymedialite_tpu_torch.data.io import (
    read_movielens_1m_rating_data, read_rating_data, read_timed_rating_data,
)
from mymedialite_tpu_torch.data.splits import (
    chronological_split_ratio, chronological_split_time, simple_split,
)
from mymedialite_tpu_torch.data.statistics import ratings_statistics
from mymedialite_tpu_torch.utils.params import configure
from mymedialite_tpu_torch.eval.rating import compute_fit, evaluate_ratings
from mymedialite_tpu_torch.models.base import IterativeModel
from mymedialite_tpu_torch.models.registry import (
    create_rating_predictor, list_rating_predictors,
)

_NOT_PORTED = "is not yet ported to mymedialite_tpu_torch"


def build_parser():
    p = argparse.ArgumentParser(
        prog="rating_prediction",
        description="MyMediaLite-TPU rating prediction (PyTorch port)")
    common.add_common_options(p)
    p.add_argument("--rating-type", choices=["float", "byte"], default="float")
    p.add_argument("--file-format",
                   choices=["default", "ignore_first_line", "movielens_1m",
                            "kddcup_2011"],
                   default="default")
    p.add_argument("--chronological-split", default=None)
    p.add_argument("--search-hp", action="store_true")
    p.add_argument("--prediction-line", default="{0}\t{1}\t{2}",
                   help="format of the prediction line; {0}, {1}, {2} "
                        "refer to user ID, item ID, and predicted rating")
    p.add_argument("--prediction-header", default=None)
    p.add_argument("--test-no-ratings", action="store_true",
                   help="test file contains no rating column; requires "
                        "--prediction-file")
    return p


def load_ratings(args, path, user_mapping, item_mapping):
    if args.file_format == "movielens_1m":
        return read_movielens_1m_rating_data(path, user_mapping, item_mapping)
    ignore_first = args.file_format == "ignore_first_line"
    if args.chronological_split is not None:
        return read_timed_rating_data(path, user_mapping, item_mapping,
                                      ignore_first_line=ignore_first)
    return read_rating_data(path, user_mapping, item_mapping,
                            ignore_first_line=ignore_first)


def write_predictions(recommender, test, path, user_mapping, item_mapping,
                      line_format="{0}\t{1}\t{2}", header=None):
    """One 'user<TAB>item<TAB>prediction' line per test rating (reference
    RatingPrediction/Extensions.WritePredictions)."""
    preds = recommender.predict_batch(test.users, test.items)
    with open(path, "w") as f:
        if header is not None:
            f.write(header + "\n")
        for u, i, p in zip(test.users, test.items, preds):
            f.write(line_format.format(user_mapping.to_original(int(u)),
                                       item_mapping.to_original(int(i)),
                                       f"{p:.6g}") + "\n")


def _reject_unported(args):
    for flag, on in (("--cross-validation", args.cross_validation > 1),
                     ("--online-evaluation", args.online_evaluation),
                     ("--search-hp", args.search_hp),
                     ("--profile", args.profile is not None)):
        if on:
            common.abort(f"{flag} {_NOT_PORTED}.")


def main(argv=None):
    args = build_parser().parse_args(argv)
    common.handle_info_flags(args, "rating_prediction",
                             ("RMSE", "MAE", "NMAE", "CBD"))
    _reject_unported(args)
    timer = common.PhaseTimer()

    name = args.recommender or "BiasedMatrixFactorization"
    try:
        recommender = create_rating_predictor(name)
    except KeyError as e:
        common.abort(f"{e.args[0]}. Choose from:\n  " +
                     "\n  ".join(list_rating_predictors()))
    common.seed_everything(args, recommender)
    for opts in (args.recommender_options or []):
        configure(recommender, opts)
    if args.num_iter is not None and hasattr(recommender, "num_iter"):
        recommender.num_iter = args.num_iter

    def show(results):
        if args.measures:
            results.measures_to_show = tuple(
                m.strip() for m in args.measures.split(",") if m.strip())
        return results

    if not args.training_file and not args.load_model:
        common.abort("Please provide either --training-file=FILE or "
                     "--load-model=FILE.")
    if (args.test_file is None and args.test_ratio == 0
            and args.chronological_split is None
            and args.save_model is None and not args.compute_fit):
        common.abort("Please provide either --test-file=FILE, "
                     "--test-ratio=NUM, --cross-validation=K, "
                     "--chronological-split=NUM|DATETIME, or "
                     "--save-model=FILE.")

    user_mapping, item_mapping = common.make_mappings(args)
    common.wire_side_information(args, recommender, user_mapping, item_mapping)

    training_data = None
    test_data = None
    if args.training_file:
        training_data, loading_time = timer.measure("loading", lambda: load_ratings(
            args, common.data_path(args, args.training_file),
            user_mapping, item_mapping))
        print(f"loading_time {loading_time:.2f}", file=sys.stderr)

    if args.test_file:
        if args.test_no_ratings:
            if not args.prediction_file:
                common.abort("--test-no-ratings requires "
                             "--prediction-file=FILE.")
            from mymedialite_tpu_torch.data.io import read_rating_data_no_ratings
            test_data = read_rating_data_no_ratings(
                common.data_path(args, args.test_file),
                user_mapping, item_mapping,
                ignore_first_line=args.file_format == "ignore_first_line")
        else:
            test_data = load_ratings(
                args, common.data_path(args, args.test_file),
                user_mapping, item_mapping)
        # the test set may name entities unseen in training
        if training_data is not None:
            n_users = max(training_data.num_users, test_data.num_users)
            n_items = max(training_data.num_items, test_data.num_items)
            training_data = training_data.select(
                np.arange(len(training_data)), n_users, n_items)
        # transductive predictors (the SVD++ family) see the test users'
        # rated items as implicit feedback (reference
        # RatingPrediction.cs:424-425)
        if hasattr(recommender, "additional_feedback") and \
                not args.test_no_ratings:
            recommender.additional_feedback = (test_data.users,
                                               test_data.items)
    elif args.test_ratio > 0:
        rng = np.random.default_rng(args.random_seed or 0)
        print(f"test ratio {args.test_ratio}", file=sys.stderr)
        training_data, test_data = simple_split(training_data,
                                                args.test_ratio, rng)
    elif args.chronological_split is not None:
        try:
            ratio = float(args.chronological_split)
            training_data, test_data = chronological_split_ratio(
                training_data, ratio)
        except ValueError:
            from mymedialite_tpu_torch.data.io import _parse_time
            training_data, test_data = chronological_split_time(
                training_data, _parse_time(args.chronological_split))

    if training_data is not None:
        # dataset statistics go to stdout after splitting, before any
        # training output (reference RatingPrediction.cs:200)
        print(ratings_statistics(training_data, test_data, None, None), end="")
        recommender.ratings = training_data
        print("ratings range: "
              f"[{recommender.min_rating}, {recommender.max_rating}]",
              file=sys.stderr)

    if args.load_model:
        recommender.load_model(args.load_model)
        if training_data is not None:
            recommender.ratings = training_data

    if args.find_iter > 0:
        _find_iter(args, recommender, test_data, timer, show,
                   user_mapping, item_mapping)
        return 0

    # standard single train/eval path (reference RatingPrediction.cs:272-330)
    print(str(recommender), end=" ")
    if args.load_model is None and training_data is not None:
        _, train_seconds = timer.measure("training", recommender.train)
        print(f"training_time {common.fmt_seconds(train_seconds)} ", end="")
    if test_data is not None and not args.test_no_ratings:
        results, eval_seconds = timer.measure(
            "evaluation",
            lambda: evaluate_ratings(recommender, test_data, training_data))
        print(f"{show(results)} testing_time {common.fmt_seconds(eval_seconds)}",
              end="")
    if args.compute_fit:
        print(f"\nfit {compute_fit(recommender):.5f}", end="")
    print()
    if args.prediction_file and test_data is not None:
        write_predictions(recommender, test_data, args.prediction_file,
                          user_mapping, item_mapping,
                          args.prediction_line, args.prediction_header)
    if args.save_model:
        recommender.save_model(args.save_model)
    common.save_mappings(args, user_mapping, item_mapping)
    timer.report()
    return 0


def _find_iter(args, recommender, test_data, timer, show, user_mapping,
               item_mapping):
    """The --find-iter convergence-tracking loop (reference
    RatingPrediction.cs:202-270)."""
    if not isinstance(recommender, IterativeModel):
        common.abort("Only iterative recommenders support --find-iter=N.")
    print(str(recommender))
    if args.load_model is None:
        timer.measure("training", recommender.train)
    results = evaluate_ratings(recommender, test_data)
    print(f"{show(results)} iteration {recommender.num_iter}")
    eval_history = [results["RMSE"]]
    for it in range(recommender.num_iter + 1, args.max_iter + 1):
        timer.measure("iteration", recommender.iterate)
        if it % args.find_iter != 0:
            continue
        if args.compute_fit:
            print(f"fit {compute_fit(recommender):.5f} iteration {it}")
        results, _ = timer.measure(
            "evaluation", lambda: evaluate_ratings(recommender, test_data))
        print(f"{show(results)} iteration {it}")
        if args.save_model:
            recommender.save_model(f"{args.save_model}-it-{it}")
        if args.prediction_file:
            write_predictions(recommender, test_data,
                              f"{args.prediction_file}-it-{it}",
                              user_mapping, item_mapping,
                              args.prediction_line, args.prediction_header)
        if args.epsilon > 0 and \
                results["RMSE"] - min(eval_history) > args.epsilon:
            print(f"{results['RMSE']} >> {min(eval_history)}",
                  file=sys.stderr)
            print(f"Reached convergence on training/validation data "
                  f"after {it} iterations.", file=sys.stderr)
            break
        if args.cutoff is not None and results["RMSE"] > args.cutoff:
            print(f"Reached cutoff after {it} iterations.", file=sys.stderr)
            break
        eval_history.append(results["RMSE"])
    timer.report()
    common.save_mappings(args, user_mapping, item_mapping)


if __name__ == "__main__":
    common.run_program(main)
