"""item_recommendation — train and evaluate item recommenders from the
shell, on the port.

The same flags and result lines as ``mymedialite_tpu/cli/
item_recommendation.py`` (reference ``ItemRecommendation.cs:33-497``),
built on the port's CLI and data helpers. Covered: the
standard train/evaluate path, ``--test-ratio``, ``--test-users``,
``--num-test-users``, the candidate-item flags, ``--predict-items-number``,
``--repeated-items``, ``--prediction-file``, ``--user-prediction``
(users recommended for items), ``--save-model`` / ``--load-model``,
``--find-iter``, ``--cross-validation=K`` (with ``--find-iter``: the
folds iterated in lockstep) and ``--online-evaluation`` (the per-user
prequential protocol of ``eval/online.py``, also under
``--find-iter``) and ``--profile DIR`` (a ``torch.profiler`` trace of
the run). A model with a ``user_mapping`` (the external recommender)
gets the program's ID mappings before training.

    python -m mymedialite_tpu_torch.cli.item_recommendation \\
        --training-file train.tsv --test-file test.tsv \\
        --recommender BPRMF \\
        --recommender-options "num_factors=40 num_iter=3 device=cuda"
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from mymedialite_tpu_torch.cli import common
from mymedialite_tpu_torch.data.io import (
    read_item_data, read_item_data_rating_threshold,
)
from mymedialite_tpu_torch.data.splits import posonly_simple_split
from mymedialite_tpu_torch.data.statistics import posonly_statistics
from mymedialite_tpu_torch.eval.crossval import (
    crossvalidate_items, iterative_crossvalidate_items,
)
from mymedialite_tpu_torch.eval.online import evaluate_items_online
from mymedialite_tpu_torch.eval.results import ItemRecommendationResults
from mymedialite_tpu_torch.utils.params import configure
from mymedialite_tpu_torch.eval.ranking import evaluate_items
from mymedialite_tpu_torch.models.base import IterativeModel
from mymedialite_tpu_torch.models.registry import (
    create_item_recommender, list_item_recommenders,
)
from mymedialite_tpu_torch.ops.topk import recommend_batch


def build_parser():
    p = argparse.ArgumentParser(
        prog="item_recommendation",
        description="MyMediaLite-TPU item recommendation from implicit "
                    "feedback (PyTorch port)")
    common.add_common_options(p)
    add = p.add_argument
    add("--candidate-items", default=None,
        help="file with candidate items, one per line")
    add("--test-users", default=None, help="file with test users, one per line")
    add("--predict-items-number", type=int, default=-1)
    add("--num-test-users", type=int, default=-1,
        help="evaluate on only N randomly picked users")
    add("--rating-threshold", type=float, default=None)
    add("--file-format", choices=["default", "ignore_first_line", "rating_data"],
        default="default")
    add("--user-prediction", action="store_true")
    add("--repeated-items", action="store_true")
    add("--overlap-items", action="store_true")
    add("--all-items", action="store_true")
    add("--in-training-items", action="store_true")
    add("--in-test-items", action="store_true")
    return p


def candidate_mode(args):
    """Candidate-item flags -> evaluation mode."""
    if args.candidate_items:
        return "EXPLICIT"
    if args.all_items:
        return "UNION"
    if args.in_training_items:
        return "TRAINING"
    if args.in_test_items:
        return "TEST"
    return "OVERLAP"


def load_feedback(args, path, user_mapping, item_mapping):
    ignore_first = args.file_format == "ignore_first_line"
    if args.rating_threshold is not None or args.file_format == "rating_data":
        return read_item_data_rating_threshold(
            path, args.rating_threshold if args.rating_threshold is not None
            else 0.0, user_mapping, item_mapping,
            ignore_first_line=ignore_first)
    return read_item_data(path, user_mapping, item_mapping,
                          ignore_first_line=ignore_first)


def write_predictions(recommender, training, path, user_mapping, item_mapping,
                      n, test_users=None, candidates=None):
    """One ``user<TAB>[item:score,item:score,...]`` line per user."""
    if test_users is None:
        test_users = np.arange(recommender.num_users_trained)
    test_users = np.asarray(test_users, dtype=np.int32)
    k = n if n > 0 else recommender.num_items_trained
    ids, scores = recommend_batch(recommender, test_users, k,
                                  training=training, candidates=candidates)
    with open(path, "w") as f:
        for r, u in enumerate(test_users):
            inner = ",".join(
                f"{item_mapping.to_original(int(i))}:{s:g}"
                for i, s in zip(ids[r], scores[r]) if i >= 0)
            f.write(f"{user_mapping.to_original(int(u))}\t[{inner}]\n")


def main(argv=None):
    args = build_parser().parse_args(argv)
    common.handle_info_flags(args, "item_recommendation",
                             ItemRecommendationResults.ALL_MEASURES)
    with common.profiling(args):
        return _run(args)


def _run(args):
    timer = common.PhaseTimer()

    name = args.recommender or "MostPopular"
    try:
        recommender = create_item_recommender(name)
    except KeyError:
        common.abort(f"Unknown recommender {name!r}. Choose from:\n  " +
                     "\n  ".join(list_item_recommenders()))
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

    user_mapping, item_mapping = common.make_mappings(args)
    # models that read files of their own take the program's mappings
    # (reference INeedsMappings: the external recommender)
    if hasattr(recommender, "user_mapping"):
        recommender.user_mapping = user_mapping
        recommender.item_mapping = item_mapping
    common.wire_side_information(args, recommender, user_mapping, item_mapping)

    training_data = None
    test_data = None
    if args.training_file:
        training_data, loading_time = timer.measure(
            "loading", lambda: load_feedback(
                args, common.data_path(args, args.training_file),
                user_mapping, item_mapping))
        print(f"loading_time {loading_time:.2f}", file=sys.stderr)
    if args.test_file:
        test_data = load_feedback(
            args, common.data_path(args, args.test_file),
            user_mapping, item_mapping)
        n_users = max(training_data.num_users, test_data.num_users)
        n_items = max(training_data.num_items, test_data.num_items)
        training_data = training_data.select(
            np.arange(len(training_data)), n_users, n_items)
        test_data = test_data.select(np.arange(len(test_data)),
                                     n_users, n_items)
    elif args.test_ratio > 0:
        rng = np.random.default_rng(args.random_seed or 0)
        training_data, test_data = posonly_simple_split(
            training_data, args.test_ratio, rng)

    if args.user_prediction:
        # recommend users for items (reference ItemRecommendation.cs:389-409):
        # swap the test-users/candidate-items files and the mappings, then
        # transpose the feedback matrices
        args.test_users, args.candidate_items = \
            args.candidate_items, args.test_users
        user_mapping, item_mapping = item_mapping, user_mapping
        if training_data is not None:
            training_data = training_data.transpose()
        if test_data is not None:
            test_data = test_data.transpose()

    explicit_candidates = None
    if args.candidate_items:
        with open(common.data_path(args, args.candidate_items)) as f:
            explicit_candidates = [item_mapping.to_internal(line.strip())
                                   for line in f if line.strip()]
    test_users = None
    if args.test_users:
        with open(common.data_path(args, args.test_users)) as f:
            test_users = [user_mapping.to_internal(line.strip())
                          for line in f if line.strip()]

    if args.num_test_users > 0:
        # random user sampling (reference ItemRecommendation.cs:421-432)
        pool = np.asarray(test_users) if test_users is not None else (
            test_data.all_users if test_data is not None
            else training_data.all_users)
        if args.num_test_users < pool.size:
            rng = np.random.default_rng(args.random_seed or 0)
            test_users = np.sort(rng.choice(pool, size=args.num_test_users,
                                            replace=False))

    if training_data is not None:
        # dataset statistics go to stdout after splitting, before any
        # training output (reference ItemRecommendation.cs:193)
        print(posonly_statistics(
            training_data, test_data,
            getattr(recommender, "user_attributes", None),
            getattr(recommender, "item_attributes", None)), end="")

    if args.cross_validation > 1:
        # reference ItemRecommendation.cs:214, ItemsCrossValidation.cs
        print(str(recommender))
        kw = dict(test_users=test_users, candidate_items=explicit_candidates,
                  candidate_item_mode=candidate_mode(args),
                  rng=np.random.default_rng(args.random_seed or 0))
        if args.find_iter > 0:
            if not isinstance(recommender, IterativeModel):
                common.abort("Only iterative recommenders support "
                             "--find-iter=N.")
            iterative_crossvalidate_items(
                recommender, training_data, args.cross_validation,
                args.max_iter, args.find_iter,
                show_fold_results=args.show_fold_results, **kw)
        else:
            print(str(crossvalidate_items(
                recommender, training_data, args.cross_validation,
                show_results=args.show_fold_results, **kw)))
        timer.report()
        return 0

    if training_data is not None:
        recommender.feedback = training_data
    if args.load_model:
        recommender.load_model(args.load_model)
        if training_data is not None:
            recommender.feedback = training_data

    def evaluate():
        if args.online_evaluation:
            return evaluate_items_online(
                recommender, test_data, training_data, test_users=test_users,
                candidate_items=explicit_candidates,
                candidate_item_mode=candidate_mode(args))
        return evaluate_items(
            recommender, test_data, training_data, test_users=test_users,
            candidate_items=explicit_candidates,
            candidate_item_mode=candidate_mode(args),
            repeated_events=args.repeated_items,
            n=args.predict_items_number)

    if args.find_iter > 0:
        if not isinstance(recommender, IterativeModel):
            common.abort("Only iterative recommenders support --find-iter=N.")
        print(str(recommender))
        if args.load_model is None:
            timer.measure("training", recommender.train)
        results = evaluate()
        print(f"{show(results)} iteration {recommender.num_iter}")
        for it in range(recommender.num_iter + 1, args.max_iter + 1):
            timer.measure("iteration", recommender.iterate)
            if it % args.find_iter == 0:
                results, _ = timer.measure("evaluation", evaluate)
                print(f"{show(results)} iteration {it}")
                if args.save_model:
                    recommender.save_model(f"{args.save_model}-it-{it}")
        timer.report()
        common.save_mappings(args, user_mapping, item_mapping)
        return 0

    print(str(recommender), end=" ")
    if args.load_model is None and training_data is not None:
        _, train_seconds = timer.measure("training", recommender.train)
        print(f"training_time {common.fmt_seconds(train_seconds)} ", end="")
    if test_data is not None:
        results, eval_seconds = timer.measure("evaluation", evaluate)
        print(f"{show(results)} testing_time {common.fmt_seconds(eval_seconds)}",
              end="")
    print()
    if args.prediction_file:
        write_predictions(recommender, training_data, args.prediction_file,
                          user_mapping, item_mapping,
                          args.predict_items_number, test_users,
                          explicit_candidates)
    if args.save_model:
        recommender.save_model(args.save_model)
    common.save_mappings(args, user_mapping, item_mapping)
    timer.report()
    return 0


if __name__ == "__main__":
    common.run_program(main)
