"""Shared command-line plumbing for the three programs.

Counterpart of reference ``src/Programs/CommandLineProgram/
CommandLineProgram.cs:31-350``: common flag surface, data loading with
ID mapping, the train/eval orchestration, per-phase timing stats.

The port's own copy of ``mymedialite_tpu/cli/common.py``:
the same behaviour, and no import of the JAX package. The JAX
package's compile cache is left out: it is jax-only. ``--profile DIR``
takes one ``torch.profiler`` trace of the whole run (CPU activity, and
CUDA activity when a card is present) and writes it into DIR when the
run ends (``profiling``), as the JAX package's ``maybe_start_profile``
writes a jax profiler trace at the process's exit.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np

from mymedialite_tpu_torch.data.mapping import IdentityMapping, Mapping


def add_common_options(parser: argparse.ArgumentParser):
    """The shared flags (reference CommandLineProgram.cs:198-234)."""
    add = parser.add_argument
    add("--training-file", default=None)
    add("--test-file", default=None)
    add("--recommender", default=None)
    add("--recommender-options", default=None, action="append")
    add("--data-dir", default="")
    add("--user-attributes", default=None)
    add("--item-attributes", default=None)
    add("--user-relations", default=None)
    add("--item-relations", default=None)
    add("--save-model", default=None)
    add("--load-model", default=None)
    add("--save-user-mapping", default=None)
    add("--save-item-mapping", default=None)
    add("--load-user-mapping", default=None)
    add("--load-item-mapping", default=None)
    add("--prediction-file", default=None)
    add("--measures", default=None)
    # extension beyond the reference's wall-clock Wrap.MeasureTime (a
    # profiler trace of the run)
    add("--profile", default=None, metavar="DIR")
    add("--find-iter", type=int, default=0)
    add("--max-iter", type=int, default=500)
    add("--num-iter", type=int, default=None)
    add("--random-seed", type=int, default=None)
    add("--cross-validation", type=int, default=0)
    add("--epsilon", type=float, default=0.0)
    add("--cutoff", type=float, default=None)
    add("--test-ratio", type=float, default=0.0)
    add("--compute-fit", action="store_true")
    add("--online-evaluation", action="store_true")
    add("--no-id-mapping", action="store_true")
    add("--show-fold-results", action="store_true")
    add("--version", action="store_true",
        help="display version information and exit")
    add("--help-measures", action="store_true",
        help="list the supported evaluation measures and exit")


VERSION = "3.13"


@contextlib.contextmanager
def profiling(args):
    """--profile=DIR: trace the block with ``torch.profiler`` (CPU, plus
    CUDA when a card is present) and write the trace into DIR (a
    TensorBoard trace file) when the block ends, also when it ends by
    an abort. Without the flag the block runs untraced."""
    if not getattr(args, "profile", None):
        yield
        return
    import torch
    from torch.profiler import (
        ProfilerActivity, profile, tensorboard_trace_handler,
    )
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    print(f"profiling to {args.profile}", file=sys.stderr)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(args.profile)):
        yield


def handle_info_flags(args, prog_name: str, measures):
    """--version / --help-measures (reference CommandLineProgram.cs:198-234,
    RatingPrediction.cs:64-66 version banner)."""
    if args.version:
        print(f"MyMediaLite-TPU {prog_name} {VERSION}")
        sys.exit(0)
    if args.help_measures:
        print("The following evaluation measures are supported by "
              f"{prog_name}:")
        print("  " + ", ".join(measures))
        sys.exit(0)


def data_path(args, filename):
    if filename is None:
        return None
    if os.path.isabs(filename) or not args.data_dir:
        return filename
    return os.path.join(args.data_dir, filename)


def make_mappings(args):
    if args.no_id_mapping:
        return IdentityMapping(), IdentityMapping()
    user_mapping = (Mapping.load(args.load_user_mapping)
                    if args.load_user_mapping else Mapping())
    item_mapping = (Mapping.load(args.load_item_mapping)
                    if args.load_item_mapping else Mapping())
    return user_mapping, item_mapping


def save_mappings(args, user_mapping, item_mapping):
    if args.save_user_mapping:
        user_mapping.save(args.save_user_mapping)
    if args.save_item_mapping:
        item_mapping.save(args.save_item_mapping)


def abort(message: str):
    print(message, file=sys.stderr)
    sys.exit(1)


def wire_side_information(args, recommender, user_mapping, item_mapping):
    """Load --user-attributes/--item-attributes/--user-relations/
    --item-relations files into the recommender (reference
    CommandLineProgram.cs:255-267 + per-program CheckParameters, e.g.
    RatingPrediction.cs:333-380: attribute-aware recommenders require
    their file)."""
    from mymedialite_tpu_torch.data.io import read_attribute_data, read_relation_data
    if args.user_attributes:
        if not hasattr(recommender, "user_attributes"):
            abort(f"Recommender {type(recommender).__name__} does not "
                  "support --user-attributes.")
        recommender.user_attributes = read_attribute_data(
            data_path(args, args.user_attributes), user_mapping)
    if args.item_attributes:
        if not hasattr(recommender, "item_attributes"):
            abort(f"Recommender {type(recommender).__name__} does not "
                  "support --item-attributes.")
        recommender.item_attributes = read_attribute_data(
            data_path(args, args.item_attributes), item_mapping)
    if args.user_relations:
        if not hasattr(recommender, "user_relation"):
            abort(f"Recommender {type(recommender).__name__} does not "
                  "support --user-relations.")
        recommender.user_relation = read_relation_data(
            data_path(args, args.user_relations), user_mapping)
    if args.item_relations:
        if not hasattr(recommender, "item_relation"):
            abort(f"Recommender {type(recommender).__name__} does not "
                  "support --item-relations.")
        recommender.item_relation = read_relation_data(
            data_path(args, args.item_relations), item_mapping)
    for attr, flag in (("user_attributes", "--user-attributes"),
                       ("item_attributes", "--item-attributes"),
                       ("user_relation", "--user-relations"),
                       ("item_relation", "--item-relations")):
        if attr in getattr(type(recommender), "REQUIRED_SIDE_INFO", ()) \
                and getattr(recommender, attr, None) is None:
            abort(f"Recommender {type(recommender).__name__} requires "
                  f"{flag}=FILE.")


class PhaseTimer:
    """Timing stats per phase (reference Wrap.MeasureTime +
    CommandLineProgram.cs:328-348 min/max/avg report)."""

    def __init__(self):
        self.stats = {}
        global _LAST_TIMER
        _LAST_TIMER = self

    def measure(self, phase: str, fn):
        t0 = time.time()
        result = fn()
        self.stats.setdefault(phase, []).append(time.time() - t0)
        return result, self.stats[phase][-1]

    def report(self, out=None):
        # the stream of the call, not the one current at import
        out = sys.stderr if out is None else out
        for phase, times in self.stats.items():
            if len(times) > 1:
                print(f"{phase}_time: min={min(times):.3f} max={max(times):.3f} "
                      f"avg={np.mean(times):.3f}", file=out)
        print(f"memory {memory_usage_mb()}", file=out)


def memory_usage_mb() -> int:
    """Process peak RSS in MB (reference Memory.Usage, Memory.cs:26, and
    the 'memory N' line in CommandLineProgram.DisplayStats :348)."""
    import resource
    kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return int(kb // 1024)


_LAST_TIMER = None


def run_program(main):
    """CLI entry wrapper: Ctrl-C prints the phase stats before exiting
    (reference AbortHandler -> DisplayStats, CommandLineProgram.cs:323-326)."""
    try:
        sys.exit(main())
    except KeyboardInterrupt:
        if _LAST_TIMER is not None:
            _LAST_TIMER.report()
        sys.exit(130)


def seed_everything(args, recommender):
    if args.random_seed is not None and hasattr(recommender, "random_seed"):
        recommender.random_seed = args.random_seed


def fmt_seconds(s: float) -> str:
    return f"{s:.2f}"
