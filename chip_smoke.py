"""Chip smoke test of the PyTorch / CUDA port (mymedialite_tpu_torch).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. the card (nvidia-smi name and power limit), torch and CUDA versions;
2. build the CUDA kernels from ``mymedialite_tpu_torch/csrc`` with nvcc;
3. the SGD-epoch kernel against its plain PyTorch version on the card,
   2,000 users x 3,000 items x 100k ratings, k=40, one epoch from the same
   tables and order, for every loss x biased combination, on the resident
   schedule and on the slab-tiled one (one-block slabs, so three slabs);
   the MAE rows under two witnesses instead (the MAE gradient is a sign,
   which the plain version's atomics on the card can flip): every chunk
   stepped alone from the float64 plain trajectory's state, and the
   whole epoch no farther from float64 than 4x the farthest plain run;
   every combination also launched twice from the same inputs, its
   tables equal bit for bit (each row's deltas summed in slot order,
   ``csrc/owner_scatter.cuh``); then on both schedules, and on Zipf(1.3)
   duplicate-heavy ratings (700 x 900 x 20k), the orders that exercise
   the kernel's cluster walk (consecutive chunks on one cell, on one user
   block, across user blocks, one chunk, the epoch): each within the
   tolerance of the plain version (the duplicate-heavy ones under the
   MAE rows' two witnesses) and equal to a second launch, with its us a
   chunk;
4. the BPR-epoch kernel against its plain PyTorch version on the card
   at the same shape (the rated pairs as positive-only feedback), one
   epoch from the same tables, order, negative plan and bits: on the
   resident schedule for every (hinge, WBPR) variant and both membership
   tables, on the tiled schedule (three slabs) for every (hinge, WBPR)
   variant with the sub-bucketed keys; identical sampled negatives,
   tables within the tolerance; two launches from the same inputs give
   equal tables, negatives and segment tables, the latter equal to the
   plain builder's (``ops/segments.py bpr_segments_reference``) on the
   sampled negatives; then the orders that exercise the walk's cluster
   (``bpr_cluster_orders``: the orders of phase 3 on the resident
   schedule, and an epoch of each schedule on a Zipf(1.3)
   duplicate-heavy catalog), each held the same way, with its us a chunk
   and the cluster it ran on;
5. the fused top-k kernel against its plain version on the cases of
   tests/test_pallas_topk.py and at the serving shape (1,024 users x
   62,423 items, f=41, k=64); k=65 refused;
6. Netflix-shaped synthetic ratings (480,000 users x 17,770 items x 20M
   draws), split 80/20, shared by phases 7-11;
7. the rating main path on the resident schedule: BiasedMatrixFactorization
   (k=40, 3 epochs) trained through the registry and evaluated; the SGD
   kernel against the plain version at this shape on the first 4,096
   chunks of an epoch's order, both timed, and a whole epoch's bound;
8. the item-recommendation main path on the resident schedule: BPRMF (k=40,
   3 epochs) on the same pairs as positive-only feedback; the BPR kernel
   against the plain version at this shape on the first 4,096 chunks,
   both timed, the bound of a whole epoch (from one more kernel epoch's
   negatives), and its call split into the sampling kernel and the walk
   (torch.profiler); ranking evaluation of 4,096 seeded test users against
   MostPopular;
9. serving phase 8's BPRMF: the top-10 of all 480,000 users, training
   items excluded, through ``recommend_batch`` (the top-k kernel once per
   block of 1,024 users, 469 calls, no other kernel); each block's
   inputs are kept, and the kernel, the plain version and torch.matmul +
   torch.topk are timed over them back to back; the lists against the
   plain version's; the pass split into the host's ignore rows, the mask
   on the card, the kernel (itself split into its split and merge
   kernels) and the copies back;
10. the SVD++-epoch kernel against its plain PyTorch version on the card
    at phase 3's shape, k=20, one epoch from the same tables: plain,
    sigmoid RMSE, sigmoid MAE and without p (the asymmetric factor models);
    the MAE row under phase 3's two witnesses, its R steps run one at a
    time after their block's S steps; where R and Y read s and c (a
    copy in shared memory or the global scratch) is logged; then the
    schedules that exercise the walk's cluster (``svdpp_cluster_orders``:
    Zipf users on an 8-item catalog at k=20 and k=100, and one user
    filling whole S and R steps), each against the plain version and a
    second launch, with its us a step, the cluster and the variant;
11. the SVD++ rating main path on phase 6's data: SVDPlusPlus (k=20, learn
    rate 0.003, 3 epochs) trained through the registry with the test pairs
    as additional feedback (as the CLI sets them), evaluated against the
    global average; the epoch split into the kernel's time over the
    schedule's S, R and Y steps alone; the SVD++ kernel against the plain
    version on the schedule's first 64 user blocks, both timed;
11a. WRMF (k=40, regularization 100, 3 alternations) on phase 6's pairs as
    positive-only feedback: ms per user side and per item side, assembly
    against solve (``cholesky_ex``), events/s; one user side (480,000
    systems of 40 x 40) from the trained item factors held to the same
    side assembled and solved in float64 apart from ``ops/als.py``, with
    a TF32 control that the check must catch; ranking evaluation (AUC >
    0.6); then its top-10 for every user served as in phase 9 (469 more
    calls of kernel 6);
11b. ItemKNN (17,770 items over 480,000 users) and UserKNN (480,000 users
    over 17,770 items), cosine, k=80, both on the streaming top-k: build
    seconds, the share inside the ``torch._int_mm`` Gram products, peak
    memory; 256 sampled rows against a float64 recomputation on the card
    (values within 1e-6, ids equal outside near-ties of 1e-6); ranking
    evaluation of 4,096 seeded test users;
11c. rating prediction on phase 6's data: UserItemBaseline, then ItemKNN
    (Pearson, k=40, the streaming rating top-k on int8 levels) with
    shrinkage 0 (the default) and 100: build, the 3.74M test pairs
    predicted on the card; 256 sampled rows of the stored neighbours held
    to Pearson recomputed in float64 on the card, 256 test pairs to the
    JAX package's per-pair loop recomputed in float64 on the host; the
    RMSEs reported beside the baseline's;
12. MovieLens-25M-shaped synthetic ratings (162,541 users x 62,423 items x
    25,000,095 draws, the published ml-25m catalog), split 80/20: 61 item
    blocks at k=40, past the resident bound of 40, so both model families
    take the slab-tiled schedule; phases 13-15 share them;
13. the rating main path on the tiled schedule: BiasedMatrixFactorization
    as in phase 7, through the tiled SGD kernel, compared with its plain
    version at this shape on a window of 4,096 chunks of an epoch's order
    that runs through the end of its first slab into the next (256
    chunks past the boundary), and the bound of a whole epoch;
14. the item main path on the tiled schedule: BPRMF as in phase 8, through
    the tiled BPR kernel with sub-bucketed keys, compared with its plain
    version at this shape on such a window (identical negatives), the
    bound of a whole epoch (from one more kernel epoch's negatives),
    ranked against MostPopular;
15. serving phase 14's BPRMF as in phase 9: 162,541 users, 159 launches;
16. the rating_prediction CLI in process at 6,040 x 3,706 x 1M ratings,
    with BiasedMatrixFactorization and with SVDPlusPlus (``--test-file``,
    so transductive), each model then saved and loaded through the CLI;
17. the item_recommendation CLI at the same size with BPRMF and a top-10
    ``--prediction-file``, then its model saved and loaded through the
    CLI, then ``--user-prediction``; every prediction file is read back
    and held against the plain version's lists;
18. the rating_based_ranking CLI on phase 16's files with
    BiasedMatrixFactorization, save -> load;
19. the rating CLI on phase 16's files with UserItemBaseline and UserKNN
    (Pearson, dense at 6,040 users; its RMSE must beat the baseline's),
    the item CLI with ItemAttributeKNN and a synthetic genre file, each
    with save -> load;
20. the XLA routes, plain PyTorch epochs on which no kernel may launch:
    BiasedMatrixFactorization with frequency regularization on phase 6's
    data (the blocked epoch, after phase 11); SVDPlusPlus (k=20, learn
    rate 0.003, transductive) on phase 12's data, whose Q and Y pass the
    kernel's 8 MiB (the grouped epoch, 1,270 groups of 128 users), one
    epoch also under torch.profiler for the device's busy share; then a
    retail-sized catalog, ``synthetic_ratings(500_000, 2_200_000,
    10_000_000, seed=7)`` (2,149 item blocks in 135 slabs at k=40, past
    the tiled schedule's 128): BiasedMatrixFactorization (blocked) and
    BPRMF (the minibatch epoch; AUC of 1,024 seeded test users, scored in
    blocks of 128). Each trains 3 epochs and is held over a prefix of an
    epoch (8 groups, or 8 batches of sampled triples) to the same
    function on the CPU in float64 within 1e-4 (``prefix_check``): the
    SVD++ and BPR prefixes from the trained tables, the MF prefixes the
    first groups of epoch 1 from the init tables at a batch of 16,384 (at
    the default 131,072 float32 rounding alone parts from float64:
    ``exp_torch_blocked_prefix.py``); RMSE under the global average, AUC
    above 0.5; the Netflix-shaped blocked MF trained a second time from
    the same seed (on the same host layout), its tables and RMSE equal
    bit for bit (the epoch's scatter, ``ops/sgd.py exact_add``, sums in
    int64 fixed point); the blocked and minibatch paths launch
    ``exact_add``'s kernel (``csrc/exact_add.cu``), which is then held
    bit for bit to its plain version (the torch composition) on the
    calls those paths gave it, on 131,072 slots on 64 rows and on
    batches with an inf and a NaN delta, and timed beside the
    composition and ``index_add_``;
21. the protocols through the CLIs at phase 16's size: the rating CLI with
    --cross-validation=5 (BiasedMatrixFactorization: kernel 1 once per
    epoch per fold), --cross-validation=3 --find-iter=1 --max-iter=3,
    --search-hp (UserItemBaseline) and GSVDPlusPlus on a synthetic genre
    file (save -> load); the item CLI with --cross-validation=5 (BPRMF:
    kernel 3 once per epoch per fold); rating_based_ranking with
    --cross-validation=5;
22. the incremental API, the online protocol and fold-in (run after
    phase 11c, on phase 6's data): (a) BiasedMatrixFactorization (k=40,
    3 epochs), then the prequential protocol over 512 seeded test
    events, buffered with chunked predictions, each event refreshing its
    user and item rows with 30 steps: RMSE/MAE, events/s, ms per refresh;
    16 refreshes (the most-rated item's among them) held step by step to
    float64 (1e-4); one iterate() on the grown ratings through kernel 1;
    (b) true fold-in over 256 seeded test users (their test ratings split
    50/50 into update and evaluation) and the incremental protocol over
    4 of them, 16 fold-in rows held step by step to float64; (c) the
    per-user online protocol with phase 8's BPRMF over 64 seeded test
    users, ms a user split into evaluation, feedback.add, sampler rebuild
    and refresh, one user's pairwise step held to float64 (1e-5), one
    iterate() through kernel 3 on the grown feedback; (d) add_feedback on
    phase 11a's WRMF for 64 seeded users: untouched rows bit-equal, the
    re-solved rows within 1e-5 of float64; (e) one add_ratings of 64
    test events on phase 11's SVDPlusPlus, kernel 5 once; (f)
    --online-evaluation at the ML-100K shape (943 x 1,682 x 100,000) over
    4,096 seeded test events in the rating CLI (UserItemBaseline,
    BiasedMatrixFactorization) and the item CLI (BPRMF);
23. the last eight names ((a)-(e) after phase 22, on phase 6's data and
    the models of phases 7 and 8; (f) after phase 21): (a)
    TimeAwareBaseline (15 epochs) and TimeAwareBaselineWithFrequencies
    (20) at the Netflix shape with times and a per-item drift
    (``synthetic_ratings(..., seed=1, with_times=True, time_drift=1.0)``),
    split by time 80/20, batches of 65,536: s per epoch, RMSE with the
    times against UserItemBaseline and the global average, one minibatch
    step held to float64 (1e-5); (b) SocialMF at quality.py's ML-1M row
    (400 steps) and at the Epinions shape (49,290 users x 139,738 items x
    664,824 draws, 50 steps), each with the 10-NN trust graph of the
    planted factors built on the card: ms per step, RMSE against the
    global average, one step held to float64 (1e-5); (c) LeastSquareSLIM
    (15 sweeps) and BPRSLIM (1 epoch of 14.9M triples in batches of
    1,024) on phase 6's pairs as positive-only feedback: the C and mask
    builds, s per sweep or epoch, L_max and the padded history's bytes,
    AUC over 4,096 seeded test users, one BPRSLIM batch held to float64
    (1e-5); (d) MultiCoreBPRMF: one iterate() from phase 8's tables
    through kernel 3, against BPRMF's from the same tables and generator
    (identical negatives, tables within 1e-4), then 1,024 users served
    through kernel 6; (e) phase 7's test predictions as a prediction
    file: ExternalRatingPredictor's RMSE equals phase 7's to the file's
    %.6g rounding (1e-5), ExternalItemRecommender's top-10 of 1,024
    seeded users equals a plain lookup's; (f) the CLIs at phase 16's
    size: TimeAwareBaselineWithFrequencies on quality.py's drift data
    with its times (save -> load), ExternalRatingPredictor and
    ExternalItemRecommender on its prediction file, LeastSquareSLIM in
    the item CLI, and ``--profile DIR`` in each of the three CLIs, in a
    process of their own (``--counted-cli``, the launches counted there),
    the rating CLI's BiasedMatrixFactorization trace, the process's first
    profiler session, holding kernel 1's CUDA events. Only (d) and the profiled BiasedMatrixFactorization launch
    kernels;
24. the mesh (``parallel/mesh.py``): Gemulla's DSGD diagonal over a rig of
    one card named 4 times (``make_mesh(devices=["cuda:0"] * 4)``), whose
    cells run one after another, so that its times say nothing of a mesh
    of cards; it checks the schedule, the offsets and the routes. (a)
    after phase 4, at phase 3's shape on 3 and 4 devices (empty cells in
    both): each of the four sharded epochs against the same kernel run
    cell by cell in (sub-epoch, device) order and against its plain
    version (every variant of phases 3 and 4 on 4 devices, the first on
    3; the MAE rows under phase 3's witnesses; BPR negatives identical);
    BiasedMatrixFactorization and BPRMF trained on the rig through the
    registry on the sharded route (4 devices) and on the sharded-tiled one
    (2 devices, the bounds lowered to one item block), saved and loaded
    with their predictions kept (at this shape: a Netflix-shaped model
    file holds 20M lines); (b) after phase 8, on phase 6's data:
    BiasedMatrixFactorization and BPRMF (3 epochs) on the rig, the
    "sharded" route, kernels 1 and 3 once per non-empty cell per epoch and
    no other kernel, RMSE under the global average and AUC of 4,096 seeded
    users above 0.6 beside phases 7 and 8, the epoch's ms and the largest
    cell over the mean cell (the imbalance a mesh of cards would pace
    itself by); one MultiCoreBPRMF.iterate() on the rig from that BPRMF's
    tables (kernel 3 once per cell); (c) after phase 20, on its big
    catalog: both models (1 epoch) on the "sharded-tiled" route, kernels
    2 and 4 once per cell, where one device takes the minibatch epochs;
    RMSE under the global average and AUC of 1,024 seeded users above 0.5,
    beside phase 20's. In (b) and (c), after training, each model's
    kernel is held to its cells in turn and to its plain version on one
    more epoch from the trained tables, over 4,096 chunks drawn across all
    its cells (partition-relative item blocks, slabs and negative blocks
    past the first, the partitions' CDF rows; BPR negatives identical),
    and the standard tables that prediction, save and the incremental
    API read are held to rows picked straight out of the shards (no pad
    row leaks; at this shape in place of a save -> load);
25. the plain-PyTorch mesh routes on the same rig, no kernel of csrc/ on
    them: (a) after phase 24 (a), at phase 3's shape, each op on the rig
    against the same op on a CPU mesh from the same inputs within 1e-5
    (the sharded grouped SVD++ epoch, 8 sharded BPR steps on fixed
    triples, the sharded blocked MF epoch, the data-parallel ranking
    eval, whose line also equals one device's), WRMF's sharded solves
    against one device's within 1e-6, then the dry run
    (``mymedialite_tpu_torch/dryrun.py``) on the rig; (d) meanwhile two
    processes of the multi-process driver (``parallel/driver.py``, gloo,
    each a mesh of the card named twice, one global mesh of 4) run every
    route of the port's mesh at phase 3's shape beside the driver's
    one-process run on the 4-device rig: the blocked MF epoch, kernels
    1-4's sharded epochs (each rank launching its own cells, the
    partitions passed between the processes), BiasedMF and BPRMF trained
    on the sharded route, SVDPlusPlus sharded, WRMF, the sharded
    minibatch BPR epoch, the data-parallel ranking eval and the flat
    epoch; each route's ranks equal bit for bit, within 1e-5 of the
    one-process run (1e-6 for the blocked epoch and WRMF), and each
    rank's kernel cells within 1e-4 of its plain cells over the same ring
    with identical negatives; each rank's cells launched and ms per
    route logged; (b)
    after phase 11a, on phase 6's data: SVDPlusPlus (k=20, 2 epochs,
    transductive, groups of 128 users: 4 of them one device's default
    group) with ``model.mesh`` on the sharded grouped epoch (ms an
    epoch and a group step, the largest device's ratings over the mean,
    RMSE beside phase 11's), WRMF (2 alternations) with ``model.mesh`` (ms
    a side; the user side re-solved on the mesh against one device's,
    1e-6; 1,024 users served through kernel 6 against the plain version;
    the data-parallel eval of 4,096 users equal to one device's line); (c)
    after phase 24 (c), on the big catalog's pairs: one sharded minibatch
    BPR epoch (``ops/bpr.py bpr_epoch_sharded``) from seeded tables, its
    first 8 steps held to the CPU's on the same per-device triples, its
    ms beside phase 20's one-device epoch, AUC of 1,024 users;
26. the default mesh (``parallel/mesh.py default_mesh``: a model left at
    ``mesh = DEFAULT_MESH`` trains, and the ranking eval runs, on every
    visible card), after phase 25 (a), at phase 3's shape: (a) the
    resolver as it stands: on one card it gives None, and BiasedMF,
    BPRMF and MultiCoreBPRMF take the resident route (their kernel once
    an epoch), SVDPlusPlus kernel 5, WRMF and BPRMF's ranking eval one
    device, as in phases 3-11 (with several cards it checks that the
    default spans them all); (b) the default pointed at the rig of phase
    24 (``default_devices``): BiasedMF, BPRMF and MultiCoreBPRMF on
    "sharded" (kernels 1 and 3 once per non-empty cell), BiasedMF and
    BPRMF on "sharded-tiled" at 200,000 items, past the per-device
    resident bound (kernels 2 and 4), each beside a model on an explicit
    mesh of the same devices (the same plan chunk for chunk, the tables
    equal bit for bit: the kernels sum each row in a fixed order) and
    its kernel held to its plain version across its cells;
    SVDPlusPlus on its sharded grouped epoch (groups of a quarter of one
    device's automatic group) and WRMF on its sharded solves against the
    explicit mesh's (1e-5 and 1e-6); BPRMF's ranking eval split over the
    rig, its line equal bit for bit to the explicit mesh's and to one
    device's;
27. the quality driver (``mymedialite_tpu_torch/quality.py``) at
    ``--small``, one seed, two runs (``--runs 2``), in this process: its
    22 rows and JSON records, each finite, on its route, the kernel rows
    launching their kernel once an epoch (kernels 1, 3 and 5) and no
    other row any, each row's two runs equal in every metric; each rating
    row's RMSE under GlobalAverage's (the time-aware rows under the timed
    data's global average), each item row's AUC over Random's
    (LeastSquareSLIM's, under it at this size in both packages, logged).
    Phases 8 and 14 time the ranking evaluation's CSR views by
    ``build_csr``'s counting sort and by the lexsort it replaced, held
    equal; a closing line sets what that saved beside phase 27 and the
    repeated blocked training.

Phases 1-25 run with the default mesh pointed at the one card
(``default_devices`` in ``main``), and the child process of phase 23 (f)
sees that card alone, so that on a host of several cards they mean what
they mean on one.

Before each main path (phase 24's models included) every kernel's launch
count is set to 0, and after
it the path's kernels must have run as often as it needs (an epoch
kernel once per epoch, the top-k kernel once per block of users, and no
epoch or top-k kernel in WRMF's training, the KNN builds or the XLA
routes, which are library products, solves and plain PyTorch epochs
(whose scatters launch ``exact_add``'s kernel, held where a path names
it: the blocked and minibatch epochs of phase 20); a count is one
wrapper call, which may launch more than one CUDA kernel: the BPR
epoch's sampler and walk, kernel 6's split and merge, exact_add's four
passes) and every other kernel never. The line before the last is one
JSON object describing the kernels (kernel 6's numbers sum the
Netflix-shaped BPRMF and WRMF serving passes; exact_add's are its
largest call on the Netflix-shaped blocked MF path, its launches that
path's); the last line is ``{"ok": true, "device":
{...}}``. Imports nothing of jax and nothing of the JAX package: only the
port, numpy and torch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# the kernels sum each row in slot order, the plain versions on the card by
# index_add_'s atomics, in a run-dependent order
KERNEL_TOL = 1e-4
# the main paths hold an epoch kernel to its plain version over this many
# chunks of an epoch's order (the plain version is host-bound: a whole
# Netflix-shaped epoch took 8-26 s of it)
PLAIN_PREFIX = 4096
# the whole-epoch witness of the MAE checks: the kernel lies no farther
# from float64 than this many times the farthest plain run
WITNESS_FACTOR = 4.0
_TIMES = re.compile(r"(training_time|testing_time|loading_time) [0-9.]+ ?")
# published peaks of one H100 SXM (data sheet): HBM bytes/s, float32 FLOP/s
# outside the tensor cores; every kernel here computes in float32
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_functions():
    from mymedialite_tpu_torch.ops.bpr_epoch import bpr_epoch, bpr_epoch_tiled
    from mymedialite_tpu_torch.ops.catalog_topk import catalog_topk
    from mymedialite_tpu_torch.ops.sgd import exact_add
    from mymedialite_tpu_torch.ops.sgd_epoch import sgd_epoch, sgd_epoch_tiled
    from mymedialite_tpu_torch.ops.svdpp_epoch import svdpp_epoch
    return dict(sgd_epoch=sgd_epoch, sgd_epoch_tiled=sgd_epoch_tiled,
                bpr_epoch=bpr_epoch, bpr_epoch_tiled=bpr_epoch_tiled,
                svdpp_epoch=svdpp_epoch, catalog_topk=catalog_topk,
                exact_add=exact_add)


# a count in counted_path's ``expected``: at least one launch (on the
# card; on the CPU, where the wrappers run their plain versions, none)
SOME = "at least 1"


@contextlib.contextmanager
def counted_path(expected: dict):
    """Set every kernel's launch count to 0, drive the path inside the
    block, then require the ``expected`` launches ({kernel: count, or
    SOME for at least one}) and none of any other epoch or top-k kernel;
    ``exact_add``, the plain routes' scatter (``ops/sgd.py add_rows``),
    is held only where ``expected`` names it. Yields a dict that holds
    every kernel's launches afterwards."""
    fns = kernel_functions()
    for fn in fns.values():
        fn.launches = 0
    out = {}
    yield out
    out.update({name: fn.launches for name, fn in fns.items()})
    want = {name: expected.get(name, 0) for name in fns}
    if "exact_add" not in expected:
        want["exact_add"] = out["exact_add"]
    met = all((out[k] >= 1 or not torch.cuda.is_available()) if w == SOME
              else out[k] == w for k, w in want.items())
    if not met:
        raise AssertionError(f"kernel launches {out}, expected {want}")


def bound_ms(nbytes: float, flops: float):
    """The least time the card could take: bytes over the HBM rate or
    float32 operations over the peak rate, whichever is larger."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def distinct_rows(blocks, locs, mask, block_size: int):
    """The absolute rows blocks[k] * block_size + locs[k, s] at the slots
    where ``mask`` holds, each once (a 1-D tensor)."""
    rows = blocks.long()[:, None] * block_size + locs.long()
    return torch.unique(rows[mask])


def sgd_bound(plan, ub, ib, row, num_factors: int):
    """The least an SGD epoch over the visited chunks ``row`` (absolute
    blocks ``ub``, ``ib``) needs: each user and item row that a real
    rating touches read and written once at num_factors + 2 columns (the
    factors and the two fused bias columns), each real rating's (u, i,
    value, weight) and the order (3 int32 per chunk) read once, and per
    real rating the dot product, the loss gradient and the two row
    updates, about 12 float32 operations per column."""
    d = plan.packed[row.long()]                       # [nc, 4, C]
    real = d[:, 3] != 0
    n_real = int(real.sum())
    cols = num_factors + 2
    rows = (distinct_rows(ub, d[:, 0], real, plan.user_block).numel()
            + distinct_rows(ib, d[:, 1], real, plan.item_block).numel())
    moved = 2 * rows * cols * 4 + n_real * 16 + 3 * row.numel() * 4
    return bound_ms(moved, 12.0 * cols * n_real)


def bpr_bound(plan, ub, ib, row, jb, neg, num_factors: int, *,
              probe_bytes: int, table_bytes: int):
    """The least a uniform-sampling BPR epoch over the visited chunks
    ``row`` (absolute blocks ``ub``, ``ib``, negative blocks ``jb``) needs,
    from the negatives ``neg`` [nc, 2, C] the kernel drew: each user row
    and each positive or sampled negative item row that an update touches
    read and written once at num_factors + 1 columns (the factors and the
    item bias); per real slot its (u, i, weights), one trial of random
    bits and one membership probe of ``probe_bytes`` (the probes at most
    ``table_bytes`` in all); the order (6 int32 per chunk); and per slot
    that found a negative the dot product and three row updates, about 18
    float32 operations per column."""
    d = plan.packed[row.long()]                       # [nc, 4, C]
    real = d[:, 3] != 0
    upd = real & (neg[:, 1] != 0)
    n_real, n_upd = int(real.sum()), int(upd.sum())
    cols = num_factors + 1
    IB = plan.item_block
    items = torch.unique(torch.cat([
        distinct_rows(ib, d[:, 1], upd, IB),
        distinct_rows(jb, neg[:, 0], upd, IB)]))
    rows = distinct_rows(ub, d[:, 0], upd, plan.user_block).numel() \
        + items.numel()
    moved = 2 * rows * cols * 4 + n_real * (16 + 4) \
        + min(n_real * probe_bytes, table_bytes) + 6 * row.numel() * 4
    return bound_ms(moved, 18.0 * cols * n_upd)


def svdpp_bound(plan, ph, ub, ib, row, num_factors: int):
    """The least an SVD++ epoch over the scheduled steps (ph, ub, ib, row)
    needs, at the tables' live columns (f = num_factors): each W row that a
    real rating touches read at f + 2 (p, b_u, inv_sqrt; the constant-1
    column need not be read) and written at f + 1 (p, b_u); each such Q
    row read and written at f + 1 (q, b_i); each Y row that a real edge
    touches read and written at f; each real rating's (u, i, value) and
    each real edge's (u, i) read once (an edge's value is 0 and a real
    slot's weight 1, so neither need be read; an edge chunk is scheduled
    in S and in Y, its slots count once); the schedule (4 int32 per step);
    per real rating the score, the gradient and the W, Q and c updates,
    about 14 float32 operations per live column (f + 1), per S edge 3 and
    per Y edge 5 per factor column."""
    f = num_factors
    moved, flops = 4 * row.numel() * 4, 0.0
    for phase, ops in ((0, 3.0), (1, 14.0), (2, 5.0)):
        sel = ph == phase
        d = plan.packed[row[sel].long()]              # [n, 4, C]
        real = d[:, 3] != 0
        n_real = int(real.sum())
        flops += ops * (f + 1 if phase == 1 else f) * n_real
        if phase == 1:
            w_rows = distinct_rows(ub[sel], d[:, 0], real,
                                   plan.user_block).numel()
            q_rows = distinct_rows(ib[sel], d[:, 1], real,
                                   plan.item_block).numel()
            moved += (w_rows * (2 * f + 3) + q_rows * 2 * (f + 1)) * 4 \
                + n_real * 12
        if phase == 0:
            y_rows = distinct_rows(ib[sel], d[:, 1], real,
                                   plan.item_block).numel()
            moved += y_rows * 2 * f * 4 + n_real * 8
    return bound_ms(moved, flops)


def topk_bound(block_sizes, num_items: int, width: int, k: int):
    """The least the fused top-k needs over calls on blocks of
    ``block_sizes`` users, each against the whole catalog: per call its
    user rows (B x width floats), the item table (num_items x width
    floats) and the byte mask (B x num_items) read once, its B x k ids
    and values written once, and 2 B num_items width float32
    operations."""
    B = np.asarray(block_sizes, dtype=np.float64)
    nbytes = (B * width * 4 + num_items * width * 4 + B * num_items
              + B * k * 8).sum()
    return bound_ms(float(nbytes), float((2.0 * B * num_items * width).sum()))


def tie_free(vals, gap: float = 1e-5):
    """[U, c] numpy: True where a value differs from both neighbours in
    its row by more than ``gap``; a list's last position is judged by the
    value after it, so callers pass one column more than they compare."""
    v = np.asarray(vals, dtype=np.float64)
    d = np.abs(np.diff(v, axis=1)) > gap
    ok = np.ones(v.shape, dtype=bool)
    ok[:, 1:] &= d
    ok[:, :-1] &= d
    return ok


def topk_agreement(ids, vals, ref_ids, ref_vals, *, exact=False,
                   gap: float = 1e-5):
    """(max |value error|, ids that differ where the reference has no
    near-tie within ``gap``) of a top-k result [U, k] against a reference
    of k + 1 columns (k when the catalog has no more); ``exact`` compares
    every id."""
    ids, vals, ref_ids, ref_vals = (np.asarray(a) for a in (
        ids, vals, ref_ids, ref_vals))
    k = min(ids.shape[1], ref_ids.shape[1])
    sure = np.ones((ids.shape[0], k), bool) if exact else \
        tie_free(ref_vals, gap)[:, :k]
    err = float(np.abs(vals[:, :k].astype(np.float64)
                       - ref_vals[:, :k]).max()) if ids.size else 0.0
    return err, int(((ids[:, :k] != ref_ids[:, :k]) & sure).sum())


def slab_window(slabs, length: int = PLAIN_PREFIX,
                extra: int = 256) -> tuple:
    """[start, end) of the window of at most ``length`` chunks of a
    slab-major order (its chunks' item slabs ``slabs``) that ends
    ``extra`` chunks past its first slab boundary: the walk through the
    end of the first slab into the next."""
    change = torch.nonzero(slabs[1:] != slabs[:-1]).flatten()
    if change.numel() < 1:
        raise AssertionError("the order crosses no slab boundary")
    end = min(int(change[0]) + 1 + extra, slabs.numel())
    return max(end - length, 0), end


def time_kernel_and_plain(kernel, plain):
    """Run ``kernel()`` timed with CUDA events, then ``plain()`` on the
    host clock. Returns (kernel's result, plain's result, kernel ms,
    plain ms)."""
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    k_out = kernel()
    end.record()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_out = plain()
    torch.cuda.synchronize()
    return (k_out, p_out, start.elapsed_time(end),
            (time.perf_counter() - t0) * 1e3)


def device_ms(fn, parts):
    """Run ``fn()`` once under torch.profiler and return, for each name
    in ``parts``, the device ms of the CUDA kernels whose names hold it
    (None where the profiler saw no device time for it). Splits one
    wrapper call into the kernels it launches."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for part in parts:
        us = sum(ev.self_device_time_total for ev in prof.key_averages()
                 if part in ev.key)
        out[part] = us / 1e3 if us else None
    return out


def split_line(split):
    return ", ".join(f"{k} {'not seen' if v is None else f'{v:.1f} ms'}"
                     for k, v in split.items())


def table_error(kernel_tables, plain_tables) -> float:
    """Max |kernel - plain| over the tables; raises on non-finite ones."""
    for t in kernel_tables:
        if not torch.isfinite(t).all():
            raise AssertionError("kernel produced non-finite tables")
    return max((k - p).abs().max().item()
               for k, p in zip(kernel_tables, plain_tables))


def repeat_check(run, what):
    """Launch ``run()`` twice (each from fresh copies of its inputs) and
    require every table it returns equal bit for bit: the kernels sum each
    row in a fixed order, so one set of inputs gives one set of tables."""
    first, second = run(), run()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise AssertionError(f"{what}: two launches from the same inputs "
                             "differ")
    return first


def check(err, what):
    if not err <= KERNEL_TOL:
        raise AssertionError(f"{what}: kernel disagrees with the plain "
                             f"version, {err} > {KERNEL_TOL}")


def global_average_rmse(train, test) -> float:
    return float(np.sqrt(np.mean(
        (test.values.astype(np.float64) - train.values.mean()) ** 2)))


@contextlib.contextmanager
def timed_training(prepare, epoch):
    """Time the plan builder (host clock) and each epoch (CUDA events) as
    the model calls them, without changing the entry point: ``prepare``
    and ``epoch`` are (module, name) pairs patched inside the block.
    Yields {"plan_s": [...], "epoch_ms": [...]}."""
    timings = {"plan_s": [], "epoch_ms": []}
    real_prepare, real_epoch = getattr(*prepare), getattr(*epoch)

    def timed_prepare(*a, **kw):
        t = time.perf_counter()
        out = real_prepare(*a, **kw)
        torch.cuda.synchronize()
        timings["plan_s"].append(time.perf_counter() - t)
        return out

    def timed_epoch(*a, **kw):
        s, e = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        s.record()
        out = real_epoch(*a, **kw)
        e.record()
        e.synchronize()
        timings["epoch_ms"].append(s.elapsed_time(e))
        return out

    setattr(*prepare, timed_prepare)
    setattr(*epoch, timed_epoch)
    try:
        yield timings
    finally:
        setattr(*prepare, real_prepare)
        setattr(*epoch, real_epoch)


def kernel_vs_plain(plan, W, H, order, hp, rates, *, loss, biased):
    """One epoch of the kernel and of the plain version from the same
    tables and order, on the plan's schedule. Returns (max |diff|, kernel
    ms, plain ms)."""
    from mymedialite_tpu_torch.ops import plan as mxu
    from mymedialite_tpu_torch.ops import sgd_epoch as se
    kw = dict(user_block=plan.user_block, item_block=plan.item_block,
              loss=loss, biased=biased)
    if isinstance(plan, mxu.MxuTiledPlan):
        kernel, plain = se.sgd_epoch_tiled, se.sgd_epoch_tiled_reference
        kw["slab_blocks"] = plan.slab_blocks
    else:
        kernel, plain = se.sgd_epoch, se.sgd_epoch_reference
    Wk, Hk, Wr, Hr = W.clone(), H.clone(), W.clone(), H.clone()
    _, _, kernel_ms, plain_ms = time_kernel_and_plain(
        lambda: kernel(Wk, Hk, plan.packed, order, hp, rates, **kw),
        lambda: plain(Wr, Hr, plan.packed, order, hp, rates, **kw))
    return table_error((Wk, Hk), (Wr, Hr)), kernel_ms, plain_ms


def sgd_repeats(plan, W, H, order, hp, rates, *, loss, biased):
    """Two launches of the plan's SGD kernel from the same tables and
    order: equal tables (``repeat_check``)."""
    from mymedialite_tpu_torch.ops import plan as mxu
    from mymedialite_tpu_torch.ops import sgd_epoch as se
    kw = dict(user_block=plan.user_block, item_block=plan.item_block,
              loss=loss, biased=biased)
    kernel = se.sgd_epoch
    if isinstance(plan, mxu.MxuTiledPlan):
        kernel = se.sgd_epoch_tiled
        kw["slab_blocks"] = plan.slab_blocks

    def run():
        Wk, Hk = W.clone(), H.clone()
        kernel(Wk, Hk, plan.packed, order, hp, rates, **kw)
        return Wk, Hk
    repeat_check(run, f"sgd {type(plan).__name__} loss={loss}")


def table_distance(a, b) -> float:
    """Max |a - b| over two tuples of tables, in float64 on the host."""
    return max((x.double().cpu() - y.double().cpu()).abs().max().item()
               for x, y in zip(a, b))


def nudged(tables, seed: int = 1):
    """float64 copies of ``tables`` on the host with every nonzero entry
    moved by 1e-7 N(0, 1): a float64 run from them is one more plain
    witness of how far rounding alone carries a trajectory."""
    g = torch.Generator().manual_seed(seed)
    return tuple(t.double().cpu() + 1e-7 * torch.randn(
        t.shape, generator=g, dtype=torch.float64) * (t.cpu() != 0)
        for t in tables)


def whole_epoch_witness(tables, kernel_run, plain_run, plain_runs: int = 2):
    """(kernel's distance from the float64 plain run, the farthest plain
    witness's): ``kernel_run(tables)`` and ``plain_run(tables)`` return
    the tables after the epoch from copies of ``tables`` (plain_run on
    their device and dtype). The witnesses: the plain version on the
    tables' device ``plain_runs`` times, on the CPU, and in float64 from
    tables moved by 1e-7."""
    truth = plain_run(tuple(t.double().cpu() for t in tables))
    plains = [plain_run(tables) for _ in range(plain_runs)]
    plains.append(plain_run(tuple(t.cpu() for t in tables)))
    plains.append(plain_run(nudged(tables)))
    kernel = kernel_run(tables)
    return (table_distance(kernel, truth),
            max(table_distance(p, truth) for p in plains))


def witness_check(step_err, kernel_dist, plain_dist, what):
    """The MAE rows' two witnesses: one step within KERNEL_TOL, the whole
    epoch within WITNESS_FACTOR times the farthest plain run."""
    check(step_err, f"{what}, one step at a time")
    if not (math.isfinite(kernel_dist)
            and kernel_dist <= WITNESS_FACTOR * plain_dist):
        raise AssertionError(
            f"{what}: after the whole epoch the kernel lies {kernel_dist} "
            f"from float64, past {WITNESS_FACTOR} x the farthest plain run "
            f"({plain_dist})")


def sgd_one_step_witness(plan, W, H, order, hp, rates, *, loss, biased,
                         kernel_run=None):
    """The MAE check of the SGD kernel on the plan's schedule. The MAE
    gradient is the sign of the error, so where a rating lies within
    rounding of its prediction the atomics' run-dependent order can flip
    it, and whole trajectories then part by a learning rate's step. So:
    (1) every chunk stepped alone by the kernel from the float64 plain
    trajectory's state before it, against the float64 step (the largest
    difference); (2) the whole epoch, the kernel's distance from float64
    against the farthest plain witness's (``whole_epoch_witness``), the
    epoch run by ``kernel_run(tables)`` where given (a sharded epoch,
    whose order flattened is ``order``). A plan with slabs is stepped on
    the tiled schedule. Returns (one-step error, kernel distance, plain
    distance)."""
    from mymedialite_tpu_torch.ops import sgd_epoch as se
    kw = dict(user_block=plan.user_block, item_block=plan.item_block,
              loss=loss, biased=biased)
    if hasattr(plan, "slab_blocks"):
        kernel, plain = se.sgd_epoch_tiled, se.sgd_epoch_tiled_reference
        kw["slab_blocks"] = plan.slab_blocks
    else:
        kernel, plain = se.sgd_epoch, se.sgd_epoch_reference
    dev = W.device
    packed_c, rates_c = plan.packed.cpu(), rates.cpu()

    def plain_on(tabs, sched):
        d = tabs[0].device
        out = tuple(t.clone() for t in tabs)
        plain(*out, plan.packed.to(d), tuple(t.to(d) for t in sched), hp,
              rates.to(d, tabs[0].dtype), **kw)
        return out

    state = (W.double().cpu(), H.double().cpu())
    step_err = 0.0
    for k in range(order[0].numel()):
        one = tuple(t[k:k + 1].contiguous() for t in order)
        nxt = tuple(t.clone() for t in state)
        plain(*nxt, packed_c, tuple(t.cpu() for t in one), hp,
              rates_c.double(), **kw)
        got = tuple(t.float().to(dev) for t in state)
        kernel(*got, plan.packed, one, hp, rates, **kw)
        step_err = max(step_err, table_distance(got, nxt))
        state = nxt

    def one_device_run(tabs):
        out = tuple(t.clone() for t in tabs)
        kernel(*out, plan.packed, order, hp, rates, **kw)
        return out

    return (step_err, *whole_epoch_witness(
        (W, H), kernel_run or one_device_run,
        lambda tabs: plain_on(tabs, order)))


def phase_kernel_check(dev):
    from mymedialite_tpu_torch.data.synthetic import synthetic_ratings
    from mymedialite_tpu_torch.ops import plan as mxu
    from mymedialite_tpu_torch.ops import sgd
    data = synthetic_ratings(num_users=2000, num_items=3000,
                             num_ratings=100_000, seed=3)
    args = (data.users, data.items, data.values, 2000, 3000)
    plans = {
        "resident": mxu.prepare_mxu_data(
            *args, user_block=512, item_block=1024, chunk=640,
            shuffle_seed=4, device=dev),
        "tiled": mxu.prepare_mxu_tiled(
            *args, user_block=512, item_block=1024, chunk=None,
            slab_blocks=1, shuffle_seed=4, device=dev)}
    if plans["tiled"].num_slabs != 3:
        raise AssertionError("the tiled check wants three slabs")
    rng = np.random.default_rng(5)
    tabs = (0.1 * rng.standard_normal((2000, 40)),
            0.1 * rng.standard_normal((3000, 40)),
            0.1 * rng.standard_normal(2000), 0.1 * rng.standard_normal(3000))
    worst = {}
    for schedule, plan in plans.items():
        W, H = mxu.extend_tables_mxu(plan, *tabs)
        order = plan.epoch_order(6)
        for biased in (True, False):
            for loss in (sgd.LOSS_RMSE, sgd.LOSS_MAE, sgd.LOSS_LOGISTIC):
                # the models' default rates (BiasedMatrixFactorization.cs)
                rates = mxu.mxu_column_rates(40, W.shape[1], 0.01, 0.015,
                                             0.015, 1.0, 0.01, biased, True,
                                             True, device=dev)
                hp = (0.6, 1.0, 4.0) if biased else (3.6, 1.0, 4.0)
                what = f"sgd {schedule} loss={loss} biased={biased}"
                if loss == sgd.LOSS_MAE:
                    err, k_dist, p_dist = sgd_one_step_witness(
                        plan, W, H, order, hp, rates, loss=loss,
                        biased=biased)
                    log(f"{what} kernel check: one step at a time "
                        f"max_abs_err {err:.3e} (tol {KERNEL_TOL}); whole "
                        f"epoch vs float64: kernel {k_dist:.3e}, farthest "
                        f"plain {p_dist:.3e} (bound {WITNESS_FACTOR} x) "
                        f"({plan.num_chunks} chunks of {plan.chunk})")
                    witness_check(err, k_dist, p_dist, what)
                else:
                    err, k_ms, p_ms = kernel_vs_plain(
                        plan, W, H, order, hp, rates, loss=loss,
                        biased=biased)
                    log(f"{what} kernel check: max_abs_err {err:.3e} (tol "
                        f"{KERNEL_TOL}) kernel {k_ms:.2f} ms plain "
                        f"{p_ms:.1f} ms ({plan.num_chunks} chunks of "
                        f"{plan.chunk})")
                    check(err, what)
                sgd_repeats(plan, W, H, order, hp, rates, loss=loss,
                            biased=biased)
                worst[schedule] = max(worst.get(schedule, 0.0), err)
    log("sgd kernel checks: every (schedule, loss, biased) launched twice "
        "from the same inputs gives equal tables bit for bit")
    from mymedialite_tpu_torch.ops import sgd_epoch as se
    # the duplicate-heavy shape of tests/test_torch_cuda.py (a Zipf(1.3)
    # catalog, one item in about a quarter of the slots), its own tables
    zrng = np.random.default_rng(7)
    zipf = (zrng.integers(0, 700, 20_000), zrng.zipf(1.3, 20_000) % 900,
            zrng.integers(1, 11, 20_000) / 2, 700, 900)
    ztabs = (0.1 * zrng.standard_normal((700, 40)),
             0.1 * zrng.standard_normal((900, 40)),
             0.1 * zrng.standard_normal(700), 0.1 * zrng.standard_normal(900))
    plans["resident zipf"] = mxu.prepare_mxu_data(
        *zipf, user_block=512, item_block=1024, chunk=640, shuffle_seed=4,
        device=dev)
    plans["tiled zipf"] = mxu.prepare_mxu_tiled(
        *zipf, user_block=512, item_block=1024, chunk=None, slab_blocks=1,
        shuffle_seed=4, device=dev)
    hp = (0.6, 1.0, 4.0)
    kw = dict(loss=sgd.LOSS_RMSE, biased=True)
    for schedule, plan in plans.items():
        heavy = schedule.endswith("zipf")
        W, H = mxu.extend_tables_mxu(plan, *(ztabs if heavy else tabs))
        rates = mxu.mxu_column_rates(40, W.shape[1], 0.01, 0.015, 0.015, 1.0,
                                     0.01, True, True, True, device=dev)
        for case, order in sgd_order_cases(plan).items():
            what = f"sgd {schedule} order {case}"
            err, k_ms, _ = kernel_vs_plain(plan, W, H, order, hp, rates, **kw)
            if heavy:
                # a run of a hundred duplicates in a chunk: float32 runs
                # that sum in another order part, as in phase 3's MAE rows
                err, k_dist, p_dist = sgd_one_step_witness(
                    plan, W, H, order, hp, rates, **kw)
                witness_check(err, k_dist, p_dist, what)
                how = (f"one step at a time max_abs_err {err:.3e}; whole "
                       f"order vs float64: kernel {k_dist:.3e}, farthest "
                       f"plain {p_dist:.3e}")
            else:
                check(err, what)
                how = f"max_abs_err {err:.3e}"
            sgd_repeats(plan, W, H, order, hp, rates, **kw)
            nc = order[0].numel()
            log(f"{what}: {how} (tol {KERNEL_TOL}), {k_ms * 1e3 / nc:.2f} "
                f"us a chunk over {nc} chunks of {plan.chunk} (a cluster of "
                f"{se.cluster_size(plan.chunk)}); twice: equal")
            worst[schedule.split()[0]] = max(worst[schedule.split()[0]], err)
    return worst


def sgd_order_cases(plan):
    """The orders that exercise the SGD kernel's cluster walk, in the
    wrapper's form ((ub, ib, row), or on a tiled plan of one-block slabs
    (ub, ibr, sl, row)): consecutive chunks on one (user block, item
    block) cell, on one user block, across user blocks (chunks sorted by
    block), one chunk, and an epoch's order."""
    from mymedialite_tpu_torch.ops import plan as mxu
    ub, ib = plan.ub_c, plan.ib_c
    rows = np.arange(ub.size)
    cells = ub.astype(np.int64) * plan.n_iblocks + ib
    sel = {"same cell": rows[cells == np.bincount(cells).argmax()],
           "same user block": rows[ub == ub[0]][
               np.argsort(ib[ub == ub[0]], kind="stable")],
           "across user blocks": np.lexsort((ib, ub)),
           "one chunk": rows[:1],
           "epoch": plan.epoch_order(6)[-1].cpu().numpy()}
    dev = plan.packed.device
    tiled = isinstance(plan, mxu.MxuTiledPlan)
    if tiled and plan.slab_blocks != 1:
        raise AssertionError("the order cases want one-block slabs")
    out = {}
    for case, s in sel.items():
        cols = [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
                for a in (ub[s], ib[s], s)]
        if tiled:                      # one-block slabs: sl = ib, ibr = 0
            cols.insert(1, torch.zeros_like(cols[1]))
        out[case] = tuple(cols)
    return out


def bpr_kernel_vs_plain(plan, state, W, H, order, neg_plan, bits, rates, *,
                        soft_margin, wbpr, bitmask):
    """One resident BPR epoch of the kernel and of the plain version from
    the same tables, order, negative plan and bits. Returns (max |diff|,
    kernel ms, plain ms, the kernel's negatives); raises unless the
    sampled negatives are identical."""
    from mymedialite_tpu_torch.ops.bpr_epoch import (
        bpr_epoch, bpr_epoch_reference, sampler_tables,
    )
    args = (plan.packed, state["keys_tbl"], state["cdf_tbl"], bits, order,
            *neg_plan, rates)
    kw = dict(user_block=plan.user_block, item_block=plan.item_block,
              soft_margin=soft_margin, wbpr=wbpr,
              bitmask_tbl=state["bitmask_tbl"] if bitmask else None,
              return_negatives=True)
    Wk, Hk, Wr, Hr = W.clone(), H.clone(), W.clone(), H.clone()
    (_, _, neg_k), (_, _, neg_r), kernel_ms, plain_ms = time_kernel_and_plain(
        lambda: bpr_epoch(Wk, Hk, *args, **kw),
        lambda: bpr_epoch_reference(Wr, Hr, *args, **kw))
    if not torch.equal(neg_k, neg_r):
        bad = (neg_k != neg_r).sum().item()
        raise AssertionError(f"sampled negatives differ in {bad} entries")
    bpr_repeats(plan, lambda W_, H_: bpr_epoch(W_, H_, *args, **kw),
                lambda: sampler_tables(
                    plan.packed, args[1], args[2], bits, (*order, *neg_plan),
                    user_block=plan.user_block, item_block=plan.item_block,
                    wbpr=wbpr, bitmask_tbl=kw["bitmask_tbl"]),
                W, H, order[1], neg_plan[0], order[2])
    return table_error((Wk, Hk), (Wr, Hr)), kernel_ms, plain_ms, neg_k


def bpr_repeats(plan, epoch, sample, W, H, ib, jb, row):
    """Two launches of a BPR kernel (``epoch(W, H)`` returning its
    negatives) from the same inputs: equal tables and negatives. Then the
    sampling kernel alone on the same inputs (``sample()``,
    ``ops/bpr_epoch.py sampler_tables``): the same negatives, and segment
    tables equal to the plain builder's (``ops/segments.py
    bpr_segments_reference``) on them."""
    from mymedialite_tpu_torch.ops.segments import bpr_segments_reference

    def run():
        Wk, Hk = W.clone(), H.clone()
        _, _, neg = epoch(Wk, Hk)
        return Wk, Hk, neg
    _, _, neg = repeat_check(run, "bpr")
    neg_s, segs = sample()
    want = bpr_segments_reference(plan.packed[row.long()], neg, ib, jb,
                                  item_block=plan.item_block)
    if not torch.equal(neg_s, neg) or not torch.equal(segs, want):
        raise AssertionError("bpr: the sampler's segment tables differ from "
                             "the plain builder's")


def bpr_tiled_kernel_vs_plain(plan, state, tl, W, H, order, bits, rates, *,
                              soft_margin, wbpr):
    """bpr_kernel_vs_plain for the tiled schedule, sub-bucketed keys."""
    from mymedialite_tpu_torch.ops.bpr_epoch import (
        bpr_epoch_tiled, bpr_epoch_tiled_reference, sampler_tables, tiled_cols,
    )
    args = (plan.packed, state["subkeys_tbl"], state["cdf_tbl"], bits, order,
            rates)
    kw = dict(slab_blocks=tl["slab_blocks"], user_block=plan.user_block,
              item_block=plan.item_block, soft_margin=soft_margin, wbpr=wbpr,
              subkeys=True, return_negatives=True)
    Wk, Hk, Wr, Hr = W.clone(), H.clone(), W.clone(), H.clone()
    (_, _, neg_k), (_, _, neg_r), kernel_ms, plain_ms = time_kernel_and_plain(
        lambda: bpr_epoch_tiled(Wk, Hk, *args, **kw),
        lambda: bpr_epoch_tiled_reference(Wr, Hr, *args, **kw))
    if not torch.equal(neg_k, neg_r):
        bad = (neg_k != neg_r).sum().item()
        raise AssertionError(f"sampled negatives differ in {bad} entries")
    bpr_repeats(plan, lambda W_, H_: bpr_epoch_tiled(W_, H_, *args, **kw),
                lambda: sampler_tables(
                    plan.packed, args[1], args[2], bits,
                    tiled_cols(order, tl["slab_blocks"]),
                    user_block=plan.user_block, item_block=plan.item_block,
                    wbpr=wbpr, subkeys=True),
                W, H, order[2] * tl["slab_blocks"] + order[1], order[3],
                order[8])
    return table_error((Wk, Hk), (Wr, Hr)), kernel_ms, plain_ms, neg_k


def epoch_bits(plan, trials, seed):
    gen = torch.Generator(device=plan.packed.device)
    gen.manual_seed(seed)
    return torch.randint(0, 2 ** 31, (plan.num_chunks, trials, plan.chunk),
                         dtype=torch.int32, generator=gen,
                         device=plan.packed.device)


def bpr_epoch_inputs(plan, state, meta, seed, block_mass=None):
    """Order, negative plan and bits of one resident epoch, as BPRMF draws
    them."""
    from mymedialite_tpu_torch.ops import bpr_plan
    order = plan.epoch_order(seed)
    neg_plan = bpr_plan.epoch_negative_plan(
        plan, state["nvalid"], order[0].cpu().numpy(), meta[3], seed + 1,
        block_mass=block_mass)
    return order, neg_plan, epoch_bits(plan, meta[2], seed)


def bpr_tiled_epoch_inputs(plan, state, meta, tl, seed, block_mass=None):
    """Order and bits of one tiled epoch, as BPRMF draws them."""
    from mymedialite_tpu_torch.ops import bpr_plan
    order = bpr_plan.bpr_tiled_epoch_order(
        plan, state["nvalid"], tl["slab_items"],
        slab_blocks=tl["slab_blocks"], num_slabs=tl["num_slabs"],
        num_items=meta[3], seed=seed, block_mass=block_mass)
    return order, epoch_bits(plan, meta[2], seed)


def bpr_tables(dev, plan, U, I, seed):
    from mymedialite_tpu_torch.ops import bpr_plan
    rng = np.random.default_rng(seed)
    return bpr_plan.bpr_tables_to_mxu(
        *(torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
            0.1 * rng.standard_normal((U, 40)),
            0.1 * rng.standard_normal((I, 40)),
            0.1 * rng.standard_normal(I))),
        torch.from_numpy(plan.new_of_old.astype(np.int64)).to(dev),
        u_pad=plan.u_pad, i_pad=plan.i_pad, fe=64)


def phase_bpr_kernel_check(dev):
    from mymedialite_tpu_torch.data.synthetic import (
        posonly_from_ratings, synthetic_ratings,
    )
    from mymedialite_tpu_torch.ops import bpr_plan
    feedback = posonly_from_ratings(synthetic_ratings(
        num_users=2000, num_items=3000, num_ratings=100_000, seed=3))
    U, I = feedback.num_users, feedback.num_items
    # BPRMF's default rates (reference BPRMF.cs)
    rates = bpr_plan.bpr_mxu_column_rates(40, 64, 0.05, 0.0025, 0.0025,
                                          0.00025, 0.0, True, device=dev)
    worst = {}
    plan, state, meta = bpr_plan.prepare_bpr_mxu(
        feedback, uniform_user=True, shuffle_seed=4, bitmask=True,
        device=dev)
    W, H = bpr_tables(dev, plan, U, I, 5)
    for soft_margin, wbpr in ((False, False), (True, False), (False, True)):
        order, neg_plan, bits = bpr_epoch_inputs(
            plan, state, meta, 6 + wbpr,
            block_mass=state["block_mass"] if wbpr else None)
        for bitmask in (False, True):
            err, k_ms, p_ms, _ = bpr_kernel_vs_plain(
                plan, state, W, H, order, neg_plan, bits, rates,
                soft_margin=soft_margin, wbpr=wbpr, bitmask=bitmask)
            log(f"bpr resident kernel check soft_margin={soft_margin} "
                f"wbpr={wbpr} membership={'bitmask' if bitmask else 'keys'}: "
                f"negatives identical, max_abs_err {err:.3e} (tol "
                f"{KERNEL_TOL}) kernel {k_ms:.2f} ms plain {p_ms:.1f} ms "
                f"({plan.num_chunks} chunks)")
            check(err, f"bpr soft_margin={soft_margin} wbpr={wbpr}")
            worst["resident"] = max(worst.get("resident", 0.0), err)

    # the tiled schedule with BPRMF's tiled plan options, one-block slabs
    plan, state, meta = bpr_plan.prepare_bpr_mxu(
        feedback, uniform_user=True, shuffle_seed=4, chunk=None, kcap=128,
        subkeys=True, ksub_cap=256, bitmask=False, chunk_overhead=256,
        device=dev)
    B, S, slab_items = bpr_plan.bpr_tiled_plan(plan, state["nvalid"],
                                               slab_blocks=1)
    if S != 3:
        raise AssertionError("the tiled check wants three slabs")
    tl = dict(slab_blocks=B, num_slabs=S, slab_items=slab_items)
    W, H = bpr_tables(dev, plan, U, I, 5)
    for soft_margin in (False, True):
        for wbpr in (False, True):
            order, bits = bpr_tiled_epoch_inputs(
                plan, state, meta, tl, 8 + wbpr,
                block_mass=state["block_mass"] if wbpr else None)
            err, k_ms, p_ms, _ = bpr_tiled_kernel_vs_plain(
                plan, state, tl, W, H, order, bits, rates,
                soft_margin=soft_margin, wbpr=wbpr)
            log(f"bpr tiled kernel check soft_margin={soft_margin} "
                f"wbpr={wbpr} membership=subkeys (Ksub {state['ksub']}): "
                f"negatives identical, max_abs_err {err:.3e} (tol "
                f"{KERNEL_TOL}) kernel {k_ms:.2f} ms plain {p_ms:.1f} ms "
                f"({plan.num_chunks} chunks of {plan.chunk}, {S} slabs)")
            check(err, f"bpr tiled soft_margin={soft_margin} wbpr={wbpr}")
            worst["tiled"] = max(worst.get("tiled", 0.0), err)
    bpr_cluster_orders(dev, rates, worst)
    return worst


def bpr_cluster_orders(dev, rates, worst):
    """The orders that exercise the BPR walk's cluster (``ops/cluster.py``):
    on phase 3's feedback, consecutive chunks on one cell, on one user
    block, across user blocks, one chunk and an epoch
    (``sgd_order_cases``; each chunk's negative block drawn as BPRMF
    draws it, for its row); on a duplicate-heavy Zipf(1.3) catalog (the
    card tests'), an epoch of each schedule. Each against the plain
    version and a second launch (``bpr_kernel_vs_plain`` /
    ``bpr_tiled_kernel_vs_plain``), with its us a chunk and the cluster
    it ran on."""
    from mymedialite_tpu_torch.data.arrays import PosOnlyData
    from mymedialite_tpu_torch.data.synthetic import (
        posonly_from_ratings, synthetic_ratings,
    )
    from mymedialite_tpu_torch.ops import bpr_plan
    from mymedialite_tpu_torch.ops.bpr_epoch import cluster_size
    zrng = np.random.default_rng(7)
    feeds = {
        "": posonly_from_ratings(synthetic_ratings(
            num_users=2000, num_items=3000, num_ratings=100_000, seed=3)),
        "zipf ": PosOnlyData(zrng.integers(0, 700, 20_000),
                             zrng.zipf(1.3, 20_000) % 900, num_users=700,
                             num_items=900)}
    for label, fb in feeds.items():
        plan, state, meta = bpr_plan.prepare_bpr_mxu(
            fb, uniform_user=True, shuffle_seed=4, bitmask=True, device=dev)
        W, H = bpr_tables(dev, plan, fb.num_users, fb.num_items, 5)
        cases = sgd_order_cases(plan) if not label else \
            {"epoch": plan.epoch_order(6)}
        # every chunk's negative block, by row: a case's chunks take their
        # rows' (bkt holds the chunk's own user block)
        by_row = bpr_plan.epoch_negative_plan(plan, state["nvalid"],
                                              plan.ub_c, meta[3], 7)
        for case, order in cases.items():
            nc = order[0].numel()
            neg_plan = tuple(t[order[2].long()].contiguous() for t in by_row)
            gen = torch.Generator(device=dev).manual_seed(nc)
            bits = torch.randint(0, 2 ** 31, (nc, meta[2], plan.chunk),
                                 dtype=torch.int32, generator=gen,
                                 device=dev)
            err, k_ms, _, _ = bpr_kernel_vs_plain(
                plan, state, W, H, order, neg_plan, bits, rates,
                soft_margin=False, wbpr=False, bitmask=False)
            what = f"bpr resident {label}order {case}"
            check(err, what)
            log(f"{what}: negatives identical, max_abs_err {err:.3e} (tol "
                f"{KERNEL_TOL}), {k_ms * 1e3 / nc:.2f} us a chunk over {nc} "
                f"chunks of {plan.chunk} (a cluster of "
                f"{cluster_size(plan.chunk)}); twice: equal")
            worst["resident"] = max(worst["resident"], err)
    fb = feeds["zipf "]
    plan, state, meta = bpr_plan.prepare_bpr_mxu(
        fb, uniform_user=True, shuffle_seed=4, chunk=None, kcap=128,
        subkeys=True, ksub_cap=256, bitmask=False, chunk_overhead=256,
        device=dev)
    B, S, slab_items = bpr_plan.bpr_tiled_plan(plan, state["nvalid"],
                                               slab_blocks=1)
    tl = dict(slab_blocks=B, num_slabs=S, slab_items=slab_items)
    W, H = bpr_tables(dev, plan, fb.num_users, fb.num_items, 5)
    order, bits = bpr_tiled_epoch_inputs(plan, state, meta, tl, 8)
    err, k_ms, _, _ = bpr_tiled_kernel_vs_plain(
        plan, state, tl, W, H, order, bits, rates, soft_margin=False,
        wbpr=False)
    check(err, "bpr tiled zipf epoch")
    log(f"bpr tiled zipf order epoch: negatives identical, max_abs_err "
        f"{err:.3e} (tol {KERNEL_TOL}), {k_ms * 1e3 / plan.num_chunks:.2f} "
        f"us a chunk over {plan.num_chunks} chunks of {plan.chunk} (a "
        f"cluster of {cluster_size(plan.chunk)}); twice: equal")
    worst["tiled"] = max(worst["tiled"], err)


def draw_device():
    """Where the big data draws search and de-duplicate
    (``synthetic_ratings(device=...)``, the same data): the card, else
    the CPU."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def shaped_ratings(name, **shape):
    """Synthetic ratings of the given shape, split 80/20."""
    from mymedialite_tpu_torch.data.synthetic import (
        split_ratings, synthetic_ratings,
    )
    t0 = time.perf_counter()
    data = synthetic_ratings(**shape, device=draw_device())
    train, test = split_ratings(data, 0.2, seed=2)
    log(f"{name} data: {data.num_users} users x {data.num_items} items, "
        f"{len(data)} pairs, {len(train)} train / {len(test)} test, "
        f"{time.perf_counter() - t0:.1f} s")
    return train, test


def phase_mf_path(dev, train, test, *, tiled: bool):
    """BiasedMatrixFactorization at k=40 for 3 epochs through the
    registry on the schedule the catalog selects; the epoch kernel
    against its plain version at this shape; RMSE against the global
    average. Returns the kernel's numbers for the kernels line."""
    from mymedialite_tpu_torch.eval.rating import evaluate_ratings
    from mymedialite_tpu_torch.models import mf as mf_module
    from mymedialite_tpu_torch.models.registry import create_rating_predictor
    from mymedialite_tpu_torch.ops import plan as mxu

    name = "sgd_epoch_tiled" if tiled else "sgd_epoch"
    model = create_rating_predictor(
        "BiasedMatrixFactorization",
        f"num_factors=40 num_iter=3 device={dev.type}")
    model.ratings = train
    if (mxu.select_schedule(train.num_items, 40) == "tiled") != tiled:
        raise AssertionError(f"{train.num_items} items do not select the "
                             f"{'tiled' if tiled else 'resident'} schedule")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    prepare = "prepare_mxu_tiled" if tiled else "prepare_mxu_data"
    with timed_training((mxu, prepare), (mf_module, name)) as timings, \
            counted_path({name: model.num_iter}) as counted:
        t0 = time.perf_counter()
        model.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    We, He = model._mxu_tables
    if We.device.type != dev.type or He.device.type != dev.type:
        raise AssertionError("kernel-layout tables are not on the card")
    plan = model._plan
    epoch_ms = float(np.mean(timings["epoch_ms"]))
    slabs = f", {plan.num_slabs} slabs of {plan.slab_blocks}" if tiled else ""
    log(f"mf {'tiled' if tiled else 'resident'} train: {train_s:.2f} s; "
        f"plan prep {timings['plan_s'][0]:.2f} s ({plan.num_chunks} chunks "
        f"of {plan.chunk}, {plan.n_ublocks} x {plan.n_iblocks} blocks{slabs}); "
        f"{name} launches {counted[name]}; epochs "
        f"{', '.join(f'{t:.1f}' for t in timings['epoch_ms'])} ms; "
        f"{len(train) / (epoch_ms / 1e3):.4g} real-rating updates/s; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # the kernel against the plain version at the main path's shape, from
    # the trained tables, on PLAIN_PREFIX chunks of one more epoch's order:
    # on the tiled schedule the window across its first slab boundary, on
    # the resident one the prefix
    rates = model._epoch_rates(True, True)
    hp = (model.global_bias, model.min_rating, model._rating_range())
    order = plan.epoch_order(12345)
    if tiled:
        ub, ibr, sl, row = order
        epoch_bound = sgd_bound(plan, ub, sl * plan.slab_blocks + ibr, row,
                                model.num_factors)
        lo, n = slab_window(order[2])
        span = (f"chunks {lo}-{n} of {plan.num_chunks}, across 1 slab "
                "boundary")
    else:
        epoch_bound = sgd_bound(plan, *order, model.num_factors)
        lo, n = 0, min(PLAIN_PREFIX, plan.num_chunks)
        span = f"prefix of {n} of {plan.num_chunks} chunks"
    order = tuple(t[lo:n].contiguous() for t in order)
    if tiled:
        ub, ibr, sl, row = order
        ib = sl * plan.slab_blocks + ibr
    else:
        ub, ib, row = order
    err, kernel_ms, plain_ms = kernel_vs_plain(
        plan, We, He, order, hp, rates, loss=model.loss_id, biased=True)
    b_ms, b_by = sgd_bound(plan, ub, ib, row, model.num_factors)
    log(f"full-shape {name} ({span}): kernel {kernel_ms:.1f} ms, plain "
        f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}), max_abs_err "
        f"{err:.3e} (tol {KERNEL_TOL}); a whole epoch's bound "
        f"{epoch_bound[0]:.4f} ms ({epoch_bound[1]})")
    check(err, f"{name} at full shape")

    t0 = time.perf_counter()
    res = evaluate_ratings(model, test, train)
    eval_s = time.perf_counter() - t0
    baseline = global_average_rmse(train, test)
    log(f"eval: {res} ({eval_s:.2f} s); global-average RMSE {baseline:.5f}")
    if not (math.isfinite(res["RMSE"]) and res["RMSE"] < baseline):
        raise AssertionError("RMSE does not beat the global average")
    run = dict(launches=counted[name], max_abs_err=err, ms=kernel_ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               epoch_ms=epoch_ms)
    # the test pairs' predictions and RMSE: phase 23's external file
    run["test_predictions"] = model.predict_batch(test.users, test.items)
    run["test_rmse"] = res["RMSE"]
    return run


def bpr_epoch_bound(plan, state, tl, W, H, order, bits, neg_plan, rates,
                    num_factors: int):
    """``bpr_bound`` over a whole epoch (resident when ``neg_plan`` is
    given, else tiled): the kernel runs the epoch once more on copies of
    the tables for its negatives (the plain version is held to the kernel
    on a prefix only)."""
    from mymedialite_tpu_torch.ops.bpr_epoch import bpr_epoch, bpr_epoch_tiled
    kw = dict(user_block=plan.user_block, item_block=plan.item_block,
              return_negatives=True)
    if neg_plan is not None:
        table = state.get("bitmask_tbl", state["keys_tbl"])
        _, _, neg = bpr_epoch(
            W.clone(), H.clone(), plan.packed, state["keys_tbl"],
            state["cdf_tbl"], bits, order, *neg_plan, rates,
            bitmask_tbl=state.get("bitmask_tbl"), **kw)
        (ub, ib, row), jb = order, neg_plan[0]
    else:
        table = state["subkeys_tbl"]
        _, _, neg = bpr_epoch_tiled(
            W.clone(), H.clone(), plan.packed, table, state["cdf_tbl"], bits,
            order, rates, slab_blocks=tl["slab_blocks"], subkeys=True, **kw)
        ub, ibr, isl, jb, _, _, _, _, row = order
        ib = isl * tl["slab_blocks"] + ibr
    return bpr_bound(plan, ub, ib, row, jb, neg, num_factors,
                     probe_bytes=table.element_size(),
                     table_bytes=table.numel() * table.element_size())


def bpr_call_split(plan, state, tl, W, H, order, bits, neg_plan, rates):
    """Device ms of the sampling kernel and of the walk in one BPR call
    over ``order`` (resident when ``neg_plan`` is given, else tiled), on
    copies of the tables."""
    from mymedialite_tpu_torch.ops.bpr_epoch import bpr_epoch, bpr_epoch_tiled
    kw = dict(user_block=plan.user_block, item_block=plan.item_block)
    Wc, Hc = W.clone(), H.clone()
    if neg_plan is not None:
        bitmask = state.get("bitmask_tbl")
        run = lambda: bpr_epoch(  # noqa: E731
            Wc, Hc, plan.packed, state["keys_tbl"], state["cdf_tbl"], bits,
            order, *neg_plan, rates, bitmask_tbl=bitmask, **kw)
    else:
        run = lambda: bpr_epoch_tiled(  # noqa: E731
            Wc, Hc, plan.packed, state["subkeys_tbl"], state["cdf_tbl"],
            bits, order, rates, slab_blocks=tl["slab_blocks"], subkeys=True,
            **kw)
    return device_ms(run, ("bpr_sample_kernel", "bpr_walk_kernel"))


def lexsort_csr(primary, secondary, num_keys: int):
    """(indptr, order, keys): the CSR view as ``data/arrays.py
    build_csr`` built it before its counting sort, by ``np.lexsort``."""
    order = np.lexsort((secondary, primary)).astype(np.int32)
    indptr = np.zeros(num_keys + 1, dtype=np.int64)
    indptr[1:] = np.bincount(primary, minlength=num_keys)
    np.cumsum(indptr, out=indptr)
    return indptr, order, secondary[order]


def csr_builds(*datasets):
    """The datasets' per-user CSR views (the ranking evaluation's host
    index), built by ``build_csr``'s counting sort and kept; then the same
    views by the lexsort it replaced, held equal array for array. Returns
    (counting-sort s, lexsort s)."""
    t0 = time.perf_counter()
    views = [d.by_user for d in datasets]
    counting_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    refs = [lexsort_csr(d.users, d.items, d.num_users) for d in datasets]
    lexsort_s = time.perf_counter() - t0
    for view, ref in zip(views, refs):
        for got, want in zip((view.indptr, view.order, view.keys), ref):
            if got.dtype != want.dtype or not np.array_equal(got, want):
                raise AssertionError("the counting-sort CSR differs from "
                                     "the lexsort's")
    log(f"ranking eval set-up (host CSR of train and test, "
        f"{sum(len(d) for d in datasets)} events): counting sort "
        f"{counting_s:.2f} s, the lexsort it replaced {lexsort_s:.2f} s, "
        f"equal arrays")
    return counting_s, lexsort_s


def phase_bpr_path(dev, train, test, *, tiled: bool):
    """BPRMF at k=40 for 3 epochs through the registry on the same pairs
    as positive-only feedback; the epoch kernel against its plain version
    at this shape; ranking evaluation against MostPopular. Returns the
    kernel's numbers for the kernels line, the trained model and its
    feedback."""
    from mymedialite_tpu_torch.data.synthetic import posonly_from_ratings
    from mymedialite_tpu_torch.models import bpr as bpr_module
    from mymedialite_tpu_torch.models.registry import create_item_recommender
    from mymedialite_tpu_torch.ops import bpr_plan

    name = "bpr_epoch_tiled" if tiled else "bpr_epoch"
    train, test = posonly_from_ratings(train), posonly_from_ratings(test)
    model = create_item_recommender(
        "BPRMF", f"num_factors=40 num_iter=3 device={dev.type}")
    model.feedback = train

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with timed_training((bpr_plan, "prepare_bpr_mxu"),
                        (bpr_module, name)) as timings, \
            counted_path({name: model.num_iter}) as counted:
        t0 = time.perf_counter()
        model.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    We, He = model._mxu_tables
    if We.device.type != dev.type or He.device.type != dev.type:
        raise AssertionError("kernel-layout tables are not on the card")
    plan, state, tl = model._plan, model._neg_state, model._tiled
    if (tl is not None) != tiled:
        raise AssertionError("BPRMF took the other schedule")
    epoch_ms = float(np.mean(timings["epoch_ms"]))
    if tiled:
        membership = (f"subkeys (Ksub {state['ksub']}, corrupted-triple "
                      f"rate {state['subkey_corruption']:.2e}), "
                      f"{tl['num_slabs']} slabs of {tl['slab_blocks']}")
    else:
        membership = "bitmask" if "bitmask_tbl" in state else "keys"
    log(f"bpr {'tiled' if tiled else 'resident'} train: {train_s:.2f} s; "
        f"plan prep {timings['plan_s'][0]:.2f} s ({plan.num_chunks} chunks "
        f"of {plan.chunk}, {plan.n_ublocks} x {plan.n_iblocks} blocks, "
        f"membership {membership}); {name} launches {counted[name]}; "
        f"epochs {', '.join(f'{t:.1f}' for t in timings['epoch_ms'])} ms; "
        f"{len(train) / (epoch_ms / 1e3):.4g} training triples/s; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # the kernel against the plain version at the main path's shape, from
    # the trained tables, on PLAIN_PREFIX chunks of one more epoch's order:
    # on the tiled schedule the window across its first slab boundary, on
    # the resident one the prefix
    rates = bpr_plan.bpr_mxu_column_rates(
        40, We.shape[1], model.learn_rate, model.reg_u, model.reg_i,
        model.reg_j, model.bias_reg, model.update_j, device=dev)
    if tiled:
        order, bits = bpr_tiled_epoch_inputs(plan, state, model._neg_meta,
                                             tl, 12345)
        neg_plan = None
        lo, n = slab_window(order[2])
        span = (f"chunks {lo}-{n} of {plan.num_chunks}, across 1 slab "
                "boundary")
    else:
        order, neg_plan, bits = bpr_epoch_inputs(plan, state,
                                                 model._neg_meta, 12345)
        lo, n = 0, min(PLAIN_PREFIX, plan.num_chunks)
        span = f"prefix of {n} of {plan.num_chunks} chunks"
    epoch_bound = bpr_epoch_bound(plan, state, tl, We, He, order, bits,
                                  neg_plan, rates, model.num_factors)
    order = tuple(t[lo:n].contiguous() for t in order)
    bits = bits[lo:n].contiguous()
    if tiled:
        err, kernel_ms, plain_ms, neg = bpr_tiled_kernel_vs_plain(
            plan, state, tl, We, He, order, bits, rates, soft_margin=False,
            wbpr=False)
        ub, ibr, isl, jb, _, _, _, _, row = order
        ib = isl * tl["slab_blocks"] + ibr
        table = state["subkeys_tbl"]
    else:
        neg_plan = tuple(t[lo:n].contiguous() for t in neg_plan)
        bitmask = "bitmask_tbl" in state
        err, kernel_ms, plain_ms, neg = bpr_kernel_vs_plain(
            plan, state, We, He, order, neg_plan, bits, rates,
            soft_margin=False, wbpr=False, bitmask=bitmask)
        (ub, ib, row), jb = order, neg_plan[0]
        table = state["bitmask_tbl" if bitmask else "keys_tbl"]
    call_split = bpr_call_split(plan, state, tl, We, He, order, bits,
                                neg_plan, rates)
    b_ms, b_by = bpr_bound(
        plan, ub, ib, row, jb, neg, model.num_factors,
        probe_bytes=table.element_size(),
        table_bytes=table.numel() * table.element_size())
    log(f"full-shape {name} ({span}): kernel {kernel_ms:.1f} ms, plain "
        f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms ({b_by}), negatives "
        f"identical, max_abs_err {err:.3e} (tol {KERNEL_TOL}); a whole "
        f"epoch's bound {epoch_bound[0]:.4f} ms ({epoch_bound[1]})")
    log(f"{name} call split on the same work (torch.profiler, one more "
        f"run on copies): {split_line(call_split)}")
    check(err, f"{name} at full shape")

    csr = csr_builds(train, test)   # the host CSR both evaluations read
    popular = create_item_recommender("MostPopular")
    popular.feedback = train
    popular.train()
    sampled_ranking_eval(popular, train, test, "MostPopular")
    auc = sampled_ranking_eval(model, train, test, "BPRMF")["AUC"]
    if not auc > 0.6:
        raise AssertionError(f"BPRMF AUC {auc} <= 0.6")
    return dict(launches=counted[name], max_abs_err=err, ms=kernel_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                epoch_ms=epoch_ms, auc=auc, test=test, csr=csr), model, train


def svdpp_kernel_vs_plain(plan, tables, schedule, hp, rates, *,
                          num_factors, loss, sigmoid):
    """One SVD++ epoch (or a prefix of whole user blocks) of the kernel
    and of the plain version from the same tables. Returns (max |diff|,
    kernel ms, plain ms)."""
    from mymedialite_tpu_torch.ops.svdpp_epoch import (
        svdpp_epoch, svdpp_epoch_reference,
    )
    kw = dict(user_block=plan.user_block, item_block=plan.item_block,
              num_factors=num_factors, loss=loss, sigmoid=sigmoid)
    k_tabs = tuple(t.clone() for t in tables)
    r_tabs = tuple(t.clone() for t in tables)
    _, _, kernel_ms, plain_ms = time_kernel_and_plain(
        lambda: svdpp_epoch(*k_tabs, plan.packed, schedule, hp, rates, **kw),
        lambda: svdpp_epoch_reference(*r_tabs, plan.packed, schedule, hp,
                                      rates, **kw))
    return table_error(k_tabs, r_tabs), kernel_ms, plain_ms


def svdpp_repeats(plan, tables, schedule, hp, rates, **kw):
    """Two launches of the SVD++ kernel from the same tables and schedule:
    equal tables (``repeat_check``)."""
    from mymedialite_tpu_torch.ops.svdpp_epoch import svdpp_epoch

    def run():
        tabs = tuple(t.clone() for t in tables)
        svdpp_epoch(*tabs, plan.packed, schedule, hp, rates, **kw)
        return tabs
    repeat_check(run, "svdpp")


def phase_schedules(schedule):
    """The S, R and Y steps of an S/R/Y ``schedule`` (ph, ub, ib, row),
    each as a schedule of its own, in order."""
    ph = schedule[0]
    return {name: tuple(t[ph == code].contiguous() for t in schedule)
            for name, code in (("S", 0), ("R", 1), ("Y", 2))}


def svdpp_phase_split(plan, tables, schedule, hp, rates, **kw):
    """ms of the SVD++ kernel (CUDA events) over the whole ``schedule`` and
    over its S, its R and its Y steps alone, each from copies of
    ``tables``. A restricted launch zeroes s and c at each user block as
    the whole one does, so its steps do the same work; only their
    inputs (s and c) differ."""
    from mymedialite_tpu_torch.ops.svdpp_epoch import svdpp_epoch
    out = {}
    parts = {"epoch": schedule, **phase_schedules(schedule)}
    for name, sched in parts.items():
        tabs = tuple(t.clone() for t in tables)
        start, end = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        svdpp_epoch(*tabs, plan.packed, sched, hp, rates, **kw)
        end.record()
        torch.cuda.synchronize()
        out[name] = (start.elapsed_time(end), sched[0].numel())
    return out


def svdpp_variant_line(plan, num_factors: int, fe: int) -> str:
    """What the SVD++ kernel keeps in shared memory at this plan's shape
    (``accumulator_variant``), with the shared memory it asks for."""
    from mymedialite_tpu_torch.ops import svdpp_epoch as se
    variant = se.accumulator_variant(plan.user_block, num_factors,
                                     plan.chunk, fe)
    where = {"shared": "R and Y read s, c and n from a copy in shared "
                       "memory",
             "global": "R and Y read s, c and n through L2"}[variant]
    nbytes = se.shared_bytes(fe, plan.chunk, plan.user_block, num_factors,
                             variant)
    return (f"svdpp_epoch variant {variant}: {where} (UB {plan.user_block}, "
            f"k={num_factors}, fe {fe}, C {plan.chunk}; {nbytes} B of shared "
            f"memory)")


def user_block_bounds(ub):
    """[(start, end)) of each user block's steps in a schedule whose
    user blocks ``ub`` come in contiguous runs."""
    cut = (torch.nonzero(ub[1:] != ub[:-1]).flatten() + 1).tolist()
    bounds = [0, *cut, ub.numel()]
    return list(zip(bounds[:-1], bounds[1:]))


def svdpp_one_step_witness(plan, tables, hp, rates, **kw):
    """The MAE check of the SVD++ kernel (see ``sgd_one_step_witness``).
    A launch zeroes s and c, so a step cannot run alone; but an S step
    writes only s, and an R step reads s and writes W, Q and c, which
    only the block's Y steps read. So (1) each R step, where the MAE sign
    lives, runs after its block's S steps: the kernel over [the block's S
    steps, the R step] from the float64 trajectory's state before the R
    step, against float64 over the same steps (the float64 trajectory
    then takes each block whole); (2) the whole-epoch witness. Returns
    (one-step error, kernel distance, plain distance)."""
    from mymedialite_tpu_torch.ops.svdpp_epoch import (
        svdpp_epoch, svdpp_epoch_reference,
    )
    dev = tables[0].device
    packed_c, rates_c = plan.packed.cpu(), rates.cpu().double()
    sched = tuple(t.cpu() for t in plan.schedule)
    ph = sched[0]
    state = tuple(t.double().cpu() for t in tables)
    step_err = 0.0
    for a, b in user_block_bounds(sched[1]):
        steps = torch.arange(a, b)
        s_steps = steps[ph[a:b] == 0]
        cur = state
        for r in steps[ph[a:b] == 1].tolist():
            one = torch.cat([s_steps, torch.tensor([r])])
            one_c = tuple(t[one].contiguous() for t in sched)
            nxt = tuple(t.clone() for t in cur)
            svdpp_epoch_reference(*nxt, packed_c, one_c, hp, rates_c, **kw)
            got = tuple(t.float().to(dev) for t in cur)
            svdpp_epoch(*got, plan.packed, tuple(t.to(dev) for t in one_c),
                        hp, rates, **kw)
            step_err = max(step_err, table_distance(got, nxt))
            cur = nxt
        svdpp_epoch_reference(*state, packed_c,
                              tuple(t[a:b].contiguous() for t in sched), hp,
                              rates_c, **kw)

    def run(fn, tabs):
        d = tabs[0].device
        out = tuple(t.clone() for t in tabs)
        fn(*out, plan.packed.to(d), tuple(t.to(d) for t in plan.schedule),
           hp, rates.to(d, tabs[0].dtype), **kw)
        return out

    return (step_err, *whole_epoch_witness(
        tables, lambda tabs: run(svdpp_epoch, tabs),
        lambda tabs: run(svdpp_epoch_reference, tabs)))


# (label, sigmoid, loss, use_p): SVDPlusPlus, SigmoidSVDPlusPlus with the
# RMSE and the MAE loss, and the asymmetric factor models (no p)
SVDPP_VARIANTS = (("plain", False, 0, True), ("sigmoid rmse", True, 0, True),
                  ("sigmoid mae", True, 1, True),
                  ("no p (afm)", True, 0, False))


def phase_svdpp_kernel_check(dev):
    from mymedialite_tpu_torch.data.synthetic import synthetic_ratings
    from mymedialite_tpu_torch.ops import svdpp_plan as sp
    from mymedialite_tpu_torch.ops.svdpp import history_edges
    U, I, f = 2000, 3000, 20
    data = synthetic_ratings(num_users=U, num_items=I, num_ratings=100_000,
                             seed=3)
    hu, hi = history_edges(data.users, data.items, I)
    plan = sp.prepare_svdpp_mxu(data.users, data.items, data.values, hu, hi,
                                U, I, shuffle_seed=4, device=dev)
    fe = sp.svdpp_fe(f)
    rng = np.random.default_rng(5)
    p, bu, q, bi, y = (torch.from_numpy(
        (0.1 * rng.standard_normal(shape)).astype(np.float32)).to(dev)
        for shape in ((U, f), (U,), (I, f), (I,), (I, f)))
    noo = torch.from_numpy(plan.new_of_old.astype(np.int64)).to(dev)
    log(svdpp_variant_line(plan, f, fe))
    worst = 0.0
    for label, sigmoid, loss, use_p in SVDPP_VARIANTS:
        tables = sp.svdpp_tables_to_mxu(
            p if use_p else torch.zeros_like(p), bu, plan.inv_sqrt, q, bi, y,
            noo, u_pad=plan.u_pad, i_pad=plan.i_pad, fe=fe)
        # SVDPlusPlus's defaults at quality.py's learn rate
        rates = sp.svdpp_mxu_rates(f, fe, 0.003, 0.7, 0.015, 0.33, 0.015,
                                   use_p=use_p, update_user=True,
                                   update_item=True, device=dev)
        hp = (0.6, 1.0, 4.0) if sigmoid else (3.6, 1.0, 4.0)
        shape = (f"{plan.num_steps} steps over {plan.packed.shape[0]} chunks "
                 f"of {plan.chunk}")
        if loss == 1:                                # MAE
            err, k_dist, p_dist = svdpp_one_step_witness(
                plan, tables, hp, rates, user_block=plan.user_block,
                item_block=plan.item_block, num_factors=f, loss=loss,
                sigmoid=sigmoid)
            log(f"svdpp kernel check {label}: R steps one at a time "
                f"max_abs_err {err:.3e} (tol {KERNEL_TOL}); whole epoch vs "
                f"float64: kernel {k_dist:.3e}, farthest plain {p_dist:.3e} "
                f"(bound {WITNESS_FACTOR} x) ({shape})")
            witness_check(err, k_dist, p_dist, f"svdpp {label}")
        else:
            err, k_ms, p_ms = svdpp_kernel_vs_plain(
                plan, tables, plan.schedule, hp, rates, num_factors=f,
                loss=loss, sigmoid=sigmoid)
            log(f"svdpp kernel check {label}: max_abs_err {err:.3e} (tol "
                f"{KERNEL_TOL}) kernel {k_ms:.2f} ms plain {p_ms:.1f} ms "
                f"({shape})")
            check(err, f"svdpp {label}")
        svdpp_repeats(plan, tables, plan.schedule, hp, rates,
                      user_block=plan.user_block, item_block=plan.item_block,
                      num_factors=f, loss=loss, sigmoid=sigmoid)
        worst = max(worst, err)
    log("svdpp kernel checks: every variant launched twice from the same "
        "inputs gives equal tables bit for bit")
    return max(worst, svdpp_cluster_orders(dev))


def svdpp_cluster_orders(dev):
    """The schedules that exercise the SVD++ walk's cluster
    (``ops/cluster.py``): an epoch over Zipf(1.2) users and an 8-item
    catalog (the card tests' duplicate users and items: runs of hundreds
    of slots in s, W, c, n, Q and Y), at 20 and 100 factors (the shared
    and the global variant), and an epoch in which one user alone in its
    block fills whole S and R steps. Each against the plain version and
    a second launch, with its us a step, the cluster and the variant.
    Returns the largest error."""
    from mymedialite_tpu_torch.ops import svdpp_plan as sp
    from mymedialite_tpu_torch.ops.svdpp_epoch import cluster_size
    from mymedialite_tpu_torch.ops.svdpp import history_edges
    from mymedialite_tpu_torch.ops.svdpp_epoch import accumulator_variant
    rng = np.random.default_rng(8)
    n = 12_000
    zipf = ((rng.zipf(1.2, n) % 1100).astype(np.int32),
            rng.integers(0, 8, n).astype(np.int32), 1100, 8)
    heavy = (np.concatenate([np.zeros(1024, np.int32),
                             rng.integers(512, 600, 500).astype(np.int32)]),
             np.concatenate([rng.permutation(1024),
                             rng.integers(0, 1024, 500)]).astype(np.int32),
             600, 1024)
    worst = 0.0
    for label, (users, items, U, I), f in (("zipf", zipf, 20),
                                           ("zipf", zipf, 100),
                                           ("heavy user", heavy, 20)):
        values = rng.integers(1, 11, users.size).astype(np.float32) / 2
        hu, hi = history_edges(users, items, I)
        plan = sp.prepare_svdpp_mxu(users, items, values, hu, hi, U, I,
                                    shuffle_seed=1, device=dev)
        fe = sp.svdpp_fe(f)
        tabs = (torch.from_numpy((0.1 * rng.standard_normal(s)).astype(
            np.float32)).to(dev) for s in ((U, f), (U,), (I, f), (I,), (I, f)))
        p, bu, q, bi, y = tabs
        noo = torch.from_numpy(plan.new_of_old.astype(np.int64)).to(dev)
        tables = sp.svdpp_tables_to_mxu(p, bu, plan.inv_sqrt, q, bi, y, noo,
                                        u_pad=plan.u_pad, i_pad=plan.i_pad,
                                        fe=fe)
        rates = sp.svdpp_mxu_rates(f, fe, 0.003, 0.7, 0.015, 0.33, 0.015,
                                   use_p=True, update_user=True,
                                   update_item=True, device=dev)
        kw = dict(num_factors=f, loss=0, sigmoid=True)
        err, k_ms, _ = svdpp_kernel_vs_plain(plan, tables, plan.schedule,
                                             (0.6, 1.0, 4.0), rates, **kw)
        what = f"svdpp {label} epoch k={f}"
        check(err, what)
        svdpp_repeats(plan, tables, plan.schedule, (0.6, 1.0, 4.0), rates,
                      user_block=plan.user_block, item_block=plan.item_block,
                      **kw)
        variant = accumulator_variant(plan.user_block, f, plan.chunk, fe)
        log(f"{what}: max_abs_err {err:.3e} (tol {KERNEL_TOL}), "
            f"{k_ms * 1e3 / plan.num_steps:.2f} us a step over "
            f"{plan.num_steps} steps of {plan.chunk} (a cluster of "
            f"{cluster_size(plan.chunk)}, variant {variant}); twice: equal")
        worst = max(worst, err)
    return worst


def phase_svdpp_path(dev, train, test, *, prefix_blocks: int = 64):
    """SVDPlusPlus at k=20 (quality.py's learn rate 0.003) for 3 epochs
    through the registry, transductive on the test pairs; the epoch kernel
    against its plain version on the schedule's first ``prefix_blocks``
    user blocks (s and c start from zero at each block, so such a prefix
    is a whole piece of the epoch); RMSE against the global average.
    Returns the kernel's numbers for the kernels line and the model."""
    from mymedialite_tpu_torch.eval.rating import evaluate_ratings
    from mymedialite_tpu_torch.models import svdpp as svdpp_module
    from mymedialite_tpu_torch.models.registry import create_rating_predictor
    from mymedialite_tpu_torch.ops import svdpp_plan as sp

    model = create_rating_predictor(
        "SVDPlusPlus",
        f"num_factors=20 num_iter=3 learn_rate=0.003 device={dev.type}")
    model.ratings = train
    model.additional_feedback = (test.users, test.items)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with timed_training((sp, "prepare_svdpp_mxu"),
                        (svdpp_module, "svdpp_epoch")) as timings, \
            counted_path({"svdpp_epoch": model.num_iter}) as counted:
        t0 = time.perf_counter()
        model.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    tables = model._mxu_tables
    if any(t.device.type != dev.type for t in tables):
        raise AssertionError("kernel-layout tables are not on the card")
    plan = model._plan
    ph, ub, ib, row = plan.schedule
    epoch_ms = float(np.mean(timings["epoch_ms"]))
    full_ms, full_by = svdpp_bound(plan, ph, ub, ib, row, model.num_factors)
    log(f"svdpp train: {train_s:.2f} s; plan prep {timings['plan_s'][0]:.2f} "
        f"s ({plan.n_edges} edges, {plan.n_ratings} ratings; "
        f"{int((ph == 0).sum())} S + {int((ph == 1).sum())} R + "
        f"{int((ph == 2).sum())} Y = {plan.num_steps} steps of "
        f"{plan.chunk}, {plan.n_ublocks} x {plan.n_iblocks} blocks, largest "
        f"user block {int(torch.bincount(ub.long()).max())} steps); "
        f"svdpp_epoch launches {counted['svdpp_epoch']}; epochs "
        f"{', '.join(f'{t:.1f}' for t in timings['epoch_ms'])} ms; "
        f"{len(train) / (epoch_ms / 1e3):.4g} rating updates/s; epoch bound "
        f"{full_ms:.4f} ms ({full_by}); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # the kernel against the plain version on the first user blocks, from
    # the trained tables (one more pass over them each)
    n = int((ub < prefix_blocks).sum())
    prefix = tuple(t[:n].contiguous() for t in plan.schedule)
    hp, rates = model._epoch_args()
    log(svdpp_variant_line(plan, model.num_factors, tables[0].shape[1]))
    split = svdpp_phase_split(plan, tables, plan.schedule, hp, rates,
                              user_block=plan.user_block,
                              item_block=plan.item_block,
                              num_factors=model.num_factors, loss=0,
                              sigmoid=False)
    log("svdpp epoch split, the kernel over one phase's steps from the "
        "trained tables: " + ", ".join(
            f"{name} {ms:.1f} ms over {steps} steps "
            f"({ms * 1e3 / max(steps, 1):.2f} us a step)"
            for name, (ms, steps) in split.items()))
    err, kernel_ms, plain_ms = svdpp_kernel_vs_plain(
        plan, tables, prefix, hp, rates, num_factors=model.num_factors,
        loss=0, sigmoid=False)
    b_ms, b_by = svdpp_bound(plan, *prefix, model.num_factors)
    log(f"full-shape svdpp_epoch (first {prefix_blocks} of "
        f"{plan.n_ublocks} user blocks, {n} of {plan.num_steps} steps): "
        f"kernel {kernel_ms:.1f} ms, plain {plain_ms:.1f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}), max_abs_err {err:.3e} (tol {KERNEL_TOL})")
    check(err, "svdpp_epoch at full shape")

    t0 = time.perf_counter()
    res = evaluate_ratings(model, test, train)
    eval_s = time.perf_counter() - t0
    baseline = global_average_rmse(train, test)
    log(f"svdpp eval: {res} ({eval_s:.2f} s); global-average RMSE "
        f"{baseline:.5f}")
    if not (math.isfinite(res["RMSE"]) and res["RMSE"] < baseline):
        raise AssertionError("SVD++ RMSE does not beat the global average")
    return dict(launches=counted["svdpp_epoch"], max_abs_err=err,
                ms=kernel_ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by), model


# the cases of tests/test_pallas_topk.py, then the serving shape:
# (label, B, N, f, k, mask)
TOPK_CASES = (("basic", 16, 1000, 24, 10, None),
              ("users and tiles", 300, 1537, 17, 7, None),
              ("half mask", 32, 700, 8, 5, 0.5),
              ("nearly all masked", 4, 50, 6, 4, "nearly"),
              ("k > N", 8, 6, 4, 10, None),
              ("ties", 3, 600, 4, 5, "ties"),
              ("serving shape", 1024, 62_423, 41, 64, None))


def phase_topk_kernel_check(dev):
    """Kernel 6 against ``topk_reference`` on the card: values to
    KERNEL_TOL, ids equal where the reference has no near-tie (1e-5),
    every id in the tie case; k = 65 must be refused."""
    from mymedialite_tpu_torch.ops.catalog_topk import (
        catalog_topk, topk_reference,
    )
    worst = 0.0
    for label, B, N, f, k, mask_kind in TOPK_CASES:
        rng = np.random.default_rng(B + N)
        W = rng.normal(size=(B, f)).astype(np.float32)
        H = rng.normal(size=(N, f)).astype(np.float32)
        mask = None
        if mask_kind == "ties":
            W, H = np.ones_like(W), np.ones_like(H)
        elif mask_kind == "nearly":
            mask = np.zeros((B, N), np.int8)
            mask[0, [3, 10]] = 1
            mask[1, :] = 1
        elif mask_kind is not None:
            mask = (rng.random((B, N)) > mask_kind).astype(np.int8)
        W, H = torch.from_numpy(W).to(dev), torch.from_numpy(H).to(dev)
        if mask is not None:
            mask = torch.from_numpy(mask).to(dev)
        start, end = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        start.record()
        ids, vals = catalog_topk(W, H, mask, k=k)
        end.record()
        torch.cuda.synchronize()
        ref = topk_reference(W, H, mask, k=k + 1 if k < N else k)
        err, bad = topk_agreement(ids.cpu(), vals.cpu(), *(
            t.cpu() for t in ref), exact=mask_kind == "ties")
        log(f"topk kernel check {label} (B={B} N={N} f={f} k={k}): "
            f"max_abs_err {err:.3e} (tol {KERNEL_TOL}), ids differing "
            f"outside near-ties {bad}, kernel {start.elapsed_time(end):.3f} "
            f"ms")
        check(err, f"topk {label}")
        if bad:
            raise AssertionError(f"topk {label}: {bad} ids differ")
        worst = max(worst, err)
    try:
        catalog_topk(W, H, k=65)
    except ValueError:
        pass
    else:
        raise AssertionError("catalog_topk took k=65")
    return worst


@contextlib.contextmanager
def substituted_topk(fn):
    """Inside the block ``recommend_batch``'s top-k step is ``fn``."""
    from mymedialite_tpu_torch.ops import topk as topk_module
    real = topk_module.catalog_topk
    topk_module.catalog_topk = fn
    try:
        yield
    finally:
        topk_module.catalog_topk = real


@contextlib.contextmanager
def recorded_topk():
    """Inside the block ``recommend_batch`` launches the kernel as usual
    and the arguments of each call are kept. Yields the list of (args,
    kwargs)."""
    from mymedialite_tpu_torch.ops.catalog_topk import catalog_topk
    calls = []

    def record(*a, **kw):
        calls.append((a, kw))
        return catalog_topk(*a, **kw)
    with substituted_topk(record):
        yield calls


def replay_ms(fn, calls):
    """``fn`` over the recorded calls back to back, after one warm-up
    call: (device ms between two CUDA events around the whole replay,
    the outputs). The kernel takes far longer than the host needs to
    enqueue the next call, so the host's time per call stays hidden."""
    fn(*calls[0][0], **calls[0][1])
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    outs = [fn(*a, **kw) for a, kw in calls]
    end.record()
    end.synchronize()
    return start.elapsed_time(end), outs


def library_topk(user_rows, item_table, mask8=None, *, k):
    """The library yardstick of kernel 6 (timed here, never used by the
    port): torch.matmul, the mask and torch.topk, whose tie order is
    open."""
    from mymedialite_tpu_torch.ops.catalog_topk import NEG_INF
    scores = torch.matmul(user_rows, item_table.T)
    if mask8 is not None:
        scores.masked_fill_(mask8 == 0, NEG_INF)
    vals, ids = torch.topk(scores, k, dim=1)
    return ids.to(torch.int32), vals


@contextlib.contextmanager
def timed_ignore_rows():
    """Inside the block ``recommend_batch``'s host ignore rows
    (``row_counts`` and ``ragged_rows``) are timed on the host clock and
    each block's rows kept. Yields {"s": seconds, "rows": [...]}."""
    from mymedialite_tpu_torch.ops import topk as topk_module
    real = topk_module.row_counts, topk_module.ragged_rows
    out = {"s": 0.0, "rows": []}

    def timed(fn, keep):
        def call(*a, **kw):
            t0 = time.perf_counter()
            r = fn(*a, **kw)
            out["s"] += time.perf_counter() - t0
            if keep:
                out["rows"].append(r)
            return r
        return call
    topk_module.row_counts = timed(real[0], False)
    topk_module.ragged_rows = timed(real[1], True)
    try:
        yield out
    finally:
        topk_module.row_counts, topk_module.ragged_rows = real


def replay_masks(rows, num_items, dev):
    """``recommend_batch``'s mask step over the kept ignore rows, as the
    pass runs it (all items candidates): the rows copied to the card, the
    [B, N] byte mask made and the ignored items set to 0. Returns (host
    seconds up to a synchronise, the masks)."""
    cand = torch.ones(num_items, dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    masks = []
    for r in rows:
        ignore = torch.from_numpy(r).to(dev)
        B = ignore.shape[0]
        mask = cand.to(torch.int8).expand(B, -1).contiguous()
        at = torch.arange(B, device=dev)[:, None].expand_as(ignore)
        keep = ignore < num_items
        mask[at[keep], ignore[keep]] = 0
        masks.append(mask)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, masks


def replay_copies(outs):
    """The copies of each block's (ids, scores) back to the host, as the
    pass makes them: host seconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for ids, vals in outs:
        vals.cpu().numpy(), ids.cpu().numpy()
    return time.perf_counter() - t0


def phase_serving(dev, model, train, label, n=10):
    """Top-n for every user of ``model`` with the training items
    excluded, through ``recommend_batch``: on the kernel route, kernel 6
    launched once per block of 1,024 users and no other kernel. Each
    block's inputs are kept, and the kernel, the plain version (one
    column more, for the near-tie rule) and the library call are then
    timed over them back to back. Returns the kernel's numbers for the
    kernels line."""
    from mymedialite_tpu_torch.ops.catalog_topk import (
        catalog_topk, topk_reference,
    )
    from mymedialite_tpu_torch.ops.topk import (
        recommend_batch, takes_topk_kernel,
    )
    users = np.arange(model.num_users_trained, dtype=np.int32)
    if not takes_topk_kernel(model, n):
        raise AssertionError("the model does not take the kernel route")
    train.by_user                                  # the host CSR, once
    blocks = -(-users.size // 1024)
    torch.cuda.synchronize()
    with recorded_topk() as calls, timed_ignore_rows() as ignore, \
            counted_path({"catalog_topk": blocks}) as counted:
        t0 = time.perf_counter()
        ids, scores = recommend_batch(model, users, n, training=train)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    if not ((ids >= 0).all() and np.isfinite(scores).all()):
        raise AssertionError(f"{label} serving: a list is short or not "
                             "finite")
    kernel_ms, k_out = replay_ms(catalog_topk, calls)
    # how the pass splits: the host's ignore rows (timed in the pass), the
    # mask on the card and the copies back (replayed), the kernel
    mask_s, masks = replay_masks(ignore["rows"], model.num_items_trained, dev)
    if not all(torch.equal(m, a[2]) for m, (a, _) in zip(masks, calls)):
        raise AssertionError(f"{label} serving: the replayed masks differ")
    del masks
    copy_s = replay_copies(k_out)
    rest_s = wall_s - ignore["s"] - mask_s - kernel_ms / 1e3 - copy_s
    parts = device_ms(lambda: [catalog_topk(*a, **kw) for a, kw in calls],
                      ("topk_split_kernel", "topk_merge_kernel"))
    log(f"{label} kernel 6 over the same blocks (torch.profiler): "
        f"{split_line(parts)}")
    log(f"{label} serving pass {wall_s:.3f} s: host ignore rows "
        f"{ignore['s']:.3f} s, mask on the card {mask_s:.3f} s, kernel "
        f"{kernel_ms / 1e3:.3f} s, copies back {copy_s:.3f} s, the rest "
        f"{rest_s:.3f} s")
    plain_ms, p_out = replay_ms(
        lambda *a, k: topk_reference(*a, k=k + 1), calls)
    lib_ms, l_out = replay_ms(library_topk, calls)

    def joined(outs, j):
        return torch.cat([o[j] for o in outs]).cpu().numpy()
    if not np.array_equal(joined(k_out, 0), ids):
        raise AssertionError(f"{label} serving: the replayed kernel gave "
                             "other lists than the main path")
    ref_ids, ref_vals = joined(p_out, 0), joined(p_out, 1)
    err, bad = topk_agreement(ids, scores, ref_ids, ref_vals)
    _, lib_bad = topk_agreement(joined(l_out, 0), joined(l_out, 1), ref_ids,
                                ref_vals)
    _, items_rows = model.fused_rows()
    sizes = [a[0].shape[0] for a, _ in calls]
    b_ms, b_by = topk_bound(sizes, items_rows.shape[0], items_rows.shape[1],
                            n)
    log(f"{label} serving: top-{n} for {users.size} users x "
        f"{items_rows.shape[0]} items (f'={items_rows.shape[1]}), training "
        f"items excluded: recommend_batch {wall_s:.2f} s, catalog_topk "
        f"launches {counted['catalog_topk']}; on the same blocks back to "
        f"back: kernel {kernel_ms:.1f} ms ({kernel_ms / blocks:.3f} ms per "
        f"block), bound {b_ms:.4f} ms ({b_by}), plain version "
        f"{plain_ms:.1f} ms, torch.matmul + torch.topk {lib_ms:.1f} ms; "
        f"max_abs_err {err:.3e} (tol {KERNEL_TOL}), ids differing outside "
        f"near-ties {bad} (library call: {lib_bad})")
    check(err, f"{label} serving")
    if bad:
        raise AssertionError(f"{label} serving: {bad} ids differ from the "
                             "plain version outside near-ties")
    del calls, k_out, p_out, l_out
    torch.cuda.empty_cache()
    return dict(launches=counted["catalog_topk"], max_abs_err=err,
                ms=kernel_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=lib_ms)


def run_cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    text = out.getvalue()
    log(text.rstrip())
    if rc != 0:
        raise AssertionError(f"CLI returned {rc}")
    return text


def save_load_same(main, argv, model_path):
    """Train with --save-model, then --load-model: the result lines must
    agree apart from the times. Returns the first run's output."""
    trained = run_cli(main, argv + ["--save-model", model_path])
    loaded = run_cli(main, argv + ["--load-model", model_path])
    last = lambda text: _TIMES.sub("", text.strip().splitlines()[-1])  # noqa: E731
    if last(loaded) != last(trained):
        raise AssertionError("save -> load through the CLI changed the "
                             f"result line:\n{trained}\n{loaded}")
    return trained


def result_value(text, key):
    tokens = text.strip().splitlines()[-1].split()
    return float(tokens[tokens.index(key) + 1])


def phase_cli(dev, tmp):
    from mymedialite_tpu_torch.cli import rating_prediction
    from mymedialite_tpu_torch.data.synthetic import (
        split_ratings, synthetic_ratings,
    )

    data = synthetic_ratings(num_users=6040, num_items=3706,
                             num_ratings=1_000_000, seed=4)
    train, test = split_ratings(data, 0.1, seed=5)
    paths = []
    for name, part in (("train", train), ("test", test)):
        path = os.path.join(tmp, f"{name}.tsv")
        np.savetxt(path, np.column_stack([part.users, part.items,
                                          part.values]),
                   fmt=("%d", "%d", "%g"), delimiter="\t")
        paths.append(path)
    files = ["--training-file", paths[0], "--test-file", paths[1]]
    # BiasedMatrixFactorization (the default), then SVDPlusPlus, which the
    # CLI makes transductive on the test pairs
    for kernel, model, opts in (
            ("sgd_epoch", "biasedmf", "num_factors=40 num_iter=3"),
            ("svdpp_epoch", "svdpp",
             "num_factors=20 num_iter=3 learn_rate=0.003")):
        argv = files + ["--recommender-options", f"{opts} device={dev.type}"]
        if model == "svdpp":
            argv += ["--recommender", "SVDPlusPlus"]
        with counted_path({kernel: 3}):
            text = save_load_same(rating_prediction.main, argv,
                                  os.path.join(tmp, f"{model}.model"))
        rmse = result_value(text, "RMSE")
        if not (math.isfinite(rmse) and 0 < rmse < 2):
            raise AssertionError(f"bad CLI result ({model}): RMSE {rmse}")
    return files


def phase_ranking_cli(dev, tmp, files):
    """The rating_based_ranking CLI on phase 16's files with
    BiasedMatrixFactorization, then save -> load: a finite result line,
    the same after loading."""
    from mymedialite_tpu_torch.cli import rating_based_ranking
    argv = files + ["--recommender-options",
                    f"num_factors=40 num_iter=3 device={dev.type}"]
    with counted_path({"sgd_epoch": 3}):
        text = save_load_same(rating_based_ranking.main, argv,
                              os.path.join(tmp, "ranking.model"))
    for key in ("AUC", "prec@5"):
        value = result_value(text, key)
        if not (math.isfinite(value) and 0 <= value <= 1):
            raise AssertionError(f"bad ranking CLI result: {key} {value}")


@contextlib.contextmanager
def checked_prediction_files(cli):
    """Inside the block every prediction file that ``cli`` writes is read
    back and held against the plain version's lists on the same fused
    rows and masks (``recommend_batch`` with ``topk_reference`` in the
    kernel's place, one item more for the near-tie rule): the same item
    at every position outside near-ties, scores to 1e-4 (the file keeps
    six digits). Yields the list of the checks' reports, which it logs
    when the block ends (the CLI's standard output is captured inside)."""
    from mymedialite_tpu_torch.ops.catalog_topk import topk_reference
    from mymedialite_tpu_torch.ops.topk import recommend_batch
    real = cli.write_predictions
    checked = []

    def write_and_check(recommender, training, path, user_mapping,
                        item_mapping, n, test_users=None, candidates=None):
        real(recommender, training, path, user_mapping, item_mapping, n,
             test_users, candidates)
        users = np.arange(recommender.num_users_trained) \
            if test_users is None else np.asarray(test_users)
        with substituted_topk(topk_reference):
            ref_ids, ref_s = recommend_batch(recommender, users, n + 1,
                                             training=training,
                                             candidates=candidates)
        ids, scores = np.full((users.size, n), -1), np.zeros((users.size, n))
        with open(path) as f:
            lines = f.read().splitlines()
        if len(lines) != users.size:
            raise AssertionError(f"{path}: {len(lines)} lines for "
                                 f"{users.size} users")
        for r, line in enumerate(lines):
            user, items = line.split("\t")
            if user != str(user_mapping.to_original(int(users[r]))):
                raise AssertionError(f"{path}: line {r} names user {user}")
            for c, pair in enumerate(items.strip("[]").split(",")):
                item, score = pair.split(":")
                ids[r, c] = item_mapping.to_internal(item)
                scores[r, c] = float(score)
        err, bad = topk_agreement(ids, scores, ref_ids, ref_s)
        report = (f"prediction file: {users.size} lists of {n}, max score "
                  f"error {err:.3e}, items differing outside near-ties {bad}")
        if err > 1e-4 or bad:
            raise AssertionError(f"{path} disagrees with the plain version: "
                                 f"{report}")
        checked.append(report)
    cli.write_predictions = write_and_check
    try:
        yield checked
    finally:
        cli.write_predictions = real
        for report in checked:
            log(report)


def phase_item_cli(dev, tmp):
    from mymedialite_tpu_torch.cli import item_recommendation
    from mymedialite_tpu_torch.data.synthetic import (
        posonly_from_ratings, split_posonly, synthetic_ratings,
    )

    data = posonly_from_ratings(synthetic_ratings(
        num_users=6040, num_items=3706, num_ratings=1_000_000, seed=4))
    train, test = split_posonly(data, 0.1, seed=5)
    paths = []
    for name, part in (("items_train", train), ("items_test", test)):
        path = os.path.join(tmp, f"{name}.tsv")
        np.savetxt(path, np.column_stack([part.users, part.items]),
                   fmt="%d", delimiter="\t")
        paths.append(path)
    files = ["--training-file", paths[0], "--test-file", paths[1]]
    argv = files + [
            "--recommender", "BPRMF", "--recommender-options",
            f"num_factors=40 num_iter=3 device={dev.type}",
            "--predict-items-number", "10", "--prediction-file",
            os.path.join(tmp, "predictions.txt")]
    # both runs write the top-10 of every user the files name: kernel 6
    # once per block of 1,024
    n_users, n_items = (np.unique(np.concatenate([a, b])).size for a, b in (
        (train.users, test.users), (train.items, test.items)))
    blocks = -(-n_users // 1024)
    with counted_path({"bpr_epoch": 3, "catalog_topk": 2 * blocks}), \
            checked_prediction_files(item_recommendation) as checked:
        text = save_load_same(item_recommendation.main, argv,
                              os.path.join(tmp, "bprmf.model"))
    auc = result_value(text, "AUC")
    if not (math.isfinite(auc) and 0.5 < auc <= 1) or len(checked) != 2:
        raise AssertionError(f"bad item CLI result: AUC {auc}")
    # users recommended for items: the transposed feedback, one list per
    # item
    blocks = -(-n_items // 1024)
    with counted_path({"bpr_epoch": 3, "catalog_topk": blocks}), \
            checked_prediction_files(item_recommendation) as checked:
        text = run_cli(item_recommendation.main, argv + ["--user-prediction"])
    auc = result_value(text, "AUC")
    if not (math.isfinite(auc) and 0.5 < auc <= 1) or len(checked) != 1:
        raise AssertionError(f"bad --user-prediction result: AUC {auc}")
    return files


def events_ms(pairs) -> float:
    """Sum of the elapsed ms of recorded (start, end) CUDA event pairs."""
    torch.cuda.synchronize()
    return float(sum(s.elapsed_time(e) for s, e in pairs))


@contextlib.contextmanager
def recorded_events(*targets):
    """Inside the block every call of each (owner, name, key) target
    records a pair of CUDA events under ``key``; yields {key: [pairs]}.
    An owner is a module or an object (its attribute)."""
    events = {key: [] for _, _, key in targets}
    saved = []
    for owner, name, key in targets:
        real = getattr(owner, name)

        def timed(*a, _real=real, _key=key, **kw):
            s, e = torch.cuda.Event(enable_timing=True), \
                torch.cuda.Event(enable_timing=True)
            s.record()
            out = _real(*a, **kw)
            e.record()
            events[_key].append((s, e))
            return out
        saved.append((owner, name, real))
        setattr(owner, name, timed)
    try:
        yield events
    finally:
        for owner, name, real in saved:
            setattr(owner, name, real)


# seeded test users of the ranking evaluations, and sampled rows of the
# KNN float64 check
EVAL_USERS = 4096
KNN_ROWS = 256


def sampled_ranking_eval(model, train, test, label, seed=9):
    """Ranking evaluation of ``EVAL_USERS`` seeded test users."""
    from mymedialite_tpu_torch.eval.ranking import evaluate_items
    rng = np.random.default_rng(seed)
    sample = np.sort(rng.choice(test.all_users, EVAL_USERS, replace=False))
    t0 = time.perf_counter()
    res = evaluate_items(model, test, train, test_users=sample)
    log(f"ranking eval {label}, {res['num_users']} users: {res} "
        f"({time.perf_counter() - t0:.2f} s)")
    for k in ("AUC", "prec@5", "NDCG"):
        if not math.isfinite(res[k]):
            raise AssertionError(f"{label} {k} is not finite")
    return res


def wrmf_user_side_f64(feedback, H, alpha: float, reg: float):
    """Every user's row of W solved in float64 from the feedback's
    distinct (user, item) pairs and the float64 item factors, apart from
    ``ops/als.py``: M_u = H^T H + alpha sum_{i in S_u} h_i h_i^T + reg I
    and b_u = (1 + alpha) sum_{i in S_u} h_i, the sums as one sparse
    [U, I] product with H and with the rows' outer products."""
    dev = H.device
    n_items, f = H.shape
    U = feedback.num_users
    key = torch.unique(
        torch.from_numpy(feedback.users.astype(np.int64)).to(dev) * n_items
        + torch.from_numpy(feedback.items.astype(np.int64)).to(dev))
    users, items = key // n_items, key % n_items
    crow = torch.zeros(U + 1, dtype=torch.int64, device=dev)
    crow[1:] = torch.cumsum(torch.bincount(users, minlength=U), 0)
    A = torch.sparse_csr_tensor(
        crow, items, torch.ones(key.numel(), dtype=torch.float64,
                                device=dev), size=(U, n_items))
    del key, users, items
    H64 = H.double()
    b = (1.0 + alpha) * (A @ H64)
    M = (A @ (H64[:, :, None] * H64[:, None, :]).reshape(n_items, f * f)
         ).reshape(U, f, f)
    M.mul_(alpha).add_(H64.T @ H64 + reg * torch.eye(
        f, dtype=torch.float64, device=dev))
    L, info = torch.linalg.cholesky_ex(M)
    del M
    if bool((info != 0).any()):
        raise AssertionError("float64: a system is not positive definite")
    return torch.cholesky_solve(b[:, :, None], L)[:, :, 0]


@contextlib.contextmanager
def tf32_products():
    """A stand-in for ``device.exact_float32`` that lets the products use
    TF32: the control that the float64 check must catch."""
    m = torch.backends.cuda.matmul
    saved = m.allow_tf32
    m.allow_tf32 = True
    try:
        yield
    finally:
        m.allow_tf32 = saved


def wrmf_user_side_errors(model, feedback):
    """(sound, control): the largest |W32 - W64| over the largest |W64|
    of one user side from the model's item factors, solved through the
    model's own side (length buckets, ``ops/als.py``) with float32
    products, and again with TF32 products, against
    ``wrmf_user_side_f64``."""
    from mymedialite_tpu_torch.ops import als
    H = model.params["item_factors"]
    x64 = wrmf_user_side_f64(feedback, H, model.alpha, model.regularization)
    scale = float(x64.abs().max())
    errs = []
    for products in (als.exact_float32, tf32_products):
        real, als.exact_float32 = als.exact_float32, products
        try:
            x = model._optimize(H, model._user_hist, x64.shape[0])
        finally:
            als.exact_float32 = real
        errs.append(float((x.double() - x64).abs().max()) / scale)
        del x
    return tuple(errs)


# between the float32 reading and the TF32 control's (PERF.md §6):
# largest |W32 - W64| over the largest |W64|
WRMF_F64_TOL = 1e-5


def phase_wrmf_path(dev, train, test):
    """WRMF at k=40 (regularization 100) for 3 alternations through the
    registry on the pairs as positive-only feedback: ms per user side and
    item side (CUDA events), assembly against solve, events/s; one user
    side (480,000 systems of 40 x 40) from the trained item factors held
    to the same side assembled and solved in float64 apart from
    ``ops/als.py``, and a TF32 control that the check must catch; ranking
    evaluation (AUC > 0.6). Returns the trained model and its
    feedback."""
    from mymedialite_tpu_torch.data.synthetic import posonly_from_ratings
    from mymedialite_tpu_torch.models.registry import create_item_recommender
    from mymedialite_tpu_torch.ops import als

    train, test = posonly_from_ratings(train), posonly_from_ratings(test)
    # regularization 100: the synthetic pairs carry popularity and no
    # personal signal, and at the default 0.015 both packages overfit it
    # (AUC 0.57 after 3 alternations at 30,000 x 2,000 x 1M)
    model = create_item_recommender(
        "WRMF", f"num_factors=40 num_iter=3 regularization=100 "
        f"device={dev.type}")
    model.feedback = train
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with recorded_events((model, "_optimize", "side"),
                         (als, "row_systems", "assembly"),
                         (als, "solve_cholesky", "solve")) as ev, \
            counted_path({}):
        t0 = time.perf_counter()
        model.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    del model._optimize
    sides = [s.elapsed_time(e) for s, e in ev["side"]]
    user_ms, item_ms = sides[0::2], sides[1::2]
    assembly_ms, solve_ms = events_ms(ev["assembly"]), events_ms(ev["solve"])
    alternation_s = (sum(sides) / 1e3) / model.num_iter
    log(f"wrmf train: {train_s:.2f} s for {model.num_iter} alternations "
        f"(histories built in the first); user side "
        f"{', '.join(f'{t:.1f}' for t in user_ms)} ms, item side "
        f"{', '.join(f'{t:.1f}' for t in item_ms)} ms; of all sides "
        f"{sum(sides):.1f} ms: assembly {assembly_ms:.1f} ms, solve "
        f"(cholesky_ex) {solve_ms:.1f} ms, the rest "
        f"{sum(sides) - assembly_ms - solve_ms:.1f} ms; "
        f"{len(train) / alternation_s:.4g} events/s per alternation; "
        f"{len(model._user_hist)} user and {len(model._item_hist)} item "
        f"length buckets; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    t0 = time.perf_counter()
    err, control = wrmf_user_side_errors(model, train)
    log(f"wrmf user side ({train.num_users} systems of 40 x 40) against "
        f"float64 assembled and solved apart from ops/als.py: max error "
        f"{err:.3e} of the largest |x| (tol {WRMF_F64_TOL}); with TF32 "
        f"products (the control) {control:.3e}; "
        f"{time.perf_counter() - t0:.1f} s")
    if err > WRMF_F64_TOL:
        raise AssertionError(f"wrmf user side off float64 by {err:.3e} > "
                             f"{WRMF_F64_TOL}")
    # TF32 exists only on the card
    if dev.type == "cuda" and control <= WRMF_F64_TOL:
        raise AssertionError(f"the float64 check misses TF32 products "
                             f"({control:.3e} <= {WRMF_F64_TOL})")
    torch.cuda.empty_cache()
    train.by_user, test.by_user
    res = sampled_ranking_eval(model, train, test, "WRMF")
    if not res["AUC"] > 0.6:
        raise AssertionError(f"WRMF AUC {res['AUC']} <= 0.6")
    return model, train, test


KNN_TOL = 1e-6


def correlation_rows_f64(A, rows, counts, k: int):
    """The reference top-k (k + 1 columns) of the binary cosine of
    ``rows`` against every row of the int8 incidence ``A`` [n, m],
    recomputed in float64 on the card: value desc, id asc."""
    Ar = A[rows].double()
    n = A.shape[0]
    out = torch.empty((rows.numel(), n), dtype=torch.float64,
                      device=A.device)
    step = max(1, (1 << 30) // (8 * A.shape[1]))
    for c0 in range(0, n, step):
        out[:, c0:c0 + step] = Ar @ A[c0:c0 + step].double().T
    cx = counts[rows].double()[:, None]
    cy = counts.double()[None, :]
    den = torch.sqrt(cx * cy)
    corr = torch.where(den > 0, out / den.clamp(min=1e-12), 0.0)
    corr[torch.arange(rows.numel(), device=A.device), rows] = -math.inf
    vals, ids = torch.sort(corr, dim=1, descending=True, stable=True)
    return ids[:, :k + 1].cpu().numpy(), vals[:, :k + 1].cpu().numpy()


def phase_knn_path(dev, train, test):
    """ItemKNN and UserKNN (cosine, k=80) through the registry at this
    shape, both past DENSE_NMAX, so both take the streaming top-k: build
    seconds, the share of the build inside the Gram products (CUDA
    events around each product), peak memory; 256 sampled rows held to a
    float64 recomputation on the card (ids equal outside near-ties of
    1e-6, values within 1e-6); ranking evaluation of 4,096 seeded test
    users."""
    from mymedialite_tpu_torch.models.registry import create_item_recommender
    from mymedialite_tpu_torch.ops import correlation as corr_ops

    rng = np.random.default_rng(17)
    results = {}
    for name, n, m, eids, fids in (
            ("ItemKNN", train.num_items, train.num_users, train.items,
             train.users),
            ("UserKNN", train.num_users, train.num_items, train.users,
             train.items)):
        if n <= corr_ops.DENSE_NMAX:
            raise AssertionError(f"{name}: {n} entities take the dense path")
        model = create_item_recommender(name, f"k=80 device={dev.type}")
        model.feedback = train
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with recorded_events((corr_ops, "_overlap_int8", "gram")) as ev, \
                counted_path({}):
            t0 = time.perf_counter()
            model.train()
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
        gram_ms = events_ms(ev["gram"])
        peak = torch.cuda.max_memory_allocated() / 2**30
        if not model.is_topk:
            raise AssertionError(f"{name} did not take the top-k path")
        e = torch.from_numpy(eids.astype(np.int64)).to(dev)
        f = torch.from_numpy(fids.astype(np.int64)).to(dev)
        A = torch.zeros((n, m), dtype=torch.int8, device=dev)
        A[e, f] = 1
        counts = torch.bincount(torch.unique(e * m + f) // m, minlength=n)
        del e, f
        rows = torch.from_numpy(np.sort(rng.choice(n, KNN_ROWS,
                                                   replace=False))).to(dev)
        ref_ids, ref_vals = correlation_rows_f64(A, rows, counts, 80)
        del A
        ids = model.nbr_ids[rows].cpu().numpy()
        vals = model.nbr_vals[rows].cpu().numpy()
        err, bad = topk_agreement(ids, vals, ref_ids, ref_vals, gap=KNN_TOL)
        log(f"{name} build ({n} x {m}, {len(train)} events, k=80 cosine, "
            f"streaming top-k): {build_s:.2f} s, Gram products "
            f"{gram_ms / 1e3:.2f} s ({100 * gram_ms / 1e3 / build_s:.1f}% "
            f"of the build, {len(ev['gram'])} products), peak device memory "
            f"{peak:.2f} GiB; {KNN_ROWS} sampled rows against float64 on "
            f"the card: "
            f"max value error {err:.3e} (tol {KNN_TOL}), ids differing "
            f"outside near-ties {bad}")
        if err > KNN_TOL or bad:
            raise AssertionError(f"{name}: the top-k disagrees with float64")
        res = sampled_ranking_eval(model, train, test, name)
        results[name] = dict(build_s=build_s, auc=res["AUC"])
        del model
        torch.cuda.empty_cache()
    return results


KNN_PAIRS = 256


def rating_knn_reference(model, users, items):
    """The JAX package's per-pair loop (``knn.py predict_batch``) on the
    host in float64, from the model's stored correlations and baseline:
    baseline + sum w (r - b) / sum w over the first K positive weights in
    (weight desc, id asc, event) order, clipped to the scale."""
    data, bl = model.ratings, model.baseline
    bu, bi = bl.user_biases.cpu().numpy(), bl.item_biases.cpu().numpy()
    gavg = np.float32(bl.global_average)

    def base(u, i):
        b = gavg + (bu[u] if 0 <= u < bu.size else np.float32(0)) \
            + (bi[i] if 0 <= i < bi.size else np.float32(0))
        return float(np.clip(b, bl.min_rating, bl.max_rating))

    if model.is_topk:
        ids = model._sorted_ids.cpu().numpy()
        vals = model._sorted_vals.cpu().numpy()

        def weights(row, cols):
            pos = np.clip(np.searchsorted(ids[row], cols), 0,
                          ids.shape[1] - 1)
            return np.where(ids[row][pos] == cols, vals[row][pos], 0.0)
    else:
        corr = model.corr.cpu().numpy()

        def weights(row, cols):
            return corr[row, cols]
    user = model.ENTITY == "user"
    csr = data.by_item if user else data.by_user
    out = np.empty(len(users))
    for p, (u, i) in enumerate(zip(users, items)):
        row, fixed = (u, i) if user else (i, u)
        seg = csr.segment(fixed)
        others = (data.users if user else data.items)[seg].astype(np.int64)
        w = weights(row, others).astype(np.float64)
        keep = np.nonzero((w > 0) & (others != row))[0]
        keep = keep[np.argsort(-w[keep], kind="stable")][:model.k]
        pred = base(u, i)
        if keep.size:
            b = np.array([base(o, i) if user else base(u, o)
                          for o in others[keep]])
            r = data.values[seg][keep].astype(np.float64)
            pred += float(np.sum(w[keep] * (r - b)) / np.sum(w[keep]))
        out[p] = np.clip(pred, model.min_rating, model.max_rating)
    return out


def pearson_rows_f64(ratings, rows, k: int, shrinkage: float):
    """The reference top-k (k + 1 columns) of item-item Pearson with
    shrinkage between the items ``rows`` and every item, over their
    co-rating users, from the raw ratings in float64 on the card:
    (n Sxy - Sx Sy) / sqrt((n Sxx - Sx^2)(n Syy - Sy^2)) times
    (n - 1) / (n - 1 + shrinkage), 0 below two co-ratings or where the
    root is 0 (Pearson.cs:224-242); the item itself last; value desc, id
    asc. The generator's (user, item) pairs are distinct."""
    dev = rows.device
    n, m = ratings.num_items, ratings.num_users
    e = torch.from_numpy(ratings.items.astype(np.int64)).to(dev)
    order = torch.argsort(e, stable=True)
    e = e[order]
    f = torch.from_numpy(ratings.users.astype(np.int64)).to(dev)[order]
    v = torch.from_numpy(ratings.values.astype(np.float64)).to(dev)[order]
    del order
    ptr = [0] + torch.cumsum(torch.bincount(e, minlength=n), 0).tolist()
    pos = torch.full((n,), -1, dtype=torch.int64, device=dev)
    pos[rows] = torch.arange(rows.numel(), device=dev)
    sel = pos[e] >= 0
    Lr = torch.zeros((rows.numel(), m), dtype=torch.float64, device=dev)
    Lr[pos[e[sel]], f[sel]] = v[sel]
    Br = (Lr != 0).double()
    out = torch.empty((rows.numel(), n), dtype=torch.float64, device=dev)
    step = 512
    for c0 in range(0, n, step):
        c1 = min(n, c0 + step)
        Lc = torch.zeros((c1 - c0, m), dtype=torch.float64, device=dev)
        Lc[e[ptr[c0]:ptr[c1]] - c0, f[ptr[c0]:ptr[c1]]] = v[ptr[c0]:ptr[c1]]
        Bc = (Lc != 0).double()
        nn, Sxy = Br @ Bc.T, Lr @ Lc.T
        Sx, Sy = Lr @ Bc.T, Br @ Lc.T
        Sxx, Syy = (Lr * Lr) @ Bc.T, Br @ (Lc * Lc).T
        del Lc, Bc
        num = nn * Sxy - Sx * Sy
        den = torch.sqrt(((nn * Sxx - Sx * Sx) * (nn * Syy - Sy * Sy))
                         .clamp(min=0.0))
        c = torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)
        c = c * (nn - 1.0) / (nn - 1.0 + shrinkage)
        out[:, c0:c1] = torch.where(nn < 2, 0.0, c)
    out[torch.arange(rows.numel(), device=dev), rows] = -math.inf
    vals, ids = torch.sort(out, dim=1, descending=True, stable=True)
    return ids[:, :k + 1].cpu().numpy(), vals[:, :k + 1].cpu().numpy()


def check_rating_knn(model, train, test, label):
    """256 sampled rows of the rating ItemKNN's stored neighbours held to
    ``pearson_rows_f64`` (values within 1e-6, ids equal outside near-ties
    of 1e-6), and ``KNN_PAIRS`` sampled test pairs to the JAX package's
    per-pair loop recomputed in float64 on the host from the stored
    neighbours (1e-5)."""
    dev = model.tables_device()
    rows = torch.from_numpy(np.sort(np.random.default_rng(20).choice(
        train.num_items, KNN_ROWS, replace=False))).to(dev)
    t0 = time.perf_counter()
    if model.is_topk:
        ids, vals = model.nbr_ids[rows], model.nbr_vals[rows]
    else:                                 # dense storage: the rows' top-k
        c = model.corr[rows].clone()
        c[torch.arange(rows.numel(), device=dev), rows] = -math.inf
        vals, ids = torch.sort(c, dim=1, descending=True, stable=True)
        k = model._k_store(train.num_items)
        ids, vals = ids[:, :k], vals[:, :k]
    ref_ids, ref_vals = pearson_rows_f64(train, rows, ids.shape[1],
                                         float(model.alpha))
    err, bad = topk_agreement(ids.cpu().numpy(), vals.cpu().numpy(),
                              ref_ids, ref_vals, gap=KNN_TOL)
    log(f"rating {label}: {KNN_ROWS} sampled rows of the {ids.shape[1]} "
        f"stored neighbours against Pearson recomputed in float64 on the "
        f"card: max value error {err:.3e} (tol {KNN_TOL}), ids differing "
        f"outside near-ties {bad}; {time.perf_counter() - t0:.1f} s")
    if err > KNN_TOL or bad:
        raise AssertionError(f"rating {label}: the Pearson top-k disagrees "
                             "with float64")
    pick = np.random.default_rng(19).choice(len(test), KNN_PAIRS,
                                            replace=False)
    got = model.predict_batch(test.users[pick], test.items[pick])
    want = rating_knn_reference(model, test.users[pick], test.items[pick])
    err = float(np.abs(got - want).max())
    log(f"rating {label}: {KNN_PAIRS} sampled test pairs against the "
        f"per-pair loop in float64 on the host: max error {err:.3e} "
        f"(tol 1e-5)")
    if err > 1e-5:
        raise AssertionError(f"rating {label} disagrees with the per-pair "
                             "loop")


def phase_rating_knn_path(dev, train, test):
    """UserItemBaseline, then ItemKNN (Pearson, k=40) with the default
    shrinkage 0 and with shrinkage 100, for rating prediction through the
    registry at this shape (17,770 items, past DENSE_NMAX: the streaming
    rating top-k on int8 levels, 128 neighbours stored a row): build,
    then predict every test pair on the card through the rating
    evaluation, and ``check_rating_knn``: at shrinkage 0 an item's 128
    stored neighbours are mostly items that 2 or 3 users rated in
    perfect agreement (Pearson 1), at 100 mostly popular items, whose
    sums cancel in float32. The RMSEs are reported, not held to the
    baseline's: on these synthetic ratings neither ItemKNN beats
    UserItemBaseline, in the JAX package as in the port
    (``exp_torch_knn_rmse.py``, PERF.md §6). Returns the RMSEs by
    label."""
    from mymedialite_tpu_torch.eval.rating import evaluate_ratings
    from mymedialite_tpu_torch.models.registry import create_rating_predictor

    out = {}
    for label, name, opts in (
            ("UserItemBaseline", "UserItemBaseline", ""),
            ("ItemKNN", "ItemKNN", "k=40 correlation=Pearson"),
            ("ItemKNN shrinkage 100", "ItemKNN",
             "k=40 correlation=Pearson alpha=100")):
        model = create_rating_predictor(name, f"{opts} device={dev.type}")
        model.ratings = train
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with counted_path({}):
            t0 = time.perf_counter()
            model.train()
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            res = evaluate_ratings(model, test, train)
            eval_s = time.perf_counter() - t0
        log(f"rating {label}: train {build_s:.2f} s, {len(test)} test pairs "
            f"predicted and evaluated on the card in {eval_s:.2f} s "
            f"({len(test) / eval_s:.4g} pairs/s): {res}; peak device "
            f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if not math.isfinite(res["RMSE"]):
            raise AssertionError(f"rating {label}: RMSE not finite")
        out[label] = res["RMSE"]
        if name == "ItemKNN":
            check_rating_knn(model, train, test, label)
        del model
    log("rating RMSE: " + ", ".join(f"{k} {v:.5f}" for k, v in out.items()))
    return out


def write_genres(path, num_items: int, seed: int = 18):
    """1-3 of 18 genres per item, one ``item<TAB>genre`` line each."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for item in range(num_items):
            for g in rng.choice(18, rng.integers(1, 4), replace=False):
                f.write(f"{item}\t{g}\n")


def phase_knn_cli(dev, tmp, rating_files, item_files, num_items=3706):
    """The rating CLI with UserItemBaseline and UserKNN (Pearson, dense:
    6,040 users), whose RMSE must beat the baseline's, and the item CLI
    with ItemAttributeKNN on a synthetic genre file (1-3 of 18 genres per
    item), each with save -> load, at phase 16's size; no kernel runs."""
    from mymedialite_tpu_torch.cli import item_recommendation, rating_prediction

    attr_path = os.path.join(tmp, "item_genres.tsv")
    write_genres(attr_path, num_items)
    rmse = {}
    for name in ("UserItemBaseline", "UserKNN"):
        argv = rating_files + ["--recommender", name,
                               "--recommender-options", f"device={dev.type}"]
        with counted_path({}):
            t0 = time.perf_counter()
            text = save_load_same(rating_prediction.main, argv,
                                  os.path.join(tmp, f"{name}.model"))
        rmse[name] = result_value(text, "RMSE")
        log(f"rating CLI {name}: train, save, load "
            f"{time.perf_counter() - t0:.1f} s")
        if not (math.isfinite(rmse[name]) and 0 < rmse[name] < 2):
            raise AssertionError(f"bad CLI result ({name}): RMSE "
                                 f"{rmse[name]}")
    if not rmse["UserKNN"] < rmse["UserItemBaseline"]:
        raise AssertionError(f"UserKNN RMSE {rmse['UserKNN']} does not beat "
                             f"UserItemBaseline's {rmse['UserItemBaseline']}")
    argv = item_files + ["--recommender", "ItemAttributeKNN",
                         "--item-attributes", attr_path,
                         "--recommender-options", f"device={dev.type}"]
    with counted_path({}):
        t0 = time.perf_counter()
        text = save_load_same(item_recommendation.main, argv,
                              os.path.join(tmp, "itemattrknn.model"))
    log(f"item CLI ItemAttributeKNN: train, save, load "
        f"{time.perf_counter() - t0:.1f} s")
    if "item attributes" not in text:
        raise AssertionError("the statistics block lacks the attributes")
    auc = result_value(text, "AUC")
    if not (math.isfinite(auc) and 0 <= auc <= 1):
        raise AssertionError(f"bad item CLI result: AUC {auc}")


# ---------------------------------------------------------------------------
# the XLA routes: epochs of plain PyTorch, no kernel of csrc/ on them
# ---------------------------------------------------------------------------

# the prefix of groups or batches held to the CPU's float64 run
GROUP_PREFIX = 8
BATCH_PREFIX = 8
AUC_USERS = 1024
# the blocked MF prefix's batch: at the default 131,072 the trajectory
# parts from float64 at float32's rounding alone (popular items' biases
# overshoot); at 16,384 float32 keeps within 2.1e-6 of float64 over a
# whole epoch (exp_torch_blocked_prefix.py)
PREFIX_BATCH = 16_384


def host_copy(tables: dict, dtype=torch.float64) -> dict:
    """Copies of a dict of tensors on the CPU, in ``dtype``."""
    return {k: v.detach().to("cpu", dtype).clone() for k, v in tables.items()}


def prefix_check(card: dict, host32: dict, host64: dict, what: str):
    """The card's tables after a prefix of an epoch against the same
    function on the CPU in float64, within ``KERNEL_TOL``. Returns (the
    card's distance, the CPU float32 run's: float32 rounding's own share,
    for the log); raises on non-finite tables or a distance past the
    tolerance."""
    for k, t in card.items():
        if not torch.isfinite(t).all():
            raise AssertionError(f"{what}: non-finite {k}")

    def dist(tables):
        return max((tables[k].double().cpu() - host64[k]).abs().max().item()
                   for k in host64)
    err, f32 = dist(card), dist(host32)
    if not err <= KERNEL_TOL:
        raise AssertionError(
            f"{what}: the card is {err} from the CPU's float64 run, past "
            f"{KERNEL_TOL} (the CPU float32 run: {f32})")
    return err, f32


def prefix_line(label, err, f32):
    return (f"{label} on the card vs the CPU in float64: max_abs_err "
            f"{err:.3e} (tol {KERNEL_TOL}; the CPU float32 run {f32:.3e})")


def profiled_busy(fn):
    """Run ``fn()`` once under torch.profiler: (device ms, wall ms, device
    operations), the device ms summed over the kernels, copies and sets
    the profiler saw (one stream, so they do not overlap), the operations
    counted one per launch; the wall clock includes the profiler's own
    cost."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    events = [ev for ev in prof.key_averages() if ev.self_device_time_total]
    busy = sum(ev.self_device_time_total for ev in events)
    return busy / 1e3, wall, sum(ev.count for ev in events)


def phase_svdpp_grouped(dev, train, test):
    """SVDPlusPlus at k=20 (learn rate 0.003) for 3 epochs through the
    registry on data whose Q and Y pass the kernel's table budget, so the
    grouped epoch (ops/svdpp.py) trains it; transductive on the test
    pairs. No kernel may launch. The first ``GROUP_PREFIX`` groups of one
    more epoch on the card are held to the same function on the CPU in
    float64 from the same tables (``prefix_check``); RMSE against the
    global average; one epoch under the profiler for the device's busy
    share."""
    from mymedialite_tpu_torch.eval.rating import evaluate_ratings
    from mymedialite_tpu_torch.models import svdpp as svdpp_module
    from mymedialite_tpu_torch.models.registry import create_rating_predictor
    from mymedialite_tpu_torch.ops.svdpp import svdpp_epoch_grouped

    model = create_rating_predictor(
        "SVDPlusPlus",
        f"num_factors=20 num_iter=3 learn_rate=0.003 device={dev.type}")
    model.ratings = train
    model.additional_feedback = (test.users, test.items)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with timed_training((svdpp_module, "prepare_groups"),
                        (svdpp_module, "svdpp_epoch_grouped")) as timings, \
            counted_path({}):
        t0 = time.perf_counter()
        model.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    if model.route() != "grouped":
        raise AssertionError("SVD++ did not take the grouped epoch")
    groups = model._groups
    epoch_ms = float(np.mean(timings["epoch_ms"]))
    log(f"svdpp grouped train: {train_s:.2f} s; layout "
        f"{timings['plan_s'][0]:.2f} s ({groups.ngroups} groups of "
        f"{groups.group_users} users, {groups.num_chunks} chunks of up to "
        f"{groups.chunk} ratings, largest group {groups.length}); no kernel "
        f"launched; epochs "
        f"{', '.join(f'{t:.1f}' for t in timings['epoch_ms'])} ms; "
        f"{len(train) / (epoch_ms / 1e3):.4g} rating updates/s; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    res = evaluate_ratings(model, test, train)
    baseline = global_average_rmse(train, test)
    log(f"svdpp grouped eval: {res}; global-average RMSE {baseline:.5f}")
    if not (math.isfinite(res["RMSE"]) and res["RMSE"] < baseline):
        raise AssertionError("grouped SVD++ RMSE does not beat the global "
                             "average")

    # the first groups of one more epoch: the card against the CPU in
    # float64, from the same tables
    card = {k: v.clone() for k, v in model.params.items()}
    hosts = (host_copy(card, torch.float32), host_copy(card))
    kw = dict(loss=0, sigmoid=False, use_p=True,
              group_ids=range(min(GROUP_PREFIX, groups.ngroups)))
    hp = model._grouped_hp()
    svdpp_epoch_grouped(card, groups, model._edges[2], hp, model._regs, **kw)
    host_groups = groups.to("cpu")
    for host in hosts:
        dtype = host["y"].dtype
        svdpp_epoch_grouped(host, host_groups,
                            model._edges[2].to("cpu", dtype), hp,
                            host_copy(model._regs, dtype), **kw)
    err, f32 = prefix_check(card, *hosts, "grouped SVD++ prefix")
    busy, wall, ops = profiled_busy(model.iterate)
    log(prefix_line(f"svdpp grouped: first {GROUP_PREFIX} groups", err, f32)
        + f"; one epoch under torch.profiler: {ops} device operations "
        f"({ops / groups.num_chunks:.1f} a chunk), device busy {busy:.1f} ms "
        f"of {wall:.1f} ms wall under the profiler ({100 * busy / wall:.1f}%),"
        f" {100 * busy / epoch_ms:.1f}% of the unprofiled epoch's "
        f"{epoch_ms:.1f} ms")
    return dict(epoch_ms=epoch_ms, busy_share=busy / epoch_ms)


def phase_mf_blocked(dev, train, test, label, opts="", repeat=False):
    """BiasedMatrixFactorization at k=40 for 3 epochs (``opts`` added)
    through the registry where it takes the blocked epoch (ops/sgd.py):
    frequency regularization, or a catalog past the tiled schedule's
    slabs. No kernel may launch. RMSE against the global average. With
    ``repeat`` a second model of the same seed trains on the same layout
    (``prepare_blocked_data``'s host arrays, computed once) and must give
    the same tables and RMSE bit for bit (the epoch's scatter sums in a
    fixed order). The same cell at a batch of ``PREFIX_BATCH`` (see
    there): the first ``GROUP_PREFIX`` user groups of its epoch 1 from
    its init tables on the card, held to the CPU's float64 run from the
    same tables and batch orders (``prefix_check``)."""
    from mymedialite_tpu_torch.eval.rating import evaluate_ratings
    from mymedialite_tpu_torch.models.registry import create_rating_predictor
    from mymedialite_tpu_torch.ops import sgd

    model = create_rating_predictor(
        "BiasedMatrixFactorization",
        f"num_factors=40 num_iter=3 {opts} device={dev.type}")
    model.ratings = train
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with timed_training((sgd, "prepare_blocked_data"),
                        (sgd, "sgd_epoch_blocked")) as timings, \
            counted_path({"exact_add": SOME}) as counted, \
            recorded_exact_add() as calls:
        t0 = time.perf_counter()
        model.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    if model._route() != "minibatch" or model._blocked is None:
        raise AssertionError(f"{label}: MF did not take the blocked epoch")
    data, meta, freq = model._blocked
    batches = sum(sgd.real_batches(c, meta["batch"]) for c in data["count"])
    epoch_ms = float(np.mean(timings["epoch_ms"]))
    log(f"mf blocked {label} train: {train_s:.2f} s; layout "
        f"{timings['plan_s'][0]:.2f} s ({meta['ngroups']} groups of "
        f"{meta['group_users']} users, {batches} batches of up to "
        f"{meta['batch']}); exact_add {counted['exact_add']} launches, no "
        f"epoch kernel; epochs "
        f"{', '.join(f'{t:.1f}' for t in timings['epoch_ms'])} ms; "
        f"{len(train) / (epoch_ms / 1e3):.4g} rating updates/s; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    res = evaluate_ratings(model, test, train)
    baseline = global_average_rmse(train, test)
    log(f"mf blocked {label} eval: {res}; global-average RMSE "
        f"{baseline:.5f}")
    rmse = res["RMSE"]
    if not (math.isfinite(res["RMSE"]) and res["RMSE"] < baseline):
        raise AssertionError(f"{label}: blocked MF RMSE does not beat the "
                             "global average")
    repeat_s = 0.0
    if repeat:
        t0 = time.perf_counter()
        twin = create_rating_predictor(
            "BiasedMatrixFactorization",
            f"num_factors=40 num_iter=3 {opts} device={dev.type}")
        twin.ratings = train
        layout = model._blocked[:2]
        real = sgd.prepare_blocked_data
        sgd.prepare_blocked_data = lambda *a, **kw: layout
        try:
            with counted_path({"exact_add": SOME}):
                twin.train()
        finally:
            sgd.prepare_blocked_data = real
        again = evaluate_ratings(twin, test, train)
        torch.cuda.synchronize()
        repeat_s = time.perf_counter() - t0
        same = (torch.equal(twin._W_ext, model._W_ext)
                and torch.equal(twin._H_ext, model._H_ext)
                and twin.global_bias == model.global_bias)
        log(f"mf blocked {label}, the same seed again: {again}; tables "
            f"{'equal' if same else 'DIFFERENT'} bit for bit; "
            f"{repeat_s:.2f} s")
        if not same or dict(again) != dict(res):
            raise AssertionError(f"{label}: two blocked MF runs of one seed "
                                 "differ")
        del twin

    del model
    model = create_rating_predictor(
        "BiasedMatrixFactorization",
        f"num_factors=40 {opts} batch_size={PREFIX_BATCH} device={dev.type}")
    model.ratings = train
    model.init_model()
    data, meta, freq = model._blocked
    card = dict(W=model._W_ext.clone(), H=model._H_ext.clone())
    hosts = (host_copy(card, torch.float32), host_copy(card))
    orders = model._batch_orders(meta["ngroups"],
                                 meta["l_pad"] // meta["batch"])
    args = (model.num_factors, model.current_learnrate, model.reg_u,
            model.reg_i, model.bias_learn_rate, model.bias_reg, True, True,
            True)
    hp = (model.global_bias, model.min_rating, model._rating_range())
    kw = dict(meta=meta, loss=model.loss_id, biased=True,
              groups=range(min(GROUP_PREFIX, meta["ngroups"])))
    sgd.sgd_epoch_blocked(card["W"], card["H"], data, orders, hp,
                          sgd.column_rates(*args, device=dev), freq, **kw)
    host_data = {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
                 for k, v in data.items()}
    for host in hosts:
        dtype = host["W"].dtype
        host_freq = None if freq is None else tuple(
            f.to("cpu", dtype) for f in freq)
        sgd.sgd_epoch_blocked(host["W"], host["H"], host_data, orders, hp,
                              sgd.column_rates(*args), host_freq, **kw)
    err, f32 = prefix_check(card, *hosts, f"{label} blocked MF prefix")
    log(prefix_line(f"mf blocked {label}: first {GROUP_PREFIX} groups of "
                    f"epoch 1 at a batch of {meta['batch']}", err, f32)
        + f"; largest entries |W| "
        f"{card['W'].abs().max().item():.4g}, |H| "
        f"{card['H'].abs().max().item():.4g}")
    return dict(epoch_ms=epoch_ms, rmse=rmse, repeat_s=repeat_s,
                exact_add_launches=counted["exact_add"], exact_add_calls=calls)


def phase_bpr_minibatch(dev, train, test, label):
    """BPRMF at k=40 for 3 epochs through the registry on a catalog past
    the tiled schedule's slabs, so the minibatch epoch (ops/bpr.py) trains
    it. No kernel may launch. ``BATCH_PREFIX`` batches of sampled triples
    applied on the card and on the CPU in float64 from the same tables
    and triples (``prefix_check``); AUC of ``AUC_USERS`` seeded test users, scored in the
    ranking evaluation's blocks of 128 users, above 0.5."""
    from mymedialite_tpu_torch.data.synthetic import posonly_from_ratings
    from mymedialite_tpu_torch.eval.ranking import evaluate_items
    from mymedialite_tpu_torch.models.registry import create_item_recommender
    from mymedialite_tpu_torch.ops import bpr as bpr_ops

    train, test = posonly_from_ratings(train), posonly_from_ratings(test)
    model = create_item_recommender(
        "BPRMF", f"num_factors=40 num_iter=3 device={dev.type}")
    model.feedback = train
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with timed_training((bpr_ops, "make_sampler_data"),
                        (bpr_ops, "bpr_epoch")) as timings, \
            counted_path({"exact_add": SOME}) as counted, \
            recorded_exact_add() as calls:
        t0 = time.perf_counter()
        model.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
    if model._sampler is None:
        raise AssertionError(f"{label}: BPRMF did not take the minibatch "
                             "epoch")
    sampler, meta, pop = model._sampler
    batch, nb = bpr_ops.epoch_batches(meta["num_events"], model.batch_size)
    epoch_ms = float(np.mean(timings["epoch_ms"]))
    log(f"bpr minibatch {label} train: {train_s:.2f} s; sampler "
        f"{timings['plan_s'][0]:.2f} s ({nb} batches of {batch} triples); "
        f"exact_add {counted['exact_add']} launches, no epoch kernel; epochs "
        f"{', '.join(f'{t:.1f}' for t in timings['epoch_ms'])} ms; "
        f"{meta['num_events'] / (epoch_ms / 1e3):.4g} triples/s; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    card = {k: v.clone() for k, v in model.params.items()}
    hosts = (host_copy(card, torch.float32), host_copy(card))
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    hp = model._hp()
    for _ in range(BATCH_PREFIX):
        u, i, j, w = bpr_ops.sample_triples(gen, sampler, meta, batch,
                                            model._regime())
        bpr_ops.bpr_step(card, u, i, j, w, hp, update_j=True)
        for host in hosts:
            bpr_ops.bpr_step(host, u.cpu(), i.cpu(), j.cpu(), w.cpu(), hp,
                             update_j=True)
    err, f32 = prefix_check(card, *hosts, f"{label} BPR minibatch prefix")
    rng = np.random.default_rng(9)
    users = np.sort(rng.choice(test.all_users, AUC_USERS, replace=False))
    t0 = time.perf_counter()
    res = evaluate_items(model, test, train, test_users=users,
                         batch_size=128)
    log(prefix_line(f"bpr minibatch {label}: first {BATCH_PREFIX} batches",
                    err, f32) + f"; ranking eval of {res['num_users']} users: {res} "
        f"({time.perf_counter() - t0:.2f} s)")
    if not (math.isfinite(res["AUC"]) and res["AUC"] > 0.5):
        raise AssertionError(f"{label}: BPRMF AUC {res['AUC']} <= 0.5")
    if calls:                            # none on the CPU
        exact_add_checks(f"bpr minibatch {label}", calls)
    return dict(epoch_ms=epoch_ms, auc=res["AUC"])


# ---------------------------------------------------------------------------
# exact_add (csrc/exact_add.cu), the plain routes' scatter
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def recorded_exact_add(limit: int = 2):
    """Copies of the inputs (table, ids, delta) of the first exact_add
    kernel call of each of up to ``limit`` table shapes inside the block,
    as the path gives them."""
    from mymedialite_tpu_torch.ops import sgd
    real = sgd._launch_exact_add
    calls = {}

    def record(table, ids, delta):
        key = tuple(table.shape)
        if key not in calls and len(calls) < limit:
            calls[key] = (table.clone(), ids.clone(), delta.clone())
        return real(table, ids, delta)
    sgd._launch_exact_add = record
    try:
        yield calls
    finally:
        sgd._launch_exact_add = real


def exact_add_vs_plain(table, ids, delta, reps: int = 20):
    """exact_add's kernel against its plain version (the torch
    composition, ``exact_add_reference``) on the same inputs, bit for bit
    (raises where they differ); then the kernel's, the composition's and
    one ``index_add_``'s ms (CUDA events, the mean of ``reps`` calls) and
    the bound: the ids and the deltas read once, each touched row read
    and written once."""
    from mymedialite_tpu_torch.ops import sgd
    got = sgd.exact_add(table.clone(), ids, delta)
    want = sgd.exact_add_reference(table.clone(), ids, delta)
    torch.cuda.synchronize()
    if not torch.equal(got.contiguous().view(torch.int32),
                       want.contiguous().view(torch.int32)):
        raise AssertionError(f"exact_add on {tuple(delta.shape)}: the kernel "
                             "differs from the composition")
    times = []
    for fn in (sgd.exact_add, sgd.exact_add_reference,
               lambda t, i, d: t.index_add_(0, i, d)):
        t = table.clone()
        fn(t, ids, delta)
        start, end = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(t, ids, delta)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    row = table[0].numel() * table.element_size()
    rows = torch.unique(ids).numel()
    b_ms, b_by = bound_ms(ids.numel() * ids.element_size()
                          + delta.numel() * delta.element_size()
                          + 2 * rows * row, delta.numel())
    return dict(ms=times[0], plain_ms=times[1], library_ms=times[2],
                bound_ms=b_ms, bound_by=b_by, max_abs_err=0.0, rows=rows)


def exact_add_line(what, table, ids, delta, r) -> str:
    return (f"exact_add {what}: {ids.numel()} slots x {delta[0].numel()} on "
            f"{r['rows']} rows of {tuple(table.shape)}: kernel equal to the "
            f"composition bit for bit; kernel {r['ms']:.4f} ms, composition "
            f"{r['plain_ms']:.4f} ms ("
            f"{'faster' if r['ms'] < r['plain_ms'] else 'SLOWER'}), "
            f"index_add_ {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} "
            f"ms ({r['bound_by']})")


def exact_add_checks(label, calls) -> dict:
    """``exact_add_vs_plain`` on each recorded main-path call; logs each
    and returns the result of the call with the most slots."""
    out = None
    for table, ids, delta in calls.values():
        r = exact_add_vs_plain(table, ids, delta)
        log(exact_add_line(label, table, ids, delta, r))
        if out is None or ids.numel() > out[0]:
            out = (ids.numel(), r)
    if out is None:
        raise AssertionError(f"{label}: no exact_add call recorded")
    return out[1]


def phase_exact_add_check(dev, blocked):
    """exact_add's kernel against the composition bit for bit: on the
    Netflix-shaped blocked MF main path's recorded calls (phase 20; the
    kernels line's numbers are its largest), on 131,072 slots on 64 rows
    at width 42 (int32 and int64 ids, the rows 1-D, float64), and on that
    batch with an inf and with a NaN delta (every touched row non-finite
    in both)."""
    main = exact_add_checks("blocked MF main path", blocked["exact_add_calls"])
    gen = torch.Generator(device=dev).manual_seed(4)
    ids = torch.randint(0, 64, (131_072,), device=dev, generator=gen,
                        dtype=torch.int32)
    delta = torch.randn((131_072, 42), device=dev, generator=gen)
    table = torch.randn((64, 42), device=dev, generator=gen)
    cases = [("131,072 slots on 64 rows", table, ids, delta),
             ("int64 ids", table, ids.long(), delta),
             ("1-D rows", table[:, 0].contiguous(), ids,
              delta[:, 0].contiguous()),
             ("float64", table.double(), ids, delta.double())]
    for bad in (math.inf, math.nan):
        d = delta.clone()
        d[17, 3] = bad
        cases.append((f"a {bad} delta", table, ids, d))
    for what, t, i, d in cases:
        log(exact_add_line(what, t, i, d, exact_add_vs_plain(t, i, d)))
    return dict(main, launches=blocked["exact_add_launches"])


def finite_lines(text, key, count):
    """The last ``count`` lines of ``text`` that hold ``key``, each value
    finite."""
    lines = [ln for ln in text.strip().splitlines() if f"{key} " in ln]
    if len(lines) < count:
        raise AssertionError(f"expected {count} lines with {key}:\n{text}")
    for ln in lines[-count:]:
        tokens = ln.split()
        value = float(tokens[tokens.index(key) + 1])
        if not math.isfinite(value):
            raise AssertionError(f"non-finite {key}: {ln}")
    return lines[-count:]


def phase_cv_cli(dev, tmp, files, item_files, num_items=3706):
    """The protocols of this slice through the CLIs at phase 16's size:
    the rating CLI with --cross-validation=5 (BiasedMatrixFactorization:
    the SGD kernel once per epoch per fold), --cross-validation=3
    --find-iter=1 --max-iter=3 (three lines), --search-hp with
    UserItemBaseline, and GSVDPlusPlus on a synthetic genre file (save ->
    load, the same line); the item CLI with --cross-validation=5 (BPRMF:
    the BPR kernel once per epoch per fold); rating_based_ranking with
    --cross-validation=5. Each result line parsed and finite."""
    from mymedialite_tpu_torch.cli import (
        item_recommendation, rating_based_ranking, rating_prediction,
    )
    opts = ["--recommender-options",
            f"num_factors=40 num_iter=3 device={dev.type}"]
    t0 = time.perf_counter()
    with counted_path({"sgd_epoch": 15}):
        text = run_cli(rating_prediction.main,
                       files[:2] + ["--cross-validation", "5"] + opts)
    finite_lines(text, "RMSE", 1)
    with counted_path({"sgd_epoch": 9}):
        text = run_cli(rating_prediction.main, files[:2] + [
            "--cross-validation", "3", "--find-iter", "1", "--max-iter", "3",
            "--recommender-options",
            f"num_factors=40 num_iter=1 device={dev.type}"])
    finite_lines(text, "RMSE", 3)
    log(f"rating CLI cross-validation: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with counted_path({}):
        text = run_cli(rating_prediction.main, files + [
            "--recommender", "UserItemBaseline", "--search-hp",
            "--recommender-options", f"device={dev.type}"])
    finite_lines(text, "RMSE", 1)
    log(f"rating CLI --search-hp: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    genres = os.path.join(tmp, "gsvd_genres.tsv")
    write_genres(genres, num_items)
    with counted_path({}):
        text = save_load_same(rating_prediction.main, files + [
            "--recommender", "GSVDPlusPlus", "--item-attributes", genres,
            "--recommender-options",
            f"num_factors=20 num_iter=3 learn_rate=0.003 device={dev.type}"],
            os.path.join(tmp, "gsvd.model"))
    rmse = result_value(text, "RMSE")
    if not (math.isfinite(rmse) and 0 < rmse < 2):
        raise AssertionError(f"bad GSVDPlusPlus result: RMSE {rmse}")
    log(f"rating CLI GSVDPlusPlus: train, save, load "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with counted_path({"bpr_epoch": 15}):
        text = run_cli(item_recommendation.main, item_files[:2] + [
            "--recommender", "BPRMF", "--cross-validation", "5"] + opts)
    finite_lines(text, "AUC", 1)
    with counted_path({"sgd_epoch": 15}):
        text = run_cli(rating_based_ranking.main,
                       files[:2] + ["--cross-validation", "5"] + opts)
    finite_lines(text, "AUC", 1)
    log(f"item and ranking CLI cross-validation: "
        f"{time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 22: the incremental API, the online protocol and fold-in
# ---------------------------------------------------------------------------

ONLINE_EVENTS = 512       # (a): test events of the prequential run
ROW_CHECKS = 16           # (a), (b): rows held step by step to float64
ROW_TOL = 1e-4
FOLDIN_USERS = 256        # (b): users of the fold-in protocols
# (b): users of the incremental protocol (add, evaluate, remove): each
# add and remove rebuilds the COO arrays of 15M ratings and derives their
# CSR views, about 1-2 s of host work a user on the card's host
FOLDIN_INCREMENTAL_USERS = 4
ONLINE_ITEM_USERS = 64    # (c)
PAIRWISE_TOL = 1e-5       # (c): one user's pairwise step against float64
WRMF_ONLINE_USERS = 64    # (d)
SVDPP_CALLS, SVDPP_EVENTS = 1, 64   # (e)
# (f): GroupLens' published ml-100k counts
ML100K = dict(num_users=943, num_items=1682, num_ratings=100_000)
# (f): test events of the online CLIs (of the split's 15,039)
ONLINE_CLI_EVENTS = 4096


def event_subset(test, n: int, seed: int):
    """The first n events of a seeded permutation of ``test``, in index
    order (the online evaluator permutes them again, from the model's
    seed)."""
    order = np.random.default_rng(seed).permutation(len(test))[:n]
    return test.select(np.sort(order))


def row_step_f64(row, other, values, lr_vec, reg_vec, hp, *, biased: bool,
                 loss: int):
    """One full-history gradient step of a fused row in float64 (numpy),
    written apart from ``models/mf.py learn_row``: the per-example error
    of the plain model (raw score) or the biased one (sigmoid; RMSE, MAE
    or logistic gradient), summed over the history, minus L * reg * row,
    times the per-column rates."""
    gb, lo, rng = hp
    score = other @ row
    if biased:
        sig = 1.0 / (1.0 + np.exp(-(score + gb)))
        err = values - (lo + sig * rng)
        g = (err if loss == 2 else
             (np.sign(err) if loss == 1 else err) * sig * (1.0 - sig) * rng)
    else:
        g = values - (score + gb)
    return row + lr_vec * (g @ other - values.size * reg_vec * row)


def row_witness(model, start, other, ids, values, lr_vec, reg_vec, hp,
                learner=None):
    """The largest |card step - float64 step| over a row refresh's
    ``num_iter`` steps, each card step (``learner``, default
    ``mf.learn_row`` with one step) taken from the float64 trajectory's
    state: the float32 rounding of one step, not its growth over the
    trajectory (full-history sums of a popular item's 200k ratings part
    float32 from float64 within a few steps)."""
    from mymedialite_tpu_torch.models.mf import learn_row
    learner = learner or learn_row
    dev = other.device
    idx = torch.from_numpy(np.asarray(ids, dtype=np.int64)).to(dev)
    rows = other[idx.clamp(0, other.shape[0] - 1)]
    vals = torch.from_numpy(np.asarray(values, dtype=np.float32)).to(dev)
    o64 = rows.double().cpu().numpy()
    v64 = vals.double().cpu().numpy()
    lr64, reg64 = lr_vec.double().cpu().numpy(), reg_vec.double().cpu().numpy()
    x = start.double().cpu().numpy()
    worst, scale = 0.0, 1.0
    for _ in range(model.num_iter):
        nxt = row_step_f64(x, o64, v64, scale * lr64, reg64, hp,
                           biased=model.BIASED, loss=model.loss_id)
        with torch.no_grad():
            card = learner(torch.from_numpy(x).float().to(dev), rows, vals,
                           (scale * lr_vec).float(), reg_vec, *hp,
                           num_iter=1, decay=1.0, biased=model.BIASED,
                           loss=model.loss_id)
        worst = max(worst, float(np.abs(card.double().cpu().numpy()
                                        - nxt).max()))
        x, scale = nxt, scale * model.learn_rate_decay
    return worst


def model_row_witness(model, side: str, row_id: int, learner=None):
    """``row_witness`` of one of the model's refreshes from a fresh start
    row: the row's own history of n ratings against the other side's
    table, at the model's rates, the learn rate lowered to 0.5 / n where
    that is smaller (the rule by which (a) picks its protocol's rate), so
    that each trajectory is stable and its steps still move the row by
    far more than ROW_TOL."""
    W, H = model.W_ext, model.H_ext
    if side == "user":
        other, (ids, vals), reg = H, model._rated_by_user(row_id), model.reg_u
    else:
        other, (ids, vals), reg = W, model._rated_by_item(row_id), model.reg_i
    frozen, lr_vec, reg_vec, hp = model._row_args(side, reg)
    lr_vec = lr_vec * min(1.0, 0.5 / max(len(ids), 1) / model.learn_rate)
    start = model._fresh_row(frozen)
    return row_witness(model, start, other, ids, vals, lr_vec, reg_vec, hp,
                       learner), len(ids)


def returns_input(row, *args, **kwargs):
    """The witnesses' control: a learner that takes no step."""
    return row


@contextlib.contextmanager
def timed_calls(owner, name: str):
    """Inside the block every call of ``owner.name`` is timed on the host
    clock with the card synchronised on both sides; yields the list of
    seconds. (The synchronisation costs the run the overlap of host and
    device work between calls.)"""
    own = name in vars(owner)      # else a method of the object's class
    real = getattr(owner, name)
    seconds = []

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real(*a, **kw)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t)
        return out
    setattr(owner, name, timed)
    try:
        yield seconds
    finally:
        if own:
            setattr(owner, name, real)
        else:
            delattr(owner, name)


def ms_line(seconds) -> str:
    ms = np.asarray(seconds, dtype=np.float64) * 1e3
    if ms.size == 0:
        return "none"
    return (f"{ms.size} calls, mean {ms.mean():.3f} ms, p99 "
            f"{np.percentile(ms, 99):.3f} ms")


def phase_online_mf(dev, train, test):
    """(a) BiasedMatrixFactorization (k=40, 3 epochs) through the registry,
    then the prequential protocol over ONLINE_EVENTS seeded test events in
    buffered mode with chunked predictions, each event refreshing its
    user and item rows with 30 steps (the default num_iter) at a learn
    rate at which the longest history is stable (at the default rate the
    most-rated item's refresh diverges, a pinned fault that must show):
    RMSE/MAE, events/s, ms per refresh by side, chunks; ROW_CHECKS
    refreshes, among them the most-rated item's, held step by step to
    float64 at the model's rate (``model_row_witness``); then
    one iterate() on the grown ratings through kernel 1. Returns the
    model, at its default learn rate again, and the protocol's rate."""
    from mymedialite_tpu_torch.eval.online import evaluate_ratings_online
    from mymedialite_tpu_torch.models.registry import create_rating_predictor

    model = create_rating_predictor(
        "BiasedMatrixFactorization",
        f"num_factors=40 num_iter=3 device={dev.type}")
    model.ratings = train
    with counted_path({"sgd_epoch": 3}):
        model.train()
    model.num_iter = 30
    # the pinned fault (ROADMAP §C): a refresh sums the gradient over the
    # whole history before each step, so a row of n ratings diverges
    # once n * learn_rate * reg passes 2; at the default rate the
    # most-rated item's refresh does, as in the JAX package
    counts = np.bincount(train.items, minlength=train.num_items)
    top = int(counts.argmax())
    frozen, lr_vec, reg_vec, hp = model._row_args("item", model.reg_i)
    ids, vals = model._rated_by_item(top)
    with torch.no_grad(), counted_path({}):
        row = model._learn(model._fresh_row(frozen), model.W_ext, ids, vals,
                           lr_vec, reg_vec, hp)
    x = counts * model.learn_rate * model.reg_i
    finite = bool(torch.isfinite(row).all())
    log(f"refresh at the default learn rate {model.learn_rate}: the "
        f"most-rated item ({counts.max()} ratings, n * learn_rate * reg "
        f"{x.max():.3g}) gives a {'finite' if finite else 'non-finite'} "
        f"row; {int((x > 2).sum())} items pass 2")
    # past 25 the regularization alone grows the row by 24x a step: it
    # overflows float32 within 30 steps
    if x.max() > 25 and finite:
        raise AssertionError("the pinned divergence of long histories "
                             "did not show")
    # the protocol at a rate at which every history of this data is
    # stable: n * learn_rate <= 0.5 for the longest
    longest = max(int(counts.max()),
                  int(np.bincount(train.users).max()))
    default_lr = model.learn_rate
    online_lr = model.learn_rate = min(default_lr, 0.5 / longest)
    log(f"online learn rate {online_lr:.4g} (0.5 / {longest}, the "
        "longest history)")
    events = event_subset(test, ONLINE_EVENTS, seed=22)
    with timed_calls(model, "retrain_user") as user_s, \
            timed_calls(model, "retrain_item") as item_s, \
            timed_calls(model, "predict_batch") as predict_s, \
            counted_path({}):
        t0 = time.perf_counter()
        res = evaluate_ratings_online(model, events)
        online_s = time.perf_counter() - t0
    log(f"online BiasedMF, {len(events)} events (buffered, chunked): {res}; "
        f"{online_s:.2f} s, {len(events) / online_s:.4g} events/s; "
        f"{len(predict_s)} prediction chunks; user refresh "
        f"{ms_line(user_s)}; item refresh {ms_line(item_s)} "
        f"({model.num_iter} steps; each call timed with the card "
        "synchronised around it)")
    for k in ("RMSE", "MAE"):
        if not (math.isfinite(res[k]) and 0 < res[k] < 2):
            raise AssertionError(f"online BiasedMF {k} {res[k]}")
    if len(model.ratings) != len(train) + len(events):
        raise AssertionError("the online events did not fold into the data")
    model.learn_rate = default_lr

    rng = np.random.default_rng(23)
    counts = np.bincount(model.ratings.items,
                         minlength=model.ratings.num_items)
    picks = [("item", int(counts.argmax()))]
    for k in rng.choice(len(events), ROW_CHECKS - 1, replace=False):
        picks.append(("user", int(events.users[k])) if k % 2 else
                     ("item", int(events.items[k])))
    t0 = time.perf_counter()
    worst, control, lowered = 0.0, math.inf, 0
    for side, row_id in picks:
        err, n = model_row_witness(model, side, row_id)
        still, _ = model_row_witness(model, side, row_id,
                                     learner=returns_input)
        worst, control = max(worst, err), min(control, still)
        lowered += 0.5 / n < default_lr
    log(f"online refresh rows, {len(picks)} (the most-rated item's "
        f"{counts.max()} ratings among them), each step from the float64 "
        f"trajectory: max_abs_err {worst:.3e} (tol {ROW_TOL}); "
        f"{len(picks) - lowered} at the default learn rate {default_lr}, "
        f"{lowered} at 0.5 / n; a learner that takes no step reads at "
        f"least {control:.3e} on every row; "
        f"{time.perf_counter() - t0:.1f} s")
    if not worst <= ROW_TOL:
        raise AssertionError(f"refresh rows off float64 by {worst:.3e}")
    if not control > ROW_TOL:
        raise AssertionError("the row witness passes a learner that takes "
                             f"no step ({control:.3e})")

    with counted_path({"sgd_epoch": 1}) as counted:
        t0 = time.perf_counter()
        model.iterate()
        torch.cuda.synchronize()
        iterate_s = time.perf_counter() - t0
    if model._plan.n_ratings != len(train) + len(events):
        raise AssertionError(f"the plan holds {model._plan.n_ratings} "
                             "ratings, not the grown data")
    log(f"iterate() after the online run: {iterate_s:.2f} s, sgd_epoch "
        f"launches {counted['sgd_epoch']}, plan of "
        f"{model._plan.n_ratings} ratings ({len(train)} + {len(events)})")
    return model, online_lr


def foldin_split(test, users, seed: int):
    """The test ratings of ``users``, split 50/50 by a seeded draw into
    the update and the evaluation part."""
    idx = np.nonzero(np.isin(test.users, users))[0]
    half = np.random.default_rng(seed).random(idx.size) < 0.5
    return test.select(idx[half]), test.select(idx[~half])


def phase_foldin(dev, model, online_lr, test):
    """(b) the fold-in protocols on (a)'s model: true fold-in over
    FOLDIN_USERS seeded test users at the model's learn rate, the
    incremental protocol (add, evaluate, remove) over the first
    FOLDIN_INCREMENTAL_USERS of them at (a)'s ``online_lr`` (it refreshes
    the rows of the items they rated, popular ones among them); RMSEs and
    seconds; ROW_CHECKS fold-in rows held step by step to float64."""
    from mymedialite_tpu_torch.eval.foldin import (
        evaluate_fold_in, evaluate_fold_in_incremental_training,
    )
    rng = np.random.default_rng(24)
    users = np.sort(rng.choice(np.unique(test.users), FOLDIN_USERS,
                               replace=False))
    update, held = foldin_split(test, users, seed=25)
    n_before = len(model.ratings)
    default_lr = model.learn_rate
    with counted_path({}):
        t0 = time.perf_counter()
        res = evaluate_fold_in(model, update, held)
        foldin_s = time.perf_counter() - t0
        few = users[:FOLDIN_INCREMENTAL_USERS]
        upd_few, held_few = (d.select(np.nonzero(np.isin(d.users, few))[0])
                             for d in (update, held))
        model.learn_rate = online_lr
        t0 = time.perf_counter()
        inc = evaluate_fold_in_incremental_training(model, upd_few, held_few)
        inc_s = time.perf_counter() - t0
        model.learn_rate = default_lr
    log(f"fold-in, {FOLDIN_USERS} users ({len(update)} update / "
        f"{len(held)} evaluated ratings): {res}, {foldin_s:.2f} s; "
        f"incremental protocol, {len(few)} users: {inc}, {inc_s:.2f} s "
        f"({inc_s / len(few):.2f} s a user)")
    for r in (res, inc):
        if not (math.isfinite(r["RMSE"]) and 0 < r["RMSE"] < 2):
            raise AssertionError(f"fold-in RMSE {r['RMSE']}")
    # remove_ratings drops every rating of a removed (user, item) pair,
    # earlier duplicates too
    if len(model.ratings) > n_before:
        raise AssertionError("the incremental protocol left ratings behind")
    H = model.H_ext
    frozen, lr_vec, reg_vec, hp = model._row_args(
        "user", model.regularization)
    worst, control = 0.0, math.inf
    for u in np.unique(update.users)[:ROW_CHECKS]:   # a history each
        seg = update.users == u
        for learner in (None, returns_input):
            err = row_witness(model, model._fresh_row(frozen), H,
                              update.items[seg], update.values[seg], lr_vec,
                              reg_vec, hp, learner)
            if learner is None:
                worst = max(worst, err)
            else:
                control = min(control, err)
    log(f"fold-in rows, {ROW_CHECKS} users, each step from the float64 "
        f"trajectory at the learn rate {default_lr}: max_abs_err "
        f"{worst:.3e} (tol {ROW_TOL}); a learner that takes no step reads "
        f"at least {control:.3e} on every row")
    if not worst <= ROW_TOL:
        raise AssertionError(f"fold-in rows off float64 by {worst:.3e}")
    if not control > ROW_TOL:
        raise AssertionError("the fold-in witness passes a learner that "
                             f"takes no step ({control:.3e})")


def phase_online_bpr(dev, model, feedback, test_items):
    """(c) the per-user online protocol with phase 8's BPRMF over
    ONLINE_ITEM_USERS seeded test users: AUC, prec@5, ms a user split
    into the evaluation, ``feedback.add``, the sampler rebuild and the
    refresh; one user's pairwise step held to float64 on the host; then
    one iterate() on the grown feedback through kernel 3."""
    from mymedialite_tpu_torch.data import arrays
    from mymedialite_tpu_torch.eval import online
    from mymedialite_tpu_torch.ops import bpr as bpr_ops

    rng = np.random.default_rng(26)
    users = rng.choice(test_items.all_users, ONLINE_ITEM_USERS,
                       replace=False)
    n_before = len(model.feedback)
    with timed_calls(online, "evaluate_items") as eval_s, \
            timed_calls(arrays.PosOnlyData, "add") as add_s, \
            timed_calls(bpr_ops, "make_sampler_data") as sampler_s, \
            timed_calls(model, "retrain_user") as retrain_s, \
            counted_path({}):
        t0 = time.perf_counter()
        res = online.evaluate_items_online(model, test_items, feedback,
                                           test_users=users)
        total_s = time.perf_counter() - t0
    n = max(res["num_users"], 1)
    log(f"online BPRMF, {res['num_users']} users: {res}; {total_s:.2f} s, "
        f"{total_s / n * 1e3:.1f} ms a user: evaluation "
        f"{sum(eval_s) / n * 1e3:.1f}, feedback.add "
        f"{sum(add_s) / n * 1e3:.1f}, sampler rebuild "
        f"{sum(sampler_s) / n * 1e3:.1f}, refresh "
        f"{sum(retrain_s) / n * 1e3:.1f} ms")
    if not (math.isfinite(res["AUC"]) and res["AUC"] > 0.5):
        raise AssertionError(f"online BPRMF AUC {res['AUC']}")
    grown = len(model.feedback)
    if grown <= n_before:
        raise AssertionError("the online events did not join the feedback")

    # one user's pairwise step: the card in float32, the host in float64
    sampler, meta = model._sampling
    u = int(users[0])
    lo, hi = sampler["indptr"][u:u + 2].tolist()
    gen = torch.Generator(device=dev)
    gen.manual_seed(27)
    pos = sampler["hist_items"][lo:hi][torch.randint(
        0, hi - lo, (hi - lo,), generator=gen, device=dev)]
    us = torch.full_like(pos, u)
    cand = bpr_ops.negative_candidates(gen, meta["num_items"],
                                       meta["num_neg_trials"], hi - lo, dev)
    neg, ok = bpr_ops.first_negatives(sampler, us, cand, meta["num_items"])
    card = {k: v.clone() for k, v in model.params.items()}
    host = {k: v.double().cpu() for k, v in model.params.items()}
    with torch.no_grad():
        bpr_ops.bpr_step(card, us, pos, neg, ok, model._hp(), update_j=True)
        bpr_ops.bpr_step(host, us.cpu(), pos.cpu(), neg.cpu(), ok.cpu(),
                         model._hp(), update_j=True)
    err = max(float((card[k].double().cpu() - host[k]).abs().max())
              for k in card)
    log(f"pairwise step of user {u} ({hi - lo} triples, all three sides) "
        f"against float64 on the host: max_abs_err {err:.3e} "
        f"(tol {PAIRWISE_TOL})")
    if not err <= PAIRWISE_TOL:
        raise AssertionError(f"pairwise step off float64 by {err:.3e}")
    del card, host

    with counted_path({"bpr_epoch": 1}) as counted:
        t0 = time.perf_counter()
        model.iterate()
        torch.cuda.synchronize()
        iterate_s = time.perf_counter() - t0
    if model._plan.n_ratings != grown:
        raise AssertionError("the BPR plan does not hold the grown feedback")
    log(f"iterate() after the online run: {iterate_s:.2f} s, bpr_epoch "
        f"launches {counted['bpr_epoch']}, plan of {grown} events "
        f"({n_before} + {grown - n_before})")


def phase_online_wrmf(dev, model, feedback, test_items):
    """(d) ``add_feedback`` on phase 11a's WRMF for WRMF_ONLINE_USERS
    seeded test users (their test items), the user rows re-solved: every
    other row bit-equal, the re-solved rows within WRMF_F64_TOL of the
    same rows assembled and solved in float64 (``wrmf_user_side_f64``)."""
    from mymedialite_tpu_torch.data.arrays import PosOnlyData
    rng = np.random.default_rng(28)
    users = np.sort(rng.choice(test_items.all_users, WRMF_ONLINE_USERS,
                               replace=False))
    sel = np.isin(test_items.users, users)
    ev_u, ev_i = test_items.users[sel], test_items.items[sel]
    model.update_users, model.update_items = True, False
    before = {k: v.clone() for k, v in model.params.items()}
    with counted_path({}):
        t0 = time.perf_counter()
        model.add_feedback(ev_u, ev_i)
        torch.cuda.synchronize()
        add_s = time.perf_counter() - t0
    p = model.params
    touched = torch.zeros(p["user_factors"].shape[0], dtype=torch.bool,
                          device=dev)
    touched[torch.from_numpy(users.astype(np.int64)).to(dev)] = True
    W0 = before["user_factors"]
    H0 = before["item_factors"]
    same = (torch.equal(p["item_factors"][:H0.shape[0]], H0)
            and torch.equal(p["user_factors"][:W0.shape[0]][~touched[
                :W0.shape[0]]], W0[~touched[:W0.shape[0]]]))
    if not same:
        raise AssertionError("WRMF add_feedback moved an untouched row")
    f = model.feedback
    mine = np.isin(f.users, users)
    rank = np.searchsorted(users, f.users[mine])
    sub = PosOnlyData(rank, f.items[mine], num_users=users.size,
                      num_items=f.num_items)
    x64 = wrmf_user_side_f64(sub, p["item_factors"], model.alpha,
                             model.regularization)
    rows = p["user_factors"][torch.from_numpy(users.astype(np.int64)).to(dev)]
    err = float((rows.double() - x64).abs().max()) / float(x64.abs().max())
    log(f"online WRMF, {users.size} users ({ev_u.size} events): "
        f"add_feedback {add_s:.2f} s; untouched rows bit-equal; re-solved "
        f"rows against float64: max error {err:.3e} of the largest |x| "
        f"(tol {WRMF_F64_TOL})")
    if not err <= WRMF_F64_TOL:
        raise AssertionError(f"WRMF re-solved rows off float64 by {err:.3e}")


def phase_online_svdpp(dev, model, train, test):
    """(e) SVD_CALLS ``add_ratings`` calls of SVDPP_EVENTS test events
    each on phase 11's SVDPlusPlus: each re-plans and runs one epoch,
    kernel 5 once a call and no other kernel; the plan and epoch time of
    each, and the RMSE before and after."""
    from mymedialite_tpu_torch.eval.rating import evaluate_ratings
    from mymedialite_tpu_torch.models import svdpp as svdpp_module
    from mymedialite_tpu_torch.ops import svdpp_plan as sp

    before = evaluate_ratings(model, test, train)["RMSE"]
    events = event_subset(test, SVDPP_CALLS * SVDPP_EVENTS, seed=29)
    calls = []
    with timed_training((sp, "prepare_svdpp_mxu"),
                        (svdpp_module, "svdpp_epoch")) as timings, \
            counted_path({"svdpp_epoch": SVDPP_CALLS}):
        for c in range(SVDPP_CALLS):
            sl = slice(c * SVDPP_EVENTS, (c + 1) * SVDPP_EVENTS)
            t0 = time.perf_counter()
            model.add_ratings(events.users[sl], events.items[sl],
                              events.values[sl])
            torch.cuda.synchronize()
            calls.append(time.perf_counter() - t0)
    after = evaluate_ratings(model, test, model.ratings)["RMSE"]
    log(f"online SVD++, {SVDPP_CALLS} add_ratings of {SVDPP_EVENTS} events: "
        + "; ".join(f"{s:.2f} s (plan {p:.2f} s, epoch {e:.1f} ms)"
                    for s, p, e in zip(calls, timings["plan_s"],
                                       timings["epoch_ms"]))
        + f"; route {model.route()}; RMSE before {before:.5f}, after "
        f"{after:.5f}")
    if not (math.isfinite(after) and after < 2):
        raise AssertionError(f"SVD++ RMSE after the updates {after}")


def phase_online_cli(dev, tmp):
    """(f) ``--online-evaluation`` at the ML-100K shape (943 users x 1,682
    items x 100,000 ratings, GroupLens' published ml-100k counts,
    synthetic, split 80/20, ONLINE_CLI_EVENTS seeded events of the test
    part in its order): the rating CLI with UserItemBaseline and
    BiasedMatrixFactorization, the item CLI with BPRMF."""
    from mymedialite_tpu_torch.cli import item_recommendation
    from mymedialite_tpu_torch.cli import rating_prediction
    from mymedialite_tpu_torch.data.synthetic import (
        split_ratings, synthetic_ratings,
    )
    train, test = split_ratings(synthetic_ratings(**ML100K, seed=30), 0.2,
                                seed=31)
    test = event_subset(test, ONLINE_CLI_EVENTS, seed=32)
    files = []
    for name, part in (("training", train), ("test", test)):
        path = os.path.join(tmp, f"ml100k-{name}.tsv")
        np.savetxt(path, np.column_stack([part.users, part.items,
                                          part.values]),
                   fmt=("%d", "%d", "%g"), delimiter="\t")
        files += [f"--{name}-file", path]
    for main, name, opts, kernels in (
            (rating_prediction.main, "UserItemBaseline", "", {}),
            (rating_prediction.main, "BiasedMatrixFactorization",
             "num_factors=40 num_iter=3 ", {"sgd_epoch": 3}),
            (item_recommendation.main, "BPRMF", "num_factors=40 num_iter=3 ",
             {"bpr_epoch": 3})):
        argv = files + ["--recommender", name, "--online-evaluation",
                        "--recommender-options", f"{opts}device={dev.type}"]
        with counted_path(kernels):
            t0 = time.perf_counter()
            text = run_cli(main, argv)
        key = "AUC" if main is item_recommendation.main else "RMSE"
        value = result_value(text, key)
        log(f"online CLI {name}: {key} {value:.5f}, "
            f"{time.perf_counter() - t0:.1f} s")
        if not math.isfinite(value):
            raise AssertionError(f"online CLI {name}: {key} {value}")


def phase_incremental(dev, train, test, bpr, wrmf, svdpp, tmp):
    """Phase 22: (a)-(f) on phase 6's data and the models of phases 8,
    11 and 11a; ``bpr`` and ``wrmf`` are (model, feedback, test pairs)."""
    t0 = time.perf_counter()
    model, online_lr = phase_online_mf(dev, train, test)
    phase_foldin(dev, model, online_lr, test)
    del model
    phase_online_bpr(dev, *bpr)
    phase_online_wrmf(dev, *wrmf)
    phase_online_svdpp(dev, svdpp, train, test)
    phase_online_cli(dev, tmp)
    log(f"phase 22 (incremental and online): "
        f"{time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 23: the last eight names
# ---------------------------------------------------------------------------

# (a) the Netflix shape with times and a per-item drift, split by time
TIME_AWARE_SHAPE = dict(num_users=480_000, num_items=17_770,
                        num_ratings=20_000_000, seed=1)
TIME_AWARE_ITERS = {"TimeAwareBaseline": 15,
                    "TimeAwareBaselineWithFrequencies": 20}
TIME_AWARE_BATCH = 65_536
# (b) quality.py's SocialMF row at ML-1M size, and the Epinions shape
# (Massa & Avesani's trust data as Jamali & Ester 2010 use it): (shape,
# iterations); each user trusts its TRUST_K nearest users in the planted
# factor space
SOCIAL_SHAPES = {
    "ML-1M": (dict(num_users=6040, num_items=3706, num_ratings=1_000_000,
                   seed=100), 400),
    "Epinions": (dict(num_users=49_290, num_items=139_738,
                      num_ratings=664_824, seed=120), 50),
}
SOCIAL_OPTS = "num_factors=40 learn_rate=0.0002 social_regularization=0.5"
TRUST_K = 10
TRUST_ROWS = 4096
# (c) SLIM on phase 6's pairs as positive-only feedback
SLIM_SWEEPS = 15
BPRSLIM_EPOCHS = 1
# (d), (e): users served or ranked
PHASE23_USERS = 1024
# (f) quality.py's drift data at ML-1M size, written with its times
TIMED_CLI_SHAPE = dict(num_users=6040, num_items=3706, num_ratings=1_000_000,
                       seed=110)
# float32 steps held to float64
STEP_TOL = 1e-5


def peak_gib(dev) -> str:
    if dev.type != "cuda":
        return "n/a"
    return f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"


def synced_seconds(fn, *args, **kwargs):
    """(result, host seconds) of one call, the card synchronised on both
    sides."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def step_check(err, what):
    log(f"{what}: float32 step vs float64 step, max_abs_err {err:.3e} "
        f"(tol {STEP_TOL})")
    if not err <= STEP_TOL:
        raise AssertionError(f"{what}: float32 step {err} from float64, "
                             f"past {STEP_TOL}")


def phase_time_aware(dev):
    """(a) TimeAwareBaseline and TimeAwareBaselineWithFrequencies at the
    Netflix shape with times and a per-item drift, split by time 80/20:
    s per epoch, RMSE with the times against UserItemBaseline and the
    global average; one minibatch step of the trained tables held to
    float64. No kernel runs."""
    from mymedialite_tpu_torch.data.splits import chronological_split_ratio
    from mymedialite_tpu_torch.data.synthetic import synthetic_ratings
    from mymedialite_tpu_torch.eval.rating import evaluate_ratings
    from mymedialite_tpu_torch.models import time_aware as ta
    from mymedialite_tpu_torch.models.registry import create_rating_predictor

    t0 = time.perf_counter()
    data = synthetic_ratings(**TIME_AWARE_SHAPE, with_times=True,
                             time_drift=1.0, device=draw_device())
    train, test = chronological_split_ratio(data, 0.2)
    del data
    baseline = global_average_rmse(train, test)
    log(f"time-aware data: {train.num_users} users x {train.num_items} "
        f"items, {len(train)} train / {len(test)} test (split by time), "
        f"{time.perf_counter() - t0:.1f} s")
    uib = create_rating_predictor("UserItemBaseline", f"device={dev.type}")
    uib.ratings = train
    with counted_path({}):
        uib.train()
        uib_rmse = evaluate_ratings(uib, test)["RMSE"]
    del uib
    for name, iters in TIME_AWARE_ITERS.items():
        model = create_rating_predictor(
            name, f"num_iter=0 batch_size={TIME_AWARE_BATCH} "
            f"device={dev.type}")
        model.ratings = train
        torch.cuda.reset_peak_memory_stats()
        with counted_path({}):
            _, prep_s = synced_seconds(model.train)
            epochs = [synced_seconds(model.iterate)[1] for _ in range(iters)]
            res, eval_s = synced_seconds(evaluate_ratings, model, test, train)
        model.num_iter = iters
        days = model.params["user_bias_by_day"]
        log(f"{name}: {model._num_days} days, {model._num_bins} bins, "
            f"[U, days] tables of {days.numel() * 4 / 1e6:.0f} MB; prep "
            f"{prep_s:.2f} s; {iters} epochs of "
            f"{model._epoch['users'].shape[0] // model._B} batches of "
            f"{model._B}, mean {np.mean(epochs):.3f} s/epoch; eval with "
            f"times {eval_s:.2f} s: {res}; UserItemBaseline RMSE "
            f"{uib_rmse:.5f}, global average {baseline:.5f}; peak device "
            f"memory {peak_gib(dev)}")
        if not (math.isfinite(res["RMSE"]) and res["RMSE"] < baseline):
            raise AssertionError(f"{name}: RMSE {res['RMSE']} does not beat "
                                 f"the global average {baseline}")
        batch = ta.epoch_batch(model._epoch, 0, model._B)
        p32 = {k: v.clone() for k, v in model.params.items()}
        p64 = {k: v.double() for k, v in model.params.items()}
        hp = model._hp()
        with torch.no_grad():
            ta.time_aware_step(p32, batch, hp,
                               with_freq=model.WITH_FREQUENCIES)
            ta.time_aware_step(p64, batch, hp,
                               with_freq=model.WITH_FREQUENCIES)
        step_check(table_distance(tuple(p32.values()),
                                  tuple(p64[k] for k in p32)),
                   f"{name} minibatch")
        del model, p32, p64
    del train, test


def planted_trust(P, k: int, dev):
    """(trusters, trusted) numpy: every user trusts its k nearest users by
    cosine of the planted factors P [U, r] (quality.py's graph), the
    similarities taken on ``dev`` in blocks of TRUST_ROWS rows."""
    Pd = torch.from_numpy(P).to(dev)
    Pn = Pd / Pd.norm(dim=1, keepdim=True).clamp(min=1e-9)
    out = []
    for r0 in range(0, Pn.shape[0], TRUST_ROWS):
        sim = Pn[r0:r0 + TRUST_ROWS] @ Pn.T
        rows = torch.arange(sim.shape[0], device=dev)
        sim[rows, r0 + rows] = -math.inf
        out.append(torch.topk(sim, k, dim=1).indices)
    nbr = torch.cat(out).cpu().numpy()
    return (np.repeat(np.arange(P.shape[0], dtype=np.int32), k),
            nbr.astype(np.int32).reshape(-1))


def phase_social_mf(dev):
    """(b) SocialMF on its own full-batch step at the ML-1M size
    (quality.py's row) and at the Epinions shape, each with the planted
    10-NN trust graph: ms per step, RMSE against the global average, one
    step held to float64 with T in float64. No kernel runs."""
    from mymedialite_tpu_torch.data.arrays import PosOnlyData
    from mymedialite_tpu_torch.data.synthetic import (
        split_ratings, synthetic_ratings,
    )
    from mymedialite_tpu_torch.eval.rating import evaluate_ratings
    from mymedialite_tpu_torch.models import social_mf as sm
    from mymedialite_tpu_torch.models.registry import create_rating_predictor

    for label, (shape, iters) in SOCIAL_SHAPES.items():
        t0 = time.perf_counter()
        data, (P, _q, _bu, _bi) = synthetic_ratings(
            **shape, return_factors=True, device=draw_device())
        train, test = split_ratings(data, 0.1, seed=shape["seed"] + 1)
        u, v = planted_trust(P, TRUST_K, dev)
        U = shape["num_users"]
        trust = PosOnlyData(u, v, num_users=U, num_items=U)
        log(f"SocialMF {label} data: {U} users x {shape['num_items']} "
            f"items, {len(train)} train / {len(test)} test, {len(trust)} "
            f"trust edges; a dense T would be {U * U * 4 / 1e9:.2f} GB; "
            f"{time.perf_counter() - t0:.1f} s")
        model = create_rating_predictor(
            "SocialMF", f"{SOCIAL_OPTS} num_iter={iters} device={dev.type}")
        model.user_relation = trust
        model.ratings = train
        torch.cuda.reset_peak_memory_stats()
        with counted_path({}):
            _, init_s = synced_seconds(model.init_model)
            # one step from the initial tables in float32 and in float64
            model._ensure_epoch_ready()
            flat, _ = model._flat_data()
            hp = model._hp()
            kw = dict(num_users=model.num_users_trained,
                      num_factors=model.num_factors, loss=model.loss_id)
            trust64 = sm.trust_matrices(u, v, model.num_users_trained, dev,
                                        dtype=torch.float64)
            W32, H32 = sm.social_mf_step(model.W_ext, model.H_ext, flat,
                                         model._trust, hp, **kw)
            W64, H64 = sm.social_mf_step(model.W_ext.double(),
                                         model.H_ext.double(), flat, trust64,
                                         hp, **kw)
            err = table_distance((W32, H32), (W64, H64))
            del W32, H32, W64, H64, trust64
            steps = [synced_seconds(model.iterate)[1] for _ in range(iters)]
            res = evaluate_ratings(model, test, train)
        baseline = global_average_rmse(train, test)
        log(f"SocialMF {label}: init {init_s:.2f} s; {iters} steps, mean "
            f"{np.mean(steps) * 1e3:.2f} ms/step; eval {res}; global "
            f"average {baseline:.5f}; peak device memory {peak_gib(dev)}")
        step_check(err, f"SocialMF {label} step")
        if not (math.isfinite(res["RMSE"]) and res["RMSE"] < baseline):
            raise AssertionError(f"SocialMF {label}: RMSE {res['RMSE']} does "
                                 f"not beat the global average {baseline}")
        del model


def phase_slim(dev, feedback, test_items):
    """(c) LeastSquareSLIM and BPRSLIM on phase 6's pairs as positive-only
    feedback: the C and mask builds, s per sweep or epoch, L_max and the
    padded history's bytes, AUC and prec@10 over EVAL_USERS seeded test
    users; one BPRSLIM batch step held to float64. No kernel runs."""
    from mymedialite_tpu_torch.models import slim
    from mymedialite_tpu_torch.models.registry import create_item_recommender
    from mymedialite_tpu_torch.ops import bpr as bpr_ops

    torch.cuda.reset_peak_memory_stats()
    ls = create_item_recommender(
        "LeastSquareSLIM", f"num_iter={SLIM_SWEEPS} reg_l1=0.0001 "
        f"device={dev.type}")
    ls.feedback = feedback
    with counted_path({}), timed_calls(slim, "cooccurrence") as c_s, \
            timed_calls(slim, "feature_mask") as mask_s:
        ls.init_model()
        sweeps = [synced_seconds(ls.iterate)[1] for _ in range(SLIM_SWEEPS)]
        res = sampled_ranking_eval(ls, feedback, test_items,
                                   "LeastSquareSLIM")
    I = feedback.num_items
    log(f"LeastSquareSLIM ({I} items, W, C and the mask "
        f"{I * I * 4 / 1e9:.2f} GB each, the int8 incidence "
        f"{feedback.num_users * I / 1e9:.1f} GB while it lives): C "
        f"{c_s[0]:.2f} s, mask (k={ls.k} cosine) {mask_s[0]:.2f} s, "
        f"{SLIM_SWEEPS} sweeps, mean {np.mean(sweeps):.3f} s/sweep; "
        f"{int((ls.W != 0).sum())} nonzero weights; AUC {res['AUC']:.5f}, "
        f"prec@10 {res['prec@10']:.5f}; peak device memory {peak_gib(dev)}")
    if not res["AUC"] > 0.5:
        raise AssertionError(f"LeastSquareSLIM AUC {res['AUC']} <= 0.5")
    del ls
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    bs = create_item_recommender("BPRSLIM", f"num_iter={BPRSLIM_EPOCHS} "
                                 f"device={dev.type}")
    bs.feedback = feedback
    with counted_path({}):
        _, init_s = synced_seconds(bs.init_model)
        epochs = [synced_seconds(bs.iterate)[1]
                  for _ in range(BPRSLIM_EPOCHS)]
        res = sampled_ranking_eval(bs, feedback, test_items, "BPRSLIM")
        # one batch of fresh triples in float32 and in float64
        sampler, meta = bs._sampling
        gen = torch.Generator(device=dev).manual_seed(23)
        u, i, j, w = bpr_ops.sample_triples(gen, sampler, meta, bs.batch_size,
                                            bs._regime())
        hist, lens = bs._history()
        W32, W64 = bs.W.clone(), bs.W.double()
        args = (float(np.float32(bs.learn_rate)),
                float(np.float32(bs.reg_i)), float(np.float32(bs.reg_j)))
        slim.bpr_slim_step(W32, hist, lens, u, i, j, w, *args,
                           update_j=bs.update_j)
        slim.bpr_slim_step(W64, hist, lens, u, i, j, w, *args,
                           update_j=bs.update_j)
        err = table_distance((W32,), (W64,))
        del W32, W64
    B, nb = bpr_ops.epoch_batches(meta["num_events"], bs.batch_size)
    log(f"BPRSLIM: init {init_s:.2f} s (padded history [{hist.shape[0]}, "
        f"L_max={hist.shape[1]}] int32, {bs.history_bytes / 1e9:.2f} GB); "
        f"{BPRSLIM_EPOCHS} epochs of {nb} batches of {B} triples, mean "
        f"{np.mean(epochs):.2f} s/epoch ({meta['num_events'] / np.mean(epochs):.4g} "
        f"triples/s); AUC {res['AUC']:.5f}, prec@10 {res['prec@10']:.5f}; "
        f"peak device memory {peak_gib(dev)}")
    step_check(err, "BPRSLIM batch")
    if not res["AUC"] > 0.5:
        raise AssertionError(f"BPRSLIM AUC {res['AUC']} <= 0.5")
    del bs
    torch.cuda.empty_cache()


def phase_multicore_bpr(dev, bpr_model, feedback):
    """(d) MultiCoreBPRMF: one iterate() from phase 8's BPRMF tables on
    phase 8's feedback through kernel 3 once, against BPRMF's iterate()
    from the same tables and generator state (identical sampled
    negatives, tables within KERNEL_TOL); then PHASE23_USERS users served
    through kernel 6."""
    from mymedialite_tpu_torch.models import bpr as bpr_module
    from mymedialite_tpu_torch.models.registry import create_item_recommender
    from mymedialite_tpu_torch.ops.topk import recommend_batch

    real = bpr_module.bpr_epoch
    runs = {}
    for name in ("MultiCoreBPRMF", "BPRMF"):
        model = create_item_recommender(
            name, f"num_factors={bpr_model.num_factors} device={dev.type}")
        model.feedback = feedback
        model.init_model(tables={k: v.clone()
                                 for k, v in bpr_model.params.items()})
        negatives = []

        def recording(*a, **kw):
            out = real(*a, **dict(kw, return_negatives=True))
            negatives.append(out[2])
            return out
        bpr_module.bpr_epoch = recording
        try:
            with counted_path({"bpr_epoch": 1}):
                _, s = synced_seconds(model.iterate)
        finally:
            bpr_module.bpr_epoch = real
        runs[name] = (model, negatives[0], s)
    multi, neg, seconds = runs["MultiCoreBPRMF"]
    ref, ref_neg, ref_s = runs["BPRMF"]
    if not torch.equal(neg, ref_neg):
        raise AssertionError("MultiCoreBPRMF sampled other negatives than "
                             "BPRMF")
    err = max((multi.params[k] - ref.params[k]).abs().max().item()
              for k in ref.params)
    rng = np.random.default_rng(24)
    users = np.sort(rng.choice(feedback.num_users, PHASE23_USERS,
                               replace=False))
    with counted_path({"catalog_topk": 1}):
        ids, _ = recommend_batch(multi, users, 10, training=feedback)
    log(f"MultiCoreBPRMF: one iterate() {seconds:.2f} s (BPRMF's "
        f"{ref_s:.2f} s), negatives identical, tables against BPRMF's "
        f"max_abs_err {err:.3e} (tol {KERNEL_TOL}); {users.size} users "
        f"served through kernel 6 ({int((ids >= 0).sum())} items listed)")
    check(err, "MultiCoreBPRMF against BPRMF")
    del runs, multi, ref


def write_scores(path, users, items, scores):
    """``user item score`` lines, the score as %.6g."""
    with open(path, "w") as f:
        f.write("".join(f"{u} {i} {s:.6g}\n" for u, i, s in
                        zip(users.tolist(), items.tolist(), scores.tolist())))


def phase_external(dev, train, test, mf_run, feedback, tmp):
    """(e) phase 7's BiasedMatrixFactorization predictions of its test
    pairs as a prediction file: ExternalRatingPredictor's RMSE equals
    phase 7's to the file's %.6g rounding; ExternalItemRecommender's
    top-10 of PHASE23_USERS seeded users equals a plain lookup's."""
    from mymedialite_tpu_torch.eval.rating import evaluate_ratings
    from mymedialite_tpu_torch.models.registry import (
        create_item_recommender, create_rating_predictor,
    )
    from mymedialite_tpu_torch.ops.topk import NEG_INF, recommend_batch

    path = os.path.join(tmp, "biasedmf_predictions.txt")
    preds = mf_run["test_predictions"]
    _, write_s = synced_seconds(write_scores, path, test.users, test.items,
                                preds)
    ext = create_rating_predictor("ExternalRatingPredictor",
                                  f"prediction_file={path} "
                                  f"device={dev.type}")
    ext.ratings = train
    with counted_path({}):
        _, read_s = synced_seconds(ext.train)
        res, eval_s = synced_seconds(evaluate_ratings, ext, test)
    diff = abs(res["RMSE"] - mf_run["test_rmse"])
    log(f"ExternalRatingPredictor: {len(test)} lines written {write_s:.2f} "
        f"s, read {read_s:.2f} s, evaluated {eval_s:.2f} s: {res}; phase 7's "
        f"RMSE {mf_run['test_rmse']:.6f}, difference {diff:.2e} (tol 1e-5)")
    if not diff <= 1e-5:
        raise AssertionError(f"ExternalRatingPredictor RMSE {res['RMSE']} "
                             f"is not phase 7's {mf_run['test_rmse']}")

    item = create_item_recommender("ExternalItemRecommender",
                                   f"prediction_file={path} "
                                   f"device={dev.type}")
    item.feedback = feedback
    rng = np.random.default_rng(25)
    users = np.sort(rng.choice(test.all_users, PHASE23_USERS, replace=False))
    with counted_path({}):
        item.train()
        ids, scores = recommend_batch(item, users, 10, training=feedback)
    # the plain lookup: each user's listed scores, the training items out
    I = item.num_items_trained
    plain = np.full((users.size, I), np.float32(-3.4e38), np.float32)
    at = {u: r for r, u in enumerate(users.tolist())}
    sel = np.isin(test.users, users)
    rows = np.array([at[u] for u in test.users[sel].tolist()], np.int64)
    plain[rows, test.items[sel]] = preds[sel]
    for r, u in enumerate(users.tolist()):
        plain[r, feedback.items_by_user(u)] = NEG_INF
    order = np.argsort(-plain, axis=1, kind="stable")[:, :10]
    top = np.take_along_axis(plain, order, axis=1)
    ref_ids = np.where(top > np.float32(NEG_INF), order, -1)
    if not np.array_equal(ids, ref_ids):
        raise AssertionError("ExternalItemRecommender's lists differ from "
                             "the plain lookup's")
    log(f"ExternalItemRecommender: top-10 of {users.size} users equal the "
        f"plain lookup's ({int((ids >= 0).sum())} items listed)")
    del ext, item


def phase_last_models(dev, train, test, mf_run, bpr, wrmf_feedback,
                      test_items, tmp):
    """Phase 23 (a)-(e), on phase 6's data and the models of phases 7 and
    8; ``bpr`` is (model, feedback)."""
    t0 = time.perf_counter()
    phase_time_aware(dev)
    torch.cuda.empty_cache()
    phase_social_mf(dev)
    phase_slim(dev, wrmf_feedback, test_items)
    phase_multicore_bpr(dev, *bpr)
    phase_external(dev, train, test, mf_run, bpr[1], tmp)
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    log(f"phase 23 (a)-(e) (the last eight names): {seconds:.1f} s")
    return seconds


def trace_kernels(trace_dir):
    """The names of the CUDA kernel events, one per event, in the
    torch.profiler trace that ``--profile`` wrote into ``trace_dir``."""
    files = [f for f in os.listdir(trace_dir) if f.endswith(".pt.trace.json")]
    if not files:
        raise AssertionError(f"--profile wrote no trace into {trace_dir}")
    with open(os.path.join(trace_dir, files[0])) as f:
        events = json.load(f).get("traceEvents", [])
    return [e.get("name", "") for e in events if e.get("cat") == "kernel"]


def one_card_env() -> dict:
    """This process's environment with only its current card visible: a
    child then means on a host of several cards what it means on one, as
    the phases do in process (``default_devices`` in ``main``)."""
    env = dict(os.environ)
    if torch.cuda.is_available():
        card = torch.cuda.current_device()
        visible = env.get("CUDA_VISIBLE_DEVICES")
        env["CUDA_VISIBLE_DEVICES"] = (visible.split(",")[card] if visible
                                       else str(card))
    return env


def counted_clis(runs):
    """Run CLIs of the port in one process of its own, this script with
    ``--counted-cli``: ``runs`` is a list of (expected launches, module
    of ``mymedialite_tpu_torch.cli``, argv), run in order, each with
    every kernel's launch count set to 0 before it and the expected
    launches required after it, as ``counted_path`` requires them.
    Returns the CLIs' output. The first run's ``--profile`` trace is
    then its process's first profiler session, as a user's run is."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--counted-cli",
         json.dumps(runs)], capture_output=True, text=True, timeout=600,
        env=one_card_env())
    sys.stderr.write(proc.stderr)
    log(proc.stdout.rstrip())
    if proc.returncode != 0:
        raise AssertionError(f"the CLIs in their own process returned "
                             f"{proc.returncode}:\n{proc.stderr[-3000:]}")
    return proc.stdout


def counted_clis_child(runs_json: str) -> int:
    """The process that ``counted_clis`` starts."""
    import importlib
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for expected, module, argv in json.loads(runs_json):
        cli = importlib.import_module(f"mymedialite_tpu_torch.cli.{module}")
        with counted_path(expected):
            rc = cli.main(argv)
        if rc != 0:
            return rc
    return 0


def phase_last_clis(dev, tmp, files, item_files):
    """(f) the CLIs at phase 16's size: the rating CLI with
    TimeAwareBaselineWithFrequencies on quality.py's drift data written
    with its times (save -> load), then ExternalRatingPredictor on its
    prediction file and the item CLI with ExternalItemRecommender on it;
    the item CLI with LeastSquareSLIM; --profile in each of the three
    CLIs, in a process of their own, the rating CLI's
    BiasedMatrixFactorization trace holding kernel 1's CUDA events."""
    from mymedialite_tpu_torch.cli import item_recommendation, rating_prediction
    from mymedialite_tpu_torch.data.synthetic import (
        split_ratings, synthetic_ratings,
    )

    t0 = time.perf_counter()
    on = f"device={dev.type}"
    data = synthetic_ratings(**TIMED_CLI_SHAPE, with_times=True,
                             time_drift=1.0, device=draw_device())
    train, test = split_ratings(data, 0.1, seed=TIMED_CLI_SHAPE["seed"] + 1)
    timed = []
    for name, part in (("timed_train", train), ("timed_test", test)):
        path = os.path.join(tmp, f"{name}.tsv")
        np.savetxt(path, np.column_stack([part.users, part.items,
                                          part.values, part.times]),
                   fmt=("%d", "%d", "%g", "%d"), delimiter="\t")
        timed.append(path)
    timed_files = ["--training-file", timed[0], "--test-file", timed[1]]
    predictions = os.path.join(tmp, "time_aware_predictions.txt")
    with counted_path({}):
        text = save_load_same(
            rating_prediction.main, timed_files + [
                "--recommender", "TimeAwareBaselineWithFrequencies",
                "--recommender-options", on, "--prediction-file",
                predictions], os.path.join(tmp, "time_aware.model"))
        rmse = result_value(text, "RMSE")
        if not (math.isfinite(rmse) and rmse < global_average_rmse(train,
                                                                   test)):
            raise AssertionError(f"timed CLI RMSE {rmse} does not beat the "
                                 "global average")
        # the prediction file (original ids, predictions without times)
        # served back through both CLIs
        lines = np.loadtxt(predictions, dtype=np.float64)
        want = float(np.sqrt(np.mean((lines[:, 2].astype(np.float32)
                                      - test.values) ** 2)))
        opts = ["--recommender-options", f"prediction_file={predictions} {on}"]
        text = run_cli(rating_prediction.main, timed_files + [
            "--recommender", "ExternalRatingPredictor"] + opts)
        if not abs(result_value(text, "RMSE") - want) <= 1e-5:
            raise AssertionError("ExternalRatingPredictor through the CLI: "
                                 f"RMSE {result_value(text, 'RMSE')}, the "
                                 f"file's {want}")
        text = run_cli(item_recommendation.main, timed_files + [
            "--recommender", "ExternalItemRecommender"] + opts)
        if not result_value(text, "AUC") > 0.9:
            raise AssertionError("ExternalItemRecommender through the CLI "
                                 "does not rank its listed items first")
        text = run_cli(item_recommendation.main, item_files + [
            "--recommender", "LeastSquareSLIM", "--recommender-options",
            f"num_iter=5 reg_l1=0.0001 {on}"])
        if not result_value(text, "AUC") > 0.5:
            raise AssertionError("LeastSquareSLIM through the CLI: AUC <= 0.5")
    # the profiled CLIs in a process of their own, the rating CLI's
    # first: in this script's long process, after its other profiler
    # sessions, one trace on an H100 held no event of kernel 1 although
    # the kernel had run three times
    profiled = (
        ("rating", "rating_prediction", files + [
            "--recommender-options", f"num_factors=40 num_iter=3 {on}"],
         {"sgd_epoch": 3}),
        ("item", "item_recommendation", item_files, {}),
        ("rating_based_ranking", "rating_based_ranking", files + [
            "--recommender", "UserItemBaseline", "--recommender-options",
            on], {}))
    trace_dirs = {label: os.path.join(tmp, f"trace_{label}")
                  for label, *_ in profiled}
    # the plain versions, on CPU tensors, count no launch
    counted_clis([(kernels if dev.type == "cuda" else {}, module,
                   argv + ["--profile", trace_dirs[label]])
                  for label, module, argv, kernels in profiled])
    for label, _, _, kernels in profiled:
        events = trace_kernels(trace_dirs[label]) if dev.type == "cuda" \
            else []
        sgd = sum("sgd_epoch_kernel" in name for name in events)
        log(f"--profile {label} CLI: {len(events)} CUDA kernel events of "
            f"{len(set(events))} names in the trace, {sgd} of kernel 1")
        if dev.type == "cuda" and kernels.get("sgd_epoch") and not sgd:
            raise AssertionError(
                f"the {label} CLI's trace holds no event of kernel 1 "
                f"(sgd_epoch_kernel) in {len(events)} kernel events: "
                f"{sorted(set(events))[:20]}")
    seconds = time.perf_counter() - t0
    log(f"phase 23 (f) (the last eight names through the CLIs): "
        f"{seconds:.1f} s")
    return seconds


# ---------------------------------------------------------------------------
# phase 24: the mesh (parallel/mesh.py), Gemulla's DSGD diagonal over
# devices: kernels 1-4 once per (device, sub-epoch) cell
# ---------------------------------------------------------------------------

# the rig: one card named MESH_DEVICES times. Its cells run one after
# another, so its times say nothing of a mesh of cards; what it checks is
# the schedule, the offsets and the routes
MESH_DEVICES = 4
# epochs of each model on the big catalog's mesh (one device's minibatch
# epochs train 3 in phase 20)
MESH_BIG_EPOCHS = 1
# (a)'s data: phase 3's
MESH_CHECK_SHAPE = dict(num_users=2000, num_items=3000, num_ratings=100_000,
                        seed=3)


def rig_mesh(D: int = MESH_DEVICES):
    from mymedialite_tpu_torch.parallel.mesh import make_mesh
    return make_mesh(devices=[f"cuda:{torch.cuda.current_device()}"] * D
                     if torch.cuda.is_available() else ["cpu"] * D)


def mesh_cells(plan, order):
    """The non-empty cells in (sub-epoch, device) order: (d, p, cols),
    cols the cell's columns of ``order`` as int32 tensors on the plan's
    device, p the partition its device holds."""
    D, dev = plan.num_devices, plan.packed.device
    out = []
    for k in range(D):
        for d in range(D):
            n = int(plan.cell_counts[d, k])
            if n:
                out.append((d, (d + k) % D, tuple(
                    torch.from_numpy(np.ascontiguousarray(a[d, k, :n]))
                    .to(dev) for a in order)))
    return out


def flat_order(plan, order):
    """The sharded order as one order over the whole tables: the cells
    in (sub-epoch, device) order, blocks absolute. The sharded epoch is
    the one-device epoch over it (disjoint cells of a sub-epoch commute),
    which the MAE witnesses step through chunk by chunk."""
    tiled = hasattr(plan, "slab_blocks")
    cols = []
    for d, p, c in mesh_cells(plan, order):
        c = list(c)
        c[0] = c[0] + d * plan.ub_per_dev
        if tiled:
            c[2] = c[2] + p * plan.slabs_per_part
        else:
            c[1] = c[1] + p * plan.part_blocks
        cols.append(c)
    return tuple(torch.cat(parts).contiguous() for parts in zip(*cols))


def sharded_sgd(plan, W, H, order, hp, rates, *, loss, biased, plain=False):
    """One sharded SGD epoch on copies of the whole tables W [u_pad] and H
    [i_pad], over the rig mesh; returns the gathered tables."""
    from mymedialite_tpu_torch.ops import sgd_epoch as se
    mesh = rig_mesh(plan.num_devices)
    Ws, Hs = mesh.shard_rows(W.clone()), mesh.shard_rows(H.clone())
    kw = dict(user_block=plan.user_block, item_block=plan.item_block,
              loss=loss, biased=biased, plain=plain)
    if hasattr(plan, "slab_blocks"):
        se.sgd_epoch_sharded_tiled(mesh, Ws, Hs, plan.packed, order,
                                   plan.cell_counts, hp, rates,
                                   slab_blocks=plan.slab_blocks, **kw)
    else:
        se.sgd_epoch_sharded(mesh, Ws, Hs, plan.packed, order,
                             plan.cell_counts, hp, rates, **kw)
    return mesh.gather_rows(Ws), mesh.gather_rows(Hs)


def sgd_cells_in_turn(plan, W, H, order, hp, rates, *, loss, biased):
    """The sharded epoch's cells run one after another in (k, d) order by
    the one-device kernel on views of copies of the whole tables."""
    from mymedialite_tpu_torch.ops import sgd_epoch as se
    W, H = W.clone(), H.clone()
    upd, pr = plan.u_pad_dev, plan.part_rows
    kw = dict(user_block=plan.user_block, item_block=plan.item_block,
              loss=loss, biased=biased)
    for d, p, cols in mesh_cells(plan, order):
        Wd, Hp = W[d * upd:(d + 1) * upd], H[p * pr:(p + 1) * pr]
        if hasattr(plan, "slab_blocks"):
            se.sgd_epoch_tiled(Wd, Hp, plan.packed, cols, hp, rates,
                               slab_blocks=plan.slab_blocks, **kw)
        else:
            se.sgd_epoch(Wd, Hp, plan.packed, cols, hp, rates, **kw)
    return W, H


def timed(fn):
    """(fn()'s result, its ms on CUDA events)."""
    s, e = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    s.record()
    out = fn()
    e.record()
    torch.cuda.synchronize()
    return out, s.elapsed_time(e)


def mesh_sgd_check(plan, W, H, order, hp, rates, *, loss, biased, what):
    """The sharded SGD epoch held to its cells run in turn and to its
    plain version (the MAE rows under phase 3's witnesses, stepped through
    the flat order). Returns (max error, kernel ms)."""
    from mymedialite_tpu_torch.ops import sgd
    kw = dict(loss=loss, biased=biased)
    if loss == sgd.LOSS_MAE:
        (Wk, Hk), k_ms = timed(lambda: sharded_sgd(plan, W, H, order, hp,
                                                   rates, **kw))
        step, k_dist, p_dist = sgd_one_step_witness(
            plan, W, H, flat_order(plan, order), hp, rates,
            kernel_run=lambda tabs: sharded_sgd(plan, *tabs, order, hp,
                                                rates, **kw), **kw)
        log(f"{what}: one step at a time max_abs_err {step:.3e} (tol "
            f"{KERNEL_TOL}); whole epoch vs float64: kernel {k_dist:.3e}, "
            f"farthest plain {p_dist:.3e} (bound {WITNESS_FACTOR} x); "
            f"kernel {k_ms:.2f} ms")
        witness_check(step, k_dist, p_dist, what)
        return step, k_ms
    (Wk, Hk), k_ms = timed(lambda: sharded_sgd(plan, W, H, order, hp, rates,
                                               **kw))
    cells = sgd_cells_in_turn(plan, W, H, order, hp, rates, **kw)
    plain = sharded_sgd(plan, W, H, order, hp, rates, plain=True, **kw)
    err_cells = table_error((Wk, Hk), cells)
    err_plain = table_error((Wk, Hk), plain)
    log(f"{what}: against its cells in turn max_abs_err {err_cells:.3e}, "
        f"against the plain version {err_plain:.3e} (tol {KERNEL_TOL}); "
        f"kernel {k_ms:.2f} ms")
    check(err_cells, f"{what}, cells in turn")
    check(err_plain, what)
    return max(err_cells, err_plain), k_ms


def cell_bits(plan, trials: int, seed: int):
    """[D, D, nc_pad, trials, C] random bits on the plan's device."""
    gen = torch.Generator(device=plan.packed.device)
    gen.manual_seed(seed)
    D = plan.num_devices
    return torch.randint(0, 2 ** 31, (D, D, plan.nc_pad, trials, plan.chunk),
                         dtype=torch.int32, generator=gen,
                         device=plan.packed.device)


def sharded_bpr(plan, state, W, H, bits, order, rates, *, soft_margin, wbpr,
                bitmask, plain=False):
    """One sharded BPR epoch on copies of the whole tables over the rig
    mesh; returns (W, H, negatives [d][k])."""
    from mymedialite_tpu_torch.ops import bpr_epoch as be
    mesh = rig_mesh(plan.num_devices)
    Ws, Hs = mesh.shard_rows(W.clone()), mesh.shard_rows(H.clone())
    kw = dict(part_blocks=plan.part_blocks, user_block=plan.user_block,
              item_block=plan.item_block, soft_margin=soft_margin, wbpr=wbpr,
              return_negatives=True, plain=plain)
    if hasattr(plan, "slab_blocks"):
        _, _, negs = be.bpr_epoch_sharded_tiled(
            mesh, Ws, Hs, plan.packed, state["subkeys_tbl"], state["cdf_tbl"],
            bits, order, plan.cell_counts, rates,
            slab_blocks=plan.slab_blocks, **kw)
    else:
        _, _, negs = be.bpr_epoch_sharded(
            mesh, Ws, Hs, plan.packed, state["keys_tbl"], state["cdf_tbl"],
            bits, order, plan.cell_counts, rates,
            bitmask_tbl=state["bitmask_tbl"] if bitmask else None, **kw)
    return mesh.gather_rows(Ws), mesh.gather_rows(Hs), negs


def bpr_cells_in_turn(plan, state, W, H, bits, order, rates, *, soft_margin,
                      wbpr, bitmask):
    """The sharded BPR epoch's cells run in turn by the one-device kernel
    on views of copies of the whole tables, each with its partition's CDF
    rows and its negative blocks relative to the partition."""
    from mymedialite_tpu_torch.ops import bpr_epoch as be
    W, H = W.clone(), H.clone()
    D, upd, pr, PB = (plan.num_devices, plan.u_pad_dev, plan.part_rows,
                      plan.part_blocks)
    kw = dict(user_block=plan.user_block, item_block=plan.item_block,
              soft_margin=soft_margin, wbpr=wbpr, return_negatives=True)
    negs = [[None] * D for _ in range(D)]
    for d, p, cols in mesh_cells(plan, order):
        k = (p - d) % D
        Wd, Hp = W[d * upd:(d + 1) * upd], H[p * pr:(p + 1) * pr]
        cdf = state["cdf_tbl"][p * PB:(p + 1) * PB]
        b = bits[d, k, :cols[0].numel()]
        if hasattr(plan, "slab_blocks"):
            ub, ibr, isl, _, jbr, jsl, nval, bkt, row = cols
            _, _, negs[d][k] = be.bpr_epoch_tiled(
                Wd, Hp, plan.packed, state["subkeys_tbl"], cdf, b,
                (ub, ibr, isl, jsl * plan.slab_blocks + jbr, jbr, jsl, nval,
                 bkt, row), rates, slab_blocks=plan.slab_blocks,
                subkeys=True, **kw)
        else:
            ub, ib, jb, _, nval, bkt, row = cols
            _, _, negs[d][k] = be.bpr_epoch(
                Wd, Hp, plan.packed, state["keys_tbl"], cdf, b,
                (ub, ib, row), jb, nval, bkt, rates,
                bitmask_tbl=state["bitmask_tbl"] if bitmask else None, **kw)
    return W, H, negs


def same_negatives(a, b, what):
    for row_a, row_b in zip(a, b):
        for x, y in zip(row_a, row_b):
            if (x is None) != (y is None) or (
                    x is not None and not torch.equal(x, y)):
                raise AssertionError(f"{what}: sampled negatives differ")


def mesh_bpr_check(plan, state, W, H, bits, order, rates, *, what, **kw):
    """The sharded BPR epoch held to its cells in turn and to its plain
    version: identical negatives, tables within KERNEL_TOL. Returns (max
    error, kernel ms)."""
    (Wk, Hk, nk), k_ms = timed(lambda: sharded_bpr(plan, state, W, H, bits,
                                                   order, rates, **kw))
    Wc, Hc, nc = bpr_cells_in_turn(plan, state, W, H, bits, order, rates,
                                   **kw)
    Wr, Hr, nr = sharded_bpr(plan, state, W, H, bits, order, rates,
                             plain=True, **kw)
    same_negatives(nk, nc, f"{what}, cells in turn")
    same_negatives(nk, nr, what)
    err_cells = table_error((Wk, Hk), (Wc, Hc))
    err_plain = table_error((Wk, Hk), (Wr, Hr))
    log(f"{what}: negatives identical; against its cells in turn "
        f"max_abs_err {err_cells:.3e}, against the plain version "
        f"{err_plain:.3e} (tol {KERNEL_TOL}); kernel {k_ms:.2f} ms")
    check(err_cells, f"{what}, cells in turn")
    check(err_plain, what)
    return max(err_cells, err_plain), k_ms


def cells_line(plan) -> str:
    c = plan.cell_counts
    return (f"{plan.num_devices} devices, {int((c > 0).sum())} of "
            f"{c.size} cells non-empty, {plan.num_chunks} chunks, largest "
            f"cell {int(c.max())}")


def phase_mesh_kernel_check(dev):
    """(a) The four sharded epochs at phase 3/4's shape on rigs of 3 and
    4 devices (both with empty cells): on 4 every variant of phases 3 and
    4, on 3 the first. Returns the largest error of each kernel."""
    from mymedialite_tpu_torch.data.synthetic import (
        posonly_from_ratings, synthetic_ratings,
    )
    from mymedialite_tpu_torch.ops import bpr_plan
    from mymedialite_tpu_torch.ops import plan as mxu
    from mymedialite_tpu_torch.ops import sgd
    t0 = time.perf_counter()
    data = synthetic_ratings(**MESH_CHECK_SHAPE)
    feedback = posonly_from_ratings(data)
    U, I = data.num_users, data.num_items
    args = (data.users, data.items, data.values, U, I)
    rng = np.random.default_rng(5)
    tabs = (0.1 * rng.standard_normal((U, 40)),
            0.1 * rng.standard_normal((I, 40)),
            0.1 * rng.standard_normal(U), 0.1 * rng.standard_normal(I))
    bpr_rates = bpr_plan.bpr_mxu_column_rates(40, 64, 0.05, 0.0025, 0.0025,
                                              0.00025, 0.0, True, device=dev)
    worst = {}
    for D in (4, 3):
        every = D == MESH_DEVICES
        plans = {
            "sgd_epoch": mxu.prepare_mxu_sharded(
                *args, D, chunk=640, shuffle_seed=4, device=dev),
            "sgd_epoch_tiled": mxu.prepare_mxu_sharded_tiled(
                *args, D, chunk=None, slab_blocks=1, shuffle_seed=4,
                device=dev)}
        for name, plan in plans.items():
            if not (plan.cell_counts == 0).any():
                raise AssertionError(f"{name} on {D} devices: no empty cell")
            W, H = mxu.extend_tables_mxu(plan, *tabs)
            order = plan.epoch_order(6)
            variants = [(b, loss) for b in (True, False) for loss in (
                sgd.LOSS_RMSE, sgd.LOSS_MAE, sgd.LOSS_LOGISTIC)]
            for biased, loss in variants if every else variants[:1]:
                rates = mxu.mxu_column_rates(40, W.shape[1], 0.01, 0.015,
                                             0.015, 1.0, 0.01, biased, True,
                                             True, device=dev)
                hp = (0.6, 1.0, 4.0) if biased else (3.6, 1.0, 4.0)
                err, _ = mesh_sgd_check(
                    plan, W, H, order, hp, rates, loss=loss, biased=biased,
                    what=f"mesh {name} ({cells_line(plan)}) loss={loss} "
                         f"biased={biased}")
                worst[name] = max(worst.get(name, 0.0), err)
        plan, state, meta = bpr_plan.prepare_bpr_mxu_sharded(
            feedback, D, uniform_user=True, shuffle_seed=4, bitmask=True,
            device=dev)
        tplan, tstate, _ = bpr_plan.prepare_bpr_mxu_sharded_tiled(
            feedback, D, uniform_user=True, shuffle_seed=4, slab_blocks=1,
            device=dev)
        for name, p, st, variants in (
                ("bpr_epoch", plan, state,
                 [(h, w, b) for h, w in ((False, False), (True, False),
                                         (False, True))
                  for b in (False, True)]),
                ("bpr_epoch_tiled", tplan, tstate,
                 [(h, w, False) for h in (False, True)
                  for w in (False, True)])):
            W, H = bpr_tables(dev, p, feedback.num_users, feedback.num_items,
                              5)
            bits = cell_bits(p, meta[2], 7)
            for soft_margin, wbpr, bitmask in variants if every \
                    else variants[:1]:
                epoch_order = (bpr_plan.bpr_sharded_tiled_epoch_order
                               if name == "bpr_epoch_tiled"
                               else bpr_plan.bpr_sharded_epoch_order)
                order = epoch_order(p, st["nvalid"], 6 + wbpr,
                                    block_mass=(st["block_mass"] if wbpr
                                                else None))
                err, _ = mesh_bpr_check(
                    p, st, W, H, bits, order, bpr_rates,
                    soft_margin=soft_margin, wbpr=wbpr, bitmask=bitmask,
                    what=f"mesh {name} ({cells_line(p)}) soft_margin="
                         f"{soft_margin} wbpr={wbpr} membership="
                         f"{'bitmask' if bitmask else 'keys'}")
                worst[name] = max(worst.get(name, 0.0), err)
    mesh_save_load(dev, data, feedback)
    log(f"phase 24 (a) (the sharded kernels at phase 3's shape): "
        f"{time.perf_counter() - t0:.1f} s")
    return worst


def mesh_save_load(dev, data, feedback):
    """BiasedMatrixFactorization and BPRMF trained through the registry on
    the rig (2 epochs; the sharded route on 4 devices, the sharded-tiled
    one on 2 with the resident bound lowered to one item block), saved and
    loaded: the loaded model predicts as the trained one. At phase 3's
    shape: a model file at the Netflix shape holds 20M lines."""
    from mymedialite_tpu_torch.models.registry import (
        create_item_recommender, create_rating_predictor,
    )
    from mymedialite_tpu_torch.ops import plan as mxu
    users = np.arange(0, data.num_users, 7, dtype=np.int32)
    items = (users * 13 % data.num_items).astype(np.int32)
    bounds = mxu.RESIDENT_ITEM_TABLE_BYTES, mxu.TILED_SLAB_BYTES
    with tempfile.TemporaryDirectory() as tmp:
        for D, route in ((4, "sharded"), (2, "sharded-tiled")):
            if route == "sharded-tiled":
                # one 1,024-row block: two-block partitions pass it, slabs
                # of one block fit it
                mxu.RESIDENT_ITEM_TABLE_BYTES = mxu.TILED_SLAB_BYTES = \
                    1024 * mxu.fused_width(40) * 4
            try:
                for name, create, attr in (
                        ("BiasedMatrixFactorization", create_rating_predictor,
                         "ratings"),
                        ("BPRMF", create_item_recommender, "feedback")):
                    opts = f"num_factors=40 num_iter=2 device={dev.type}"
                    model = create(name, opts)
                    model.mesh = rig_mesh(D)
                    setattr(model, attr, data if attr == "ratings"
                            else feedback)
                    model.train()
                    got = model._route()
                    if got != route:
                        raise AssertionError(f"{name} on {D} devices took "
                                             f"{got}, not {route}")
                    path = os.path.join(tmp, f"{name}-{D}.model")
                    before = model.predict_batch(users, items)
                    model.save_model(path)
                    loaded = create(name, opts)
                    setattr(loaded, attr, data if attr == "ratings"
                            else feedback)
                    loaded.load_model(path)
                    after = loaded.predict_batch(users, items)
                    if not np.array_equal(before, after):
                        raise AssertionError(
                            f"{name} ({route}): save -> load changed "
                            f"{int((before != after).sum())} predictions")
                    log(f"mesh {name} on {D} devices ({route}): save -> "
                        f"load keeps all {len(users)} predictions")
            finally:
                mxu.RESIDENT_ITEM_TABLE_BYTES, mxu.TILED_SLAB_BYTES = bounds


@contextlib.contextmanager
def timed_cells():
    """CUDA events around each cell of the sharded epochs inside the block
    (``parallel/mesh.py diagonal_epoch``'s calls of its ``run_cell``);
    yields a list that holds each cell's ms afterwards."""
    from mymedialite_tpu_torch.parallel import mesh as mesh_module
    real = mesh_module.diagonal_epoch
    events = []

    def timed_epoch(mesh, H_parts, order, counts, run_cell):
        def cell(*a):
            s, e = torch.cuda.Event(enable_timing=True), \
                torch.cuda.Event(enable_timing=True)
            s.record()
            run_cell(*a)
            e.record()
            events.append((s, e))
        return real(mesh, H_parts, order, counts, cell)

    mesh_module.diagonal_epoch = timed_epoch
    out = []
    try:
        yield out
    finally:
        mesh_module.diagonal_epoch = real
    torch.cuda.synchronize()
    out.extend(s.elapsed_time(e) for s, e in events)


def imbalance(cell_ms, cells_per_epoch: int) -> float:
    """The mean over epochs of the largest cell's ms over the mean
    cell's: the pace a mesh of cards would keep against its average."""
    ms = np.asarray(cell_ms).reshape(-1, cells_per_epoch)
    return float(np.mean(ms.max(axis=1) / ms.mean(axis=1)))


def mesh_model(dev, kind, data, *, iters: int, label: str, route: str,
               tables=None, name=None, mesh=None):
    """A model of ``kind`` ("mf" or "bpr") trained through the registry on
    the rig mesh (or on ``mesh``, which may be ``DEFAULT_MESH``) for
    ``iters`` epochs on ``route``: its kernel, and only it, launches once
    per non-empty cell per epoch. Returns (model, epoch ms, cell ms)."""
    from mymedialite_tpu_torch.models import bpr as bpr_module
    from mymedialite_tpu_torch.models import mf as mf_module
    from mymedialite_tpu_torch.models.registry import (
        create_item_recommender, create_rating_predictor,
    )
    from mymedialite_tpu_torch.ops import bpr_plan
    from mymedialite_tpu_torch.ops import plan as mxu
    tiled = route == "sharded-tiled"
    opts = f"num_factors=40 num_iter={iters} device={dev.type}"
    if kind == "mf":
        model = create_rating_predictor("BiasedMatrixFactorization", opts)
        model.ratings = data
        kernel = "sgd_epoch_tiled" if tiled else "sgd_epoch"
        prepare = (mxu, "prepare_mxu_sharded_tiled" if tiled
                   else "prepare_mxu_sharded")
        epoch = (mf_module, "sgd_epoch_sharded_tiled" if tiled
                 else "sgd_epoch_sharded")
    else:
        model = create_item_recommender(name or "BPRMF", opts)
        model.feedback = data
        kernel = "bpr_epoch_tiled" if tiled else "bpr_epoch"
        prepare = (bpr_plan, "prepare_bpr_mxu_sharded_tiled" if tiled
                   else "prepare_bpr_mxu_sharded")
        epoch = (bpr_module, "bpr_epoch_sharded_tiled" if tiled
                 else "bpr_epoch_sharded")
    model.mesh = rig_mesh() if mesh is None else mesh
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    expected = {}
    with timed_training(prepare, epoch) as timings, \
            counted_path(expected) as counted, \
            timed_cells() as cell_ms:
        t0 = time.perf_counter()
        if tables is None:
            model.train()
        else:
            model.init_model(tables=tables)
            for _ in range(iters):
                model.iterate()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        plan = model._plan
        nonempty = int((plan.cell_counts > 0).sum())
        expected[kernel] = nonempty * iters
    if model._route() != route:
        raise AssertionError(f"{label}: {model._route()}, not {route}")
    tiled_line = (f", {plan.slabs_per_part} slabs of {plan.slab_blocks} "
                  f"blocks a partition" if tiled else "")
    epoch_ms = float(np.mean(timings["epoch_ms"]))
    log(f"{label} on the rig ({route}): train {train_s:.2f} s; plan prep "
        f"{timings['plan_s'][0]:.2f} s ({cells_line(plan)}, {plan.ub_per_dev} "
        f"user blocks a device, {plan.part_blocks} item blocks a "
        f"partition{tiled_line}); {kernel} launches {counted[kernel]} "
        f"({nonempty} cells x {iters} epochs); epochs "
        f"{', '.join(f'{t:.1f}' for t in timings['epoch_ms'])} ms; cells "
        f"{min(cell_ms):.2f}-{max(cell_ms):.2f} ms, largest over mean "
        f"{imbalance(cell_ms, nonempty):.3f}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return model, epoch_ms, cell_ms


def sampled_cells(plan, order, per_cell: int, seed: int):
    """A sub-schedule of the sharded epoch ``order``: in each cell,
    ``per_cell`` of its chunks drawn at random (seeded), kept in the
    order's sequence, so that the draw spreads over every user block,
    item block, slab and negative block of the cell, where a prefix would
    stay in the first ones. A walk over a subsequence of an order is
    still a walk (the kernels take any order). Returns (the plan with
    those cells, the [D, D, n] order)."""
    rng = np.random.default_rng(seed)
    D = plan.num_devices
    keep = [[np.sort(rng.choice(int(n), min(per_cell, int(n)), replace=False))
             for n in row] for row in plan.cell_counts]
    width = max(max(k.size for k in row) for row in keep)
    out = []
    for a in order:
        sub = np.zeros((D, D, width), a.dtype)
        for d in range(D):
            for k in range(D):
                sel = keep[d][k]
                if sel.size:
                    sub[d, k, :sel.size] = a[d, k, sel]
                    sub[d, k, sel.size:] = a[d, k, sel[-1]]
        out.append(sub)
    cells = [[out[-1][d, k, :keep[d][k].size].astype(np.int64)
              for k in range(D)] for d in range(D)]
    return dataclasses.replace(plan, cells=cells), tuple(out)


def sample_reach(plan, order, sub, sub_order, bpr: bool) -> str:
    """How far the sampled cells (``sub``, ``sub_order``) reach into the
    epoch's (``plan``, ``order``): the largest partition-relative item
    block (or slab) and negative block (or slab) of each, and the
    partitions. Raises where the epoch goes past a cell's first block
    (or slab) and the draw does not."""
    D = plan.num_devices
    tiled = hasattr(plan, "slab_blocks")
    cols = ({"slab": 2, "negative slab": 5} if tiled
            else {"item block": 1, "negative block": 2})
    if not bpr:
        cols.pop("negative slab" if tiled else "negative block")

    def top(p, o, col):
        c = p.cell_counts
        return max(int(o[col][d, k, :c[d, k]].max()) for d in range(D)
                   for k in range(D) if c[d, k])

    parts = sorted({(d + k) % D for d in range(D) for k in range(D)
                    if sub.cell_counts[d, k]})
    out = [f"partitions {parts}"]
    for what, col in cols.items():
        got, avail = top(sub, sub_order, col), top(plan, order, col)
        if avail > 0 and got == 0:
            raise AssertionError(f"the sampled cells reach no {what} past "
                                 f"a cell's first (the epoch's go to {avail})")
        out.append(f"{what} up to {got} (epoch {avail})")
    return ", ".join(out)


def mesh_model_check(model, kind: str, label: str) -> float:
    """One more epoch of the trained mesh model (``kind`` "mf" or "bpr"),
    from its tables, rates and sampling state, its kernel held to its
    cells in turn and to its plain version (``mesh_sgd_check`` /
    ``mesh_bpr_check``: BPR negatives identical, tables within
    KERNEL_TOL) on PLAIN_PREFIX chunks drawn across all its cells
    (``sampled_cells``): the mesh's indexing at the main path's shape,
    the partition-relative item blocks, slabs and negative blocks past
    the first and the partitions' CDF rows. Returns the largest error."""
    from mymedialite_tpu_torch.ops import bpr_plan
    from mymedialite_tpu_torch.ops.plan import fused_width
    plan, mesh = model._plan, model._mesh
    Ws, Hs = model._mxu_tables
    W, H = mesh.gather_rows(Ws), mesh.gather_rows(Hs)
    per_cell = max(PLAIN_PREFIX // int((plan.cell_counts > 0).sum()), 1)
    if kind == "mf":
        order = plan.epoch_order(11)
        sub, sub_order = sampled_cells(plan, order, per_cell, 12)
        reach = sample_reach(plan, order, sub, sub_order, bpr=False)
        hp = (model.global_bias, model.min_rating, model._rating_range())
        err, _ = mesh_sgd_check(
            sub, W, H, sub_order, hp, model._epoch_rates(True, True),
            loss=model.loss_id, biased=model.BIASED,
            what=f"{label}, {int(sub.cell_counts.sum())} chunks drawn "
                 f"across its cells ({reach})")
        return err
    state = model._neg_state
    wbpr = model.MXU_POPULARITY
    epoch_order = (bpr_plan.bpr_sharded_tiled_epoch_order
                   if hasattr(plan, "slab_blocks")
                   else bpr_plan.bpr_sharded_epoch_order)
    order = epoch_order(plan, state["nvalid"], 11,
                        block_mass=state["block_mass"] if wbpr else None)
    sub, sub_order = sampled_cells(plan, order, per_cell, 12)
    reach = sample_reach(plan, order, sub, sub_order, bpr=True)
    f = model.num_factors
    rates = bpr_plan.bpr_mxu_column_rates(
        f, fused_width(f), model.learn_rate, model.reg_u, model.reg_i,
        model.reg_j, model.bias_reg, model.update_j,
        device=plan.packed.device)
    err, _ = mesh_bpr_check(
        sub, state, W, H, cell_bits(sub, model._neg_meta[2], 13), sub_order,
        rates, soft_margin=model.SOFT_MARGIN, wbpr=wbpr,
        bitmask=state.get("bitmask_tbl") is not None,
        what=f"{label}, {int(sub.cell_counts.sum())} chunks drawn across "
             f"its cells ({reach})")
    return err


def picked_rows(shards, rows, per_shard: int):
    """Rows ``rows`` of a row-sharded table picked out of its shards: row
    g from shard g // per_shard, at g % per_shard."""
    rows = torch.as_tensor(rows, device=shards[0].device).long()
    out = shards[0].new_empty((rows.numel(), shards[0].shape[1]))
    for s, shard in enumerate(shards):
        sel = rows // per_shard == s
        out[sel] = shard[rows[sel] % per_shard].to(out.device)
    return out


def mesh_layout_check(model, kind: str, label: str):
    """The standard tables of the trained mesh model, as its prediction,
    save and incremental API read them (gathered by the model), held
    exactly to rows picked out of its shards: user u from W shard u //
    u_pad_dev, item i from partition new_of_old[i] // part_rows, in the
    shapes the standard tables had, so that no pad row of a shard or a
    partition leaks into them. At the main path's shape in place of a
    save -> load (a Netflix-shaped model file holds 20M lines)."""
    plan = model._plan
    Ws, Hs = model._mxu_tables
    if kind == "mf":
        rows, fe = model._mxu_std_shape
        nu = min(rows, plan.u_pad)
        W, H = model.W_ext, model.H_ext
        got = {"W": (W.shape, W[:nu]), "H": (H.shape, H)}
        want = {"W": ((rows, fe), picked_rows(Ws, np.arange(nu),
                                              plan.u_pad_dev)[:, :fe]),
                "H": ((plan.num_items, fe), picked_rows(
                    Hs, plan.new_of_old, plan.part_rows)[:, :fe])}
    else:
        f, nu = model.num_factors, model._mxu_num_users
        Hp = picked_rows(Hs, plan.new_of_old, plan.part_rows)
        p = model.params
        got = {k: (p[k].shape, p[k]) for k in ("user_factors", "item_factors",
                                               "item_bias")}
        want = {"user_factors": ((nu, f), picked_rows(
                    Ws, np.arange(nu), plan.u_pad_dev)[:, :f]),
                "item_factors": ((plan.num_items, f), Hp[:, :f]),
                "item_bias": ((plan.num_items,), Hp[:, f])}
    for name, (shape, table) in got.items():
        want_shape, want_rows = want[name]
        if tuple(shape) != tuple(want_shape):
            raise AssertionError(f"{label}: {name} gathered as {tuple(shape)}"
                                 f", not {tuple(want_shape)}")
        if not torch.equal(table, want_rows):
            raise AssertionError(f"{label}: {name} differs from the rows "
                                 "picked out of the shards")
    log(f"{label}: the gathered tables equal the rows picked out of the "
        f"shards ({', '.join(f'{k} {tuple(v[0])}' for k, v in got.items())}"
        f"; {plan.u_pad} user rows and {plan.i_pad} item rows sharded)")


def phase_mesh_netflix(dev, train, test, mf_run, bpr_run, bpr_feedback):
    """(b) BiasedMatrixFactorization and BPRMF on phase 6's data, 3 epochs
    each on the rig mesh ("sharded": kernels 1 and 3 once per cell), each
    then held to its plain version across its cells (``mesh_model_check``)
    and its gathered tables to its shards (``mesh_layout_check``), RMSE
    and AUC beside phases 7 and 8; one MultiCoreBPRMF.iterate() on the
    mesh from the mesh BPRMF's tables (kernel 3). Returns the largest
    error of kernels 1 and 3."""
    from mymedialite_tpu_torch.eval.rating import evaluate_ratings
    t0 = time.perf_counter()
    worst = {}
    label = "mesh BiasedMF Netflix-shaped"
    model, epoch_ms, _ = mesh_model(dev, "mf", train, iters=3, label=label,
                                    route="sharded")
    worst["sgd_epoch"] = mesh_model_check(model, "mf", label)
    mesh_layout_check(model, "mf", label)
    res = evaluate_ratings(model, test, train)
    baseline = global_average_rmse(train, test)
    log(f"mesh BiasedMF Netflix-shaped eval: {res}; one device (phase 7) "
        f"RMSE {mf_run['test_rmse']:.5f}, epoch {mf_run['epoch_ms']:.1f} ms "
        f"against {epoch_ms:.1f} ms on the rig; global-average RMSE "
        f"{baseline:.5f}")
    if not (math.isfinite(res["RMSE"]) and res["RMSE"] < baseline):
        raise AssertionError("mesh BiasedMF RMSE does not beat the global "
                             "average")
    del model
    label = "mesh BPRMF Netflix-shaped"
    model, epoch_ms, _ = mesh_model(dev, "bpr", bpr_feedback, iters=3,
                                    label=label, route="sharded")
    worst["bpr_epoch"] = mesh_model_check(model, "bpr", label)
    mesh_layout_check(model, "bpr", label)
    auc = sampled_ranking_eval(model, bpr_feedback, bpr_run["test"],
                               "mesh BPRMF")["AUC"]
    log(f"mesh BPRMF Netflix-shaped: AUC {auc:.5f}; one device (phase 8) "
        f"AUC {bpr_run['auc']:.5f}, epoch {bpr_run['epoch_ms']:.1f} ms "
        f"against {epoch_ms:.1f} ms on the rig")
    if not auc > 0.6:
        raise AssertionError(f"mesh BPRMF AUC {auc} <= 0.6")
    tables = {k: v.clone() for k, v in model.params.items()}
    del model
    mesh_model(dev, "bpr", bpr_feedback, iters=1, tables=tables,
               name="MultiCoreBPRMF", label="mesh MultiCoreBPRMF, one "
               "iterate()", route="sharded")
    log(f"phase 24 (b) (the mesh, Netflix-shaped): "
        f"{time.perf_counter() - t0:.1f} s")
    return worst


def phase_mesh_big_catalog(dev, train, test, mf_blocked, bpr_minibatch):
    """(c) BiasedMatrixFactorization and BPRMF on phase 20's big catalog on
    the rig mesh: "sharded-tiled", kernels 2 and 4 once per cell, where one
    device takes the minibatch epochs; each model then held to its plain
    version across its cells and its gathered tables to its shards, as in
    (b); RMSE under the global average, AUC of AUC_USERS seeded users
    above 0.5, beside phase 20's. Returns the largest error of kernels 2
    and 4."""
    from mymedialite_tpu_torch.data.synthetic import posonly_from_ratings
    from mymedialite_tpu_torch.eval.ranking import evaluate_items
    from mymedialite_tpu_torch.eval.rating import evaluate_ratings
    t0 = time.perf_counter()
    worst = {}
    label = "mesh BiasedMF big-catalog"
    model, epoch_ms, _ = mesh_model(
        dev, "mf", train, iters=MESH_BIG_EPOCHS, label=label,
        route="sharded-tiled")
    worst["sgd_epoch_tiled"] = mesh_model_check(model, "mf", label)
    mesh_layout_check(model, "mf", label)
    res = evaluate_ratings(model, test, train)
    baseline = global_average_rmse(train, test)
    log(f"mesh BiasedMF big-catalog eval: {res}; one device (phase 20, "
        f"blocked, 3 epochs) RMSE {mf_blocked['rmse']:.5f}, epoch "
        f"{mf_blocked['epoch_ms']:.1f} ms against {epoch_ms:.1f} ms on the "
        f"rig; global-average RMSE {baseline:.5f}")
    if not (math.isfinite(res["RMSE"]) and res["RMSE"] < baseline):
        raise AssertionError("mesh big-catalog BiasedMF RMSE does not beat "
                             "the global average")
    del model
    torch.cuda.empty_cache()
    train, test = posonly_from_ratings(train), posonly_from_ratings(test)
    label = "mesh BPRMF big-catalog"
    model, epoch_ms, _ = mesh_model(
        dev, "bpr", train, iters=MESH_BIG_EPOCHS, label=label,
        route="sharded-tiled")
    worst["bpr_epoch_tiled"] = mesh_model_check(model, "bpr", label)
    mesh_layout_check(model, "bpr", label)
    rng = np.random.default_rng(9)
    users = np.sort(rng.choice(test.all_users, AUC_USERS, replace=False))
    res = evaluate_items(model, test, train, test_users=users, batch_size=128)
    log(f"mesh BPRMF big-catalog: ranking eval of {res['num_users']} users: "
        f"{res}; one device (phase 20, minibatch, 3 epochs) AUC "
        f"{bpr_minibatch['auc']:.5f}, epoch {bpr_minibatch['epoch_ms']:.1f} "
        f"ms against {epoch_ms:.1f} ms on the rig")
    if not (math.isfinite(res["AUC"]) and res["AUC"] > 0.5):
        raise AssertionError(f"mesh big-catalog BPRMF AUC {res['AUC']} <= 0.5")
    del model
    torch.cuda.empty_cache()
    log(f"phase 24 (c) (the mesh, big catalog): "
        f"{time.perf_counter() - t0:.1f} s")
    return worst


# ---------------------------------------------------------------------------
# phase 25: the plain-PyTorch mesh routes (no kernel of csrc/ on them)
# ---------------------------------------------------------------------------

PLAIN_MESH_TOL = 1e-5      # each op on the rig against the CPU's
WRMF_MESH_TOL = 1e-6       # the sharded solves against one device's
BPR_WINDOW = 8             # sharded steps held to the CPU, big catalog
MESH_SVDPP_GROUP = 128     # the Netflix shape's SVD++ groups on the rig


def table_gap(a: dict, b: dict) -> float:
    """``table_distance`` over the tables of two dicts; raises where the
    first holds a non-finite entry."""
    for k, t in a.items():
        if not torch.isfinite(t).all():
            raise AssertionError(f"non-finite {k}")
    return table_distance([a[k] for k in a], [b[k] for k in a])


def plain_check(err, what, tol=PLAIN_MESH_TOL):
    log(f"{what}: max_abs_err {err:.3e} (tol {tol})")
    if not err <= tol:
        raise AssertionError(f"{what}: {err} past {tol}")


# the driver's data: phase 3's shape (``parallel/driver.py SHAPES``)
DRIVER_SHAPE = "check"
# the two ranks against the one-process rig run, route by route: kernels
# 1-4's float atomics fix no order of a sum; the plain routes keep the
# tolerances of (a) (WRMF's solves and the blocked epoch, 1e-6)
DRIVER_TOL = dict(blocked=1e-6, wrmf=WRMF_MESH_TOL)
KERNEL_CELL_TOL = 1e-4     # a rank's kernel cells against its plain cells


def start_driver_pair(device: str):
    """The two ranks of the multi-process driver (``parallel/driver.py``
    dist, every route) and its one-process 4-device run (``single``),
    started together in the background: (processes, port, output
    paths), the ranks' first."""
    import socket
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    tmp = tempfile.mkdtemp(prefix="mml-driver-")
    outs = [os.path.join(tmp, f"{n}.npz") for n in ("p0", "p1", "ref")]
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX_")}
    modes = [("dist", 0), ("dist", 1), ("single", 0)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mymedialite_tpu_torch.parallel.driver",
         mode, str(port), str(pid), out, "--device", device, "--shape",
         DRIVER_SHAPE], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=env) for (mode, pid), out in zip(modes, outs)]
    return procs, port, outs


def finish_driver_pair(procs, port, outs, device: str):
    """(d) Wait for the two ranks (gloo, 2 devices each) and the
    one-process run on 4; every route three ways: the ranks equal bit for
    bit, the ranks against the one-process run (``DRIVER_TOL``, else 1e-5),
    each rank's kernel cells against its plain cells over the same ring
    (``KERNEL_CELL_TOL``; the negatives identical, checked in the rank).
    Logs each rank's cells launched and ms per route."""
    from mymedialite_tpu_torch.parallel.driver import (
        KERNEL_ROUTES, ROUTES, compare,
    )
    try:
        texts = [p.communicate(timeout=600)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, text, who in zip(procs, texts, ("rank 0", "rank 1", "single")):
        if p.returncode != 0 or "driver-ok" not in text:
            raise AssertionError(f"driver {who} failed:\n{text[-3000:]}")
    a, b, r = (np.load(x) for x in outs)
    shutil.rmtree(os.path.dirname(outs[0]), ignore_errors=True)
    card = card_line() if device.startswith("cuda") else device
    result = compare([a, b], r)
    if sorted(result) != sorted(ROUTES):
        raise AssertionError(f"driver routes {sorted(result)}")
    for route in ROUTES:
        equal, gap = result[route]
        tol = DRIVER_TOL.get(route, PLAIN_MESH_TOL)
        parts = [f"ranks equal bit for bit {equal}",
                 f"against the one-process 4-device run {gap:.3e} (tol "
                 f"{tol})"]
        for i, rank in enumerate((a, b)):
            part = f"rank {i} {float(rank[f'ms/{route}']):.1f} ms"
            if route in KERNEL_ROUTES:
                part += (f", {int(rank[f'launches/{route}'])} cells of "
                         f"{KERNEL_ROUTES[route]}")
            if f"plain_err/{route}" in rank.files:
                err = float(rank[f"plain_err/{route}"])
                part += f", cells vs plain {err:.3e} (tol {KERNEL_CELL_TOL})"
                if not err <= KERNEL_CELL_TOL:
                    raise AssertionError(f"driver {route} rank {i}: cells "
                                         f"vs plain {err}")
            parts.append(part)
        parts.append(f"one process {float(r[f'ms/{route}']):.1f} ms")
        log(f"two gloo processes, each a mesh of [{device}] x 2 ({card}), "
            f"route {route}: " + "; ".join(parts))
        if not equal:
            raise AssertionError(f"driver {route}: the two ranks disagree")
        if not gap <= tol:
            raise AssertionError(f"driver {route}: two processes vs one: "
                                 f"{gap} > {tol}")
    if device.startswith("cuda"):
        for route, kernel in KERNEL_ROUTES.items():
            if not all(int(x[f"launches/{route}"]) > 0 for x in (a, b)):
                raise AssertionError(f"driver {route}: a rank launched no "
                                     f"cell of {kernel}")
    log(f"two processes on gloo, each a mesh of [{device}] x 2: every "
        f"route's ranks equal bit for bit and within tolerance of one "
        f"process ({len(ROUTES)} routes)")


def phase_plain_mesh_check(dev):
    """(a) and (d): at phase 3's shape each plain mesh op on the rig
    against the same op on a CPU mesh from the same inputs (1e-5): the
    sharded SVD++ epoch, the sharded BPR steps on fixed triples, the
    sharded blocked MF epoch, the data-parallel ranking eval; the WRMF
    sharded solves against one device's on the card (1e-6); the dry run
    on the rig; the driver's two processes on gloo, every route. Returns
    the seconds."""
    from mymedialite_tpu_torch import dryrun
    from mymedialite_tpu_torch.data.synthetic import (
        posonly_from_ratings, split_ratings, synthetic_ratings,
    )
    from mymedialite_tpu_torch.eval.ranking import evaluate_items
    from mymedialite_tpu_torch.models.registry import create_item_recommender
    from mymedialite_tpu_torch.ops import als, bpr, sgd, svdpp
    from mymedialite_tpu_torch.parallel.mesh import make_mesh
    t0 = time.perf_counter()
    device = f"cuda:{torch.cuda.current_device()}" \
        if dev.type == "cuda" else "cpu"
    pair = start_driver_pair(device)
    rig, cpu = rig_mesh(), make_mesh(devices=["cpu"] * MESH_DEVICES)
    D = rig.size
    data = synthetic_ratings(**MESH_CHECK_SHAPE)
    U, I = data.num_users, data.num_items
    rng = np.random.default_rng(25)

    def normal(*shape):
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    def on(tables, d):
        return {k: torch.from_numpy(v.copy()).to(d)
                for k, v in tables.items()}

    # the sharded grouped SVD++ epoch
    hu, hi = svdpp.history_edges(data.users, data.items, I)
    groups = svdpp.prepare_groups(data.users, data.items, data.values, hu,
                                  hi, U, 64, pad_groups_multiple=D)
    tables = dict(user_bias=normal(U), p=normal(U, 20), item_bias=normal(I),
                  item_factors=normal(I, 20), y=normal(I, 20))
    regs = dict(user_reg=np.full(U, 0.015, np.float32),
                item_reg=np.full(I, 0.015, np.float32),
                y_reg=np.full(I, 0.015, np.float32))
    inv = svdpp.inv_sqrt_counts(hu, U)
    hp = dict(global_bias=float(data.average), learn_rate=0.003,
              bias_learn_rate=0.7, bias_reg=0.33, min_rating=1.0,
              rating_range=4.0)
    runs = []
    for mesh, d in ((rig, dev), (cpu, torch.device("cpu"))):
        params = on(tables, d)
        _, ms = timed(lambda: svdpp.svdpp_epoch_sharded(
            mesh, params, groups.to(d), torch.from_numpy(inv).to(d), hp,
            on(regs, d), loss=0, sigmoid=False, use_p=True))
        runs.append((params, ms))
    plain_check(table_gap(runs[0][0], runs[1][0]),
                f"sharded SVD++ epoch ({groups.ngroups} groups of 64 on "
                f"{D} devices, k=20) on the rig, {runs[0][1]:.1f} ms, vs "
                f"the CPU's")

    # WRMF's sharded solves against one device's, on the card
    fb = posonly_from_ratings(data)
    counts = fb.by_user.counts()
    L, chunk = int(counts.max()), 256
    rows = -(-U // (chunk * D)) * chunk * D
    hist = np.zeros((rows, L), np.int64)
    for u in range(U):
        hist[u, :counts[u]] = fb.by_user.secondary(u)
    lens = np.zeros(rows, np.int64)
    lens[:U] = counts
    H = torch.from_numpy(normal(I, 40)).to(dev)
    args = (H, torch.from_numpy(hist).to(dev), torch.from_numpy(lens).to(dev),
            1.0, 0.015)
    # each call once before it is timed: the first solve sets up the
    # solver, which would otherwise land in the one-device time
    solve_one = lambda: als.wrmf_optimize(*args, chunk=chunk)  # noqa: E731
    solve_rig = lambda: als.wrmf_optimize_sharded(  # noqa: E731
        rig, *args, chunk=chunk)
    solve_one(), solve_rig()
    one, one_ms = timed(solve_one)
    many, many_ms = timed(solve_rig)
    plain_check((one - many).abs().max().item(),
                f"WRMF sharded solves ({rows} rows of 40 x 40, {D} devices, "
                f"warm, {many_ms:.1f} ms) vs one device's (warm, "
                f"{one_ms:.1f} ms)", WRMF_MESH_TOL)

    # the sharded BPR steps on fixed triples
    sdata, smeta = bpr.make_sampler_data_sharded(fb, D)
    samplers = bpr.device_samplers(cpu, sdata, smeta)
    gens = [torch.Generator().manual_seed(40 + d) for d in range(D)]
    steps = [[bpr.sample_triples_sharded(gens[d], samplers[d], smeta, 4096,
                                         bpr.UNIFORM_USER)
              for d in range(D)] for _ in range(BPR_WINDOW)]
    btables = dict(user_factors=normal(smeta["u_loc"] * D, 40),
                   item_factors=normal(I, 40), item_bias=normal(I))
    bhp = dict(learn_rate=0.05, reg_u=0.0025, reg_i=0.0025, reg_j=0.00025,
               bias_reg=0.0)
    runs = []
    for mesh, d in ((rig, dev), (cpu, torch.device("cpu"))):
        t = on(btables, d)
        W = mesh.shard_rows(t["user_factors"])
        Hr, br = mesh.replicate(t["item_factors"]), mesh.replicate(
            t["item_bias"])

        def go():
            nonlocal Hr, br
            for step in steps:
                Hr, br = bpr.bpr_step_sharded(
                    mesh, W, Hr, br, [tuple(x.to(d) for x in tr)
                                      for tr in step], bhp, update_j=True)
        _, ms = timed(go)
        t["user_factors"] = mesh.gather_rows(W)
        t["item_factors"], t["item_bias"] = Hr[0], br[0]
        runs.append((t, ms))
    plain_check(table_gap(runs[0][0], runs[1][0]),
                f"sharded BPR steps ({BPR_WINDOW} of {D} x 4,096 fixed "
                f"triples, k=40) on the rig, {runs[0][1]:.1f} ms, vs the "
                f"CPU's")

    # the sharded blocked MF epoch
    G = -(-U // (2 * D))
    bdata, meta = sgd.prepare_blocked_data(data.users, data.items,
                                           data.values, U, batch_size=1024,
                                           group_users=G, shuffle_seed=4)
    nb = meta["l_pad"] // meta["batch"]
    orders = np.stack([rng.permutation(nb)
                       for _ in range(meta["ngroups"] // D)])
    We, He = sgd.extend_tables(normal(U, 40), normal(I, 40), normal(U),
                               normal(I), group_users=G)
    rates = sgd.column_rates(40, 0.01, 0.015, 0.015, 1.0, 0.01, True, True,
                             True)
    runs = []
    for mesh, d in ((rig, dev), (cpu, torch.device("cpu"))):
        W, Hm = We.clone().to(d), He.clone().to(d)
        local = {k: (v.to(d) if torch.is_tensor(v) else v)
                 for k, v in bdata.items()}
        _, ms = timed(lambda: sgd.sgd_epoch_blocked_sharded(
            mesh, W, Hm, local, orders, (float(data.average), 1.0, 4.0),
            tuple(r.to(d) for r in rates), meta=meta, loss=0, biased=True))
        runs.append((dict(W=W, H=Hm), ms))
    plain_check(table_gap(runs[0][0], runs[1][0]),
                f"sharded blocked MF epoch ({meta['ngroups']} groups of {G} "
                f"on {D} devices, k=40) on the rig, {runs[0][1]:.1f} ms, vs "
                f"the CPU's")

    # the data-parallel ranking eval: on the rig, on one device, on the CPU
    train, test = split_ratings(data, 0.2, seed=2)
    train, test = posonly_from_ratings(train), posonly_from_ratings(test)
    lines = {}
    for name, d, mesh in (("one device", dev, None), ("rig", dev, rig),
                          ("CPU mesh", torch.device("cpu"), cpu)):
        model = create_item_recommender(
            "WRMF", f"num_factors=40 num_iter=1 regularization=100 "
            f"device={d.type}")
        model.feedback = train
        model.init_model(tables=dict(user_factors=btables["user_factors"][
            :train.num_users], item_factors=btables["item_factors"][
            :train.num_items]))
        model.mesh = mesh
        res = evaluate_items(model, test, train)
        lines[name] = res
    log(f"data-parallel ranking eval on the rig: {lines['rig']}; one device: "
        f"{lines['one device']}; CPU mesh: {lines['CPU mesh']}")
    if str(lines["rig"]) != str(lines["one device"]):
        raise AssertionError("the data-parallel eval's line differs from one "
                             "device's")
    gap = max(abs(lines["rig"][k] - lines["CPU mesh"][k])
              for k in ("AUC", "MAP", "NDCG", "MRR", "prec@5", "recall@10"))
    plain_check(gap, "data-parallel ranking eval, rig vs CPU mesh")

    with contextlib.redirect_stdout(io.StringIO()) as dry:
        dryrun.dryrun_multichip(D, [device] * D)
    log(dry.getvalue().strip().splitlines()[-1])
    finish_driver_pair(*pair, device)
    seconds = time.perf_counter() - t0
    log(f"phase 25 (a), (d) (the plain mesh routes, phase 3's shape): "
        f"{seconds:.1f} s")
    return seconds


def phase_plain_mesh_netflix(dev, train, test, svdpp_model, wrmf_train,
                             wrmf_test):
    """(b) At the Netflix shape on the rig: SVDPlusPlus (k=20, learn rate
    0.003, transductive, 2 epochs) with ``model.mesh`` on the sharded
    grouped epoch: ms per epoch and per group step, the largest device's
    ratings over the mean, RMSE beside phase 11's kernel route (groups
    of MESH_SVDPP_GROUP users: D of them hold one device's default
    group); WRMF
    (2 alternations) with ``model.mesh``: ms per side, the user side
    re-solved from the trained item factors on the mesh against one
    device's (1e-6), 1,024 users served through kernel 6 against the
    plain version, the data-parallel ranking eval's line equal to one
    device's. No epoch kernel runs. Returns the seconds."""
    from mymedialite_tpu_torch.eval.ranking import evaluate_items
    from mymedialite_tpu_torch.eval.rating import evaluate_ratings
    from mymedialite_tpu_torch.models import svdpp as svdpp_module
    from mymedialite_tpu_torch.models.registry import (
        create_item_recommender, create_rating_predictor,
    )
    from mymedialite_tpu_torch.ops import als
    from mymedialite_tpu_torch.ops.catalog_topk import topk_reference
    from mymedialite_tpu_torch.ops.topk import recommend_batch
    t0 = time.perf_counter()
    rig = rig_mesh()
    # groups of MESH_SVDPP_GROUP users: a step merges D groups' y deltas,
    # so D of them take one device's default group (512 users here); the
    # default size diverges on the mesh, in both packages (ROADMAP C)
    model = create_rating_predictor(
        "SVDPlusPlus", f"num_factors=20 num_iter=2 learn_rate=0.003 "
        f"group_users={MESH_SVDPP_GROUP} device={dev.type}")
    model.mesh = rig
    model.ratings = train
    model.additional_feedback = (test.users, test.items)
    torch.cuda.empty_cache()
    with timed_training((svdpp_module, "prepare_groups"),
                        (svdpp_module, "svdpp_epoch_sharded")) as timings, \
            counted_path({}):
        t1 = time.perf_counter()
        model.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t1
    if model.route() != "sharded":
        raise AssertionError(f"SVD++ on the rig took {model.route()}")
    shards = model._shards[1]
    per_device = np.array([int(g.r_off[-1]) for g in shards], np.float64)
    epoch_ms = float(np.mean(timings["epoch_ms"]))
    res = evaluate_ratings(model, test, train)
    kernel_rmse = evaluate_ratings(svdpp_model, test, train)["RMSE"]
    baseline = global_average_rmse(train, test)
    log(f"mesh SVDPlusPlus Netflix-shaped on the rig (sharded grouped "
        f"epoch): train {train_s:.2f} s, groups {timings['plan_s'][0]:.2f} "
        f"s ({model._groups.ngroups} groups of {model._groups.group_users} "
        f"users, {shards[0].ngroups} steps of {rig.size} groups); epochs "
        f"{', '.join(f'{t:.1f}' for t in timings['epoch_ms'])} ms, "
        f"{epoch_ms / shards[0].ngroups:.2f} ms a group step; largest "
        f"device's ratings over the mean "
        f"{per_device.max() / per_device.mean():.3f}; {res}; one device "
        f"(phase 11, kernel route, 3 epochs) RMSE {kernel_rmse:.5f}; "
        f"global-average RMSE {baseline:.5f}")
    if not (math.isfinite(res["RMSE"]) and res["RMSE"] < baseline):
        raise AssertionError("mesh SVD++ RMSE does not beat the global "
                             "average")
    del model
    torch.cuda.empty_cache()

    model = create_item_recommender(
        "WRMF", f"num_factors=40 num_iter=2 regularization=100 "
        f"device={dev.type}")
    model.mesh = rig
    model.feedback = wrmf_train
    with recorded_events((model, "_optimize", "side")) as ev, \
            counted_path({}):
        t1 = time.perf_counter()
        model.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t1
    del model._optimize
    sides = [s.elapsed_time(e) for s, e in ev["side"]]
    H = model.params["item_factors"]
    U = model.params["user_factors"].shape[0]
    many = model._optimize(H, model._user_hist, U)
    one = torch.zeros_like(many)
    HH = als.gram(H)
    for rows, hist, lens, chunk in model._user_hist:
        one[rows] = als.wrmf_optimize(
            H, torch.cat(hist), torch.cat(lens), model.alpha,
            model.regularization, chunk=chunk, HH=HH)[:rows.shape[0]]
    log(f"mesh WRMF Netflix-shaped on the rig: train {train_s:.2f} s for 2 "
        f"alternations; user side {', '.join(f'{t:.1f}' for t in sides[0::2])}"
        f" ms, item side {', '.join(f'{t:.1f}' for t in sides[1::2])} ms")
    plain_check((many - one).abs().max().item(),
                f"mesh WRMF user side ({U} rows) on the rig vs one device's "
                f"solves", WRMF_MESH_TOL)
    users = np.arange(1024, dtype=np.int32)
    with recorded_topk() as calls, counted_path({"catalog_topk": 1}):
        ids, scores = recommend_batch(model, users, 10, training=wrmf_train)
    ref = topk_reference(*calls[0][0], k=11)
    err, bad = topk_agreement(ids, scores, ref[0].cpu().numpy(),
                              ref[1].cpu().numpy())
    log(f"mesh WRMF serving: top-10 of {users.size} users through kernel 6 "
        f"(1 launch): max_abs_err {err:.3e} (tol {KERNEL_TOL}), ids "
        f"differing outside near-ties {bad}")
    check(err, "mesh WRMF serving")
    if bad:
        raise AssertionError(f"mesh WRMF serving: {bad} ids differ")
    sample = np.sort(np.random.default_rng(9).choice(
        wrmf_test.all_users, EVAL_USERS, replace=False))
    lines = {}
    for label, mesh in (("rig", rig), ("one device", None)):
        model.mesh = mesh
        t1 = time.perf_counter()
        lines[label] = evaluate_items(model, wrmf_test, wrmf_train,
                                      test_users=sample)
        lines[label + " s"] = time.perf_counter() - t1
    log(f"mesh WRMF data-parallel ranking eval of {EVAL_USERS} users on the "
        f"rig: {lines['rig']} ({lines['rig s']:.2f} s); one device: "
        f"{lines['one device']} ({lines['one device s']:.2f} s)")
    if str(lines["rig"]) != str(lines["one device"]):
        raise AssertionError("the data-parallel eval's line differs from one "
                             "device's")
    del model, many, one
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    log(f"phase 25 (b) (the plain mesh routes, Netflix shape): "
        f"{seconds:.1f} s")
    return seconds


def phase_plain_mesh_big_catalog(dev, train, test, bpr_minibatch):
    """(c) On the big catalog (positive-only pairs): one sharded minibatch
    BPR epoch on the rig (``ops/bpr.py bpr_epoch_sharded``, k=40, from
    seeded tables; the 4-device model route there is sharded-tiled):
    first ``BPR_WINDOW`` sharded steps on the card against the same steps
    on the CPU from the same per-device triples (1e-5), then the epoch's
    ms beside one device's minibatch epoch and the AUC of AUC_USERS
    seeded users. Returns the seconds."""
    from mymedialite_tpu_torch.eval.ranking import evaluate_items
    from mymedialite_tpu_torch.models.registry import create_item_recommender
    from mymedialite_tpu_torch.ops import bpr
    from mymedialite_tpu_torch.parallel.mesh import make_mesh
    t0 = time.perf_counter()
    rig = rig_mesh()
    D = rig.size
    t1 = time.perf_counter()
    data, meta = bpr.make_sampler_data_sharded(train, D)
    samplers = bpr.device_samplers(rig, data, meta)
    prep_s = time.perf_counter() - t1
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    f = 40
    params = dict(
        user_factors=0.1 * torch.randn((meta["u_loc"] * D, f), generator=gen,
                                       device=dev),
        item_factors=0.1 * torch.randn((meta["num_items"], f), generator=gen,
                                       device=dev),
        item_bias=torch.zeros(meta["num_items"], device=dev))
    hp = dict(learn_rate=0.05, reg_u=0.0025, reg_i=0.0025, reg_j=0.00025,
              bias_reg=0.0)
    batch, num_batches = bpr.sharded_epoch_batches(meta["num_events"], 8192,
                                                   D)

    def generators(seed):
        out = []
        for d, gdev in enumerate(rig.devices):
            out.append(torch.Generator(device=gdev))
            out[-1].manual_seed(seed + d)
        return out
    # the window: the card's sharded steps against the CPU's, same triples
    gens = generators(100)
    card = {k: v.clone() for k, v in params.items()}
    host = host_copy(card, torch.float32)
    cpu = make_mesh(devices=["cpu"] * D)
    W_card, W_host = rig.shard_rows(card["user_factors"]), cpu.shard_rows(
        host["user_factors"])
    reps = (rig.replicate(card["item_factors"]),
            rig.replicate(card["item_bias"]))
    host_reps = (cpu.replicate(host["item_factors"]),
                 cpu.replicate(host["item_bias"]))
    for _ in range(BPR_WINDOW):
        step = [bpr.sample_triples_sharded(gens[d], samplers[d], meta, batch,
                                           bpr.UNIFORM_USER)
                for d in range(D)]
        reps = bpr.bpr_step_sharded(rig, W_card, *reps, step, hp,
                                    update_j=True)
        host_reps = bpr.bpr_step_sharded(
            cpu, W_host, *host_reps, [tuple(x.cpu() for x in t)
                                      for t in step], hp, update_j=True)
    card = dict(user_factors=rig.gather_rows(W_card),
                item_factors=reps[0][0], item_bias=reps[1][0])
    host = dict(user_factors=cpu.gather_rows(W_host),
                item_factors=host_reps[0][0], item_bias=host_reps[1][0])
    plain_check(table_gap(card, host),
                f"big-catalog sharded BPR: the first {BPR_WINDOW} steps of "
                f"{D} x {batch} triples on the rig vs the CPU's")
    del card, host, W_card, W_host, reps, host_reps
    torch.cuda.empty_cache()

    shards = rig.shard_rows(params["user_factors"])
    run = dict(params, user_factors=shards)
    with counted_path({}):
        _, epoch_ms = timed(lambda: bpr.bpr_epoch_sharded(
            rig, run, samplers, meta, generators(200), hp,
            batch_size=batch, num_batches=num_batches,
            regime=bpr.UNIFORM_USER, update_j=True))
    model = create_item_recommender("BPRMF",
                                    f"num_factors={f} device={dev.type}")
    model.feedback = train
    model.params = dict(
        user_factors=rig.gather_rows(shards)[:train.num_users],
        item_factors=params["item_factors"], item_bias=params["item_bias"])
    model.num_users_trained, model.num_items_trained = \
        train.num_users, train.num_items
    rng = np.random.default_rng(9)
    users = np.sort(rng.choice(test.all_users, AUC_USERS, replace=False))
    res = evaluate_items(model, test, train, test_users=users,
                         batch_size=128)
    log(f"big-catalog sharded minibatch BPR on the rig: sampler state "
        f"{prep_s:.2f} s; one epoch of {num_batches} steps of {D} x "
        f"{batch} triples: {epoch_ms:.1f} ms (one device's minibatch "
        f"epoch, phase 20: {bpr_minibatch['epoch_ms']:.1f} ms, AUC "
        f"{bpr_minibatch['auc']:.5f} after 3); AUC of {res['num_users']} "
        f"users after the one epoch from the seeded tables: "
        f"{res['AUC']:.5f}")
    if not (math.isfinite(res["AUC"]) and res["AUC"] > 0.5):
        raise AssertionError(f"big-catalog sharded BPR AUC {res['AUC']} "
                             "<= 0.5")
    del model, params, run, shards, samplers
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    log(f"phase 25 (c) (the plain mesh routes, big catalog): "
        f"{seconds:.1f} s")
    return seconds


KERNELS = {
    "sgd_epoch": ("mymedialite_tpu_torch/csrc/sgd_epoch.cu",
                  "mymedialite_tpu/ops/pallas_sgd.py:324"),
    "sgd_epoch_tiled": ("mymedialite_tpu_torch/csrc/sgd_epoch.cu",
                        "mymedialite_tpu/ops/pallas_sgd.py:745"),
    "bpr_epoch": ("mymedialite_tpu_torch/csrc/bpr_epoch.cu",
                  "mymedialite_tpu/ops/pallas_bpr.py:451"),
    "bpr_epoch_tiled": ("mymedialite_tpu_torch/csrc/bpr_epoch.cu",
                        "mymedialite_tpu/ops/pallas_bpr.py:979"),
    "svdpp_epoch": ("mymedialite_tpu_torch/csrc/svdpp_epoch.cu",
                    "mymedialite_tpu/ops/pallas_svdpp.py:308"),
    "catalog_topk": ("mymedialite_tpu_torch/csrc/catalog_topk.cu",
                     "mymedialite_tpu/ops/pallas_topk.py:55"),
    # replaces no TPU kernel: the JAX blocked epoch's .at[u].add, whose
    # scatter it stands beside on the plain routes
    "exact_add": ("mymedialite_tpu_torch/csrc/exact_add.cu",
                  "mymedialite_tpu/ops/sgd.py:364"),
}


# ---------------------------------------------------------------------------
# phase 26: the default mesh (parallel/mesh.py default_mesh)
# ---------------------------------------------------------------------------

# (b)'s catalog past the per-device resident bound: at k=40 on 4 devices,
# 196 item blocks, 49 a partition where 40 fit, streamed in slabs of 16
DEFAULT_BIG_ITEMS = 200_000
DEFAULT_EPOCHS = 2


@contextlib.contextmanager
def eval_parts():
    """The mesh sizes of the data-parallel rank steps of the ranking
    evals inside the block (``eval/ranking.py _ranks_on_mesh``)."""
    from mymedialite_tpu_torch.eval import ranking
    real = ranking._ranks_on_mesh
    sizes = []

    def counted(mesh, *a):
        sizes.append(mesh.size)
        return real(mesh, *a)
    ranking._ranks_on_mesh = counted
    try:
        yield sizes
    finally:
        ranking._ranks_on_mesh = real


def std_tables(model, kind: str) -> dict:
    """The standard tables a model predicts from: MF's W and H (trained
    rows), the BPR and WRMF params."""
    if kind == "mf":
        return {"W": model.W_ext[:model.num_users_trained], "H": model.H_ext}
    return dict(model.params)


def default_svdpp(dev, train, test, mesh):
    """SVDPlusPlus (k=20, learn rate 0.003, transductive) trained with
    ``mesh``; groups as phase 25 (b) sizes them: 4 make one device's
    automatic group."""
    from mymedialite_tpu_torch.models.registry import create_rating_predictor
    opts = f"num_factors=20 learn_rate=0.003 device={dev.type}"
    probe = create_rating_predictor("SVDPlusPlus", opts)
    probe.ratings = train
    group = max(probe._auto_group_users(train.num_users) // MESH_DEVICES, 1)
    model = create_rating_predictor(
        "SVDPlusPlus", f"{opts} num_iter={DEFAULT_EPOCHS} "
        f"group_users={group}")
    model.mesh = mesh
    model.additional_feedback = (test.users, test.items)
    model.ratings = train
    with counted_path({}):
        _, ms = timed(model.train)
    return model, ms


def default_wrmf(dev, feedback, mesh):
    from mymedialite_tpu_torch.models.registry import create_item_recommender
    model = create_item_recommender(
        "WRMF", f"num_factors=40 regularization=100 num_iter="
        f"{DEFAULT_EPOCHS} device={dev.type}")
    model.mesh = mesh
    model.feedback = feedback
    with counted_path({}):
        _, ms = timed(model.train)
    return model, ms


def kind_of(name: str) -> str:
    return "mf" if name == "BiasedMatrixFactorization" else "bpr"


def phase_default_one_card(dev, train, test):
    """(a) The resolver as it stands: with one card (or none) it returns
    None, and with the mesh left at its default BiasedMF, BPRMF,
    MultiCoreBPRMF and SVD++ take phases 3-11's routes (one epoch: one
    launch of their kernel), WRMF solves on one device and the ranking
    eval ranks on one device. With several cards it spans them all."""
    from mymedialite_tpu_torch.data.synthetic import posonly_from_ratings
    from mymedialite_tpu_torch.eval.ranking import evaluate_items
    from mymedialite_tpu_torch.models.registry import (
        create_item_recommender, create_rating_predictor,
    )
    from mymedialite_tpu_torch.parallel.mesh import (
        default_devices, default_mesh,
    )
    with default_devices(None):
        count = torch.cuda.device_count()
        mesh = default_mesh(dev)
        if count > 1:
            if mesh is None or mesh.size != count:
                raise AssertionError(f"{count} cards: the default is {mesh}")
            log(f"default mesh (a): {count} cards, the default spans them "
                f"all ({mesh}); the one-card routes are not checked here")
            return
        if mesh is not None:
            raise AssertionError(f"one card: the default is {mesh}, not None")
        opts = f"num_factors=40 num_iter=1 device={dev.type}"
        fb, test_items = posonly_from_ratings(train), \
            posonly_from_ratings(test)
        routes, models = [], {}
        for name, create, data, kernel, route in (
                ("BiasedMatrixFactorization", create_rating_predictor, train,
                 "sgd_epoch", "resident"),
                ("BPRMF", create_item_recommender, fb, "bpr_epoch",
                 "resident"),
                ("MultiCoreBPRMF", create_item_recommender, fb, "bpr_epoch",
                 "resident")):
            model = create(name, opts)
            setattr(model, "ratings" if kind_of(name) == "mf" else
                    "feedback", data)
            with counted_path({kernel: 1}):
                model.train()
            if model._route() != route or model._mesh is not None:
                raise AssertionError(f"{name} on one card took "
                                     f"{model._route()} on {model._mesh}")
            routes.append(f"{name} {route} ({kernel} once)")
            models[name] = model
        svdpp = create_rating_predictor("SVDPlusPlus", "num_factors=20 "
                                        f"num_iter=1 device={dev.type}")
        svdpp.ratings = train
        with counted_path({"svdpp_epoch": 1}):
            svdpp.train()
        if svdpp.route() != "kernel":
            raise AssertionError(f"SVDPlusPlus on one card: {svdpp.route()}")
        routes.append("SVDPlusPlus kernel (svdpp_epoch once)")
        wrmf = create_item_recommender("WRMF", f"num_factors=40 num_iter=1 "
                                       f"device={dev.type}")
        wrmf.feedback = fb
        with counted_path({}):
            wrmf.train()
        if wrmf._hist_mesh is not None:
            raise AssertionError(f"WRMF on one card: {wrmf._hist_mesh}")
        routes.append("WRMF one device")
        with eval_parts() as parts, counted_path({}):
            evaluate_items(models["BPRMF"], test_items, fb)
        if parts:
            raise AssertionError(f"one card: the eval split over {parts}")
        routes.append("BPRMF's ranking eval one device")
    log(f"default mesh (a), one card: the resolver gives None; "
        f"{'; '.join(routes)}")


def default_vs_explicit(dev, name, data, route, resolved, explicit, what):
    """One model of ``name`` trained on the default (resolved to
    ``resolved``) and one on the ``explicit`` mesh of the same devices,
    ``DEFAULT_EPOCHS`` epochs each through ``mesh_model``: the same plan
    chunk for chunk, the same launches (one a non-empty cell an epoch),
    the tables equal bit for bit (the kernels sum each row in a fixed
    order, so one schedule gives one set of tables); the default model's
    kernel then held to its plain version across its cells. Returns (its
    error, the default model)."""
    from mymedialite_tpu_torch.parallel.mesh import DEFAULT_MESH
    kind = kind_of(name)
    label = f"default {name} {what}"
    runs = []
    for mesh in (DEFAULT_MESH, explicit):
        model, epoch_ms, _ = mesh_model(
            dev, kind, data, iters=DEFAULT_EPOCHS, label=f"{label} ("
            f"{'default' if mesh is DEFAULT_MESH else 'explicit'} mesh)",
            route=route, name=name, mesh=mesh)
        runs.append((model, epoch_ms))
    (m_def, ms_def), (m_exp, ms_exp) = runs
    if m_def._mesh is not resolved:
        raise AssertionError(f"{label}: trained on {m_def._mesh}, not on "
                             f"the resolved {resolved}")
    p_def, p_exp = m_def._plan, m_exp._plan
    if not (np.array_equal(p_def.cell_counts, p_exp.cell_counts)
            and torch.equal(p_def.packed, p_exp.packed)):
        raise AssertionError(f"{label}: the plans differ")
    # the check reads the kernel-layout tables, which a read of the
    # standard ones folds back
    err = mesh_model_check(m_def, kind, label)
    mesh_layout_check(m_def, kind, label)
    gap = table_gap(std_tables(m_def, kind), std_tables(m_exp, kind))
    log(f"{label}: the default resolves to {resolved}; the plan equals the "
        f"explicit mesh's chunk for chunk ({cells_line(p_def)}); tables "
        f"against the explicit mesh's {gap:.3e} ("
        f"{'equal bit for bit' if gap == 0 else 'NOT EQUAL'}); "
        f"epoch {ms_def:.2f} ms default, {ms_exp:.2f} ms explicit ("
        f"{card_line() if dev.type == 'cuda' else dev})")
    if gap != 0:
        raise AssertionError(f"{label}: default vs explicit {gap}, not "
                             "equal bit for bit")
    del m_exp
    return err, m_def


def phase_default_rig(dev, train, test):
    """(b) The default pointed at the one-card rig (``default_devices``,
    ``MESH_DEVICES`` entries), at phase 3's shape: BiasedMF, BPRMF and
    MultiCoreBPRMF on "sharded" (kernels 1 and 3 once per non-empty cell),
    BiasedMF and BPRMF on "sharded-tiled" at a catalog of
    ``DEFAULT_BIG_ITEMS`` (kernels 2 and 4), each against an explicit
    mesh of the same devices and its kernel against its plain version;
    SVDPlusPlus on its sharded grouped epoch and WRMF on its sharded
    solves against the explicit mesh's; the ranking eval of the default
    BPRMF split over the rig, its line equal to the explicit mesh's and
    to one device's. Returns the largest error of each kernel."""
    from mymedialite_tpu_torch.data.synthetic import (
        posonly_from_ratings, synthetic_ratings,
    )
    from mymedialite_tpu_torch.eval.ranking import evaluate_items
    from mymedialite_tpu_torch.parallel.mesh import (
        DEFAULT_MESH, default_devices, default_mesh, make_mesh,
    )
    rig = rig_mesh()
    worst = {}
    fb, test_items = posonly_from_ratings(train), posonly_from_ratings(test)
    big = synthetic_ratings(**dict(MESH_CHECK_SHAPE,
                                   num_items=DEFAULT_BIG_ITEMS))
    big_fb = posonly_from_ratings(big)
    with default_devices(rig.devices):
        resolved = default_mesh(dev)
        if resolved is None or resolved.devices != rig.devices or \
                default_mesh(dev) is not resolved:
            raise AssertionError(f"the default on the rig: {resolved}")
        explicit = make_mesh(devices=rig.devices)
        bpr_model = None
        for name, data, route, what, kernel in (
                ("BiasedMatrixFactorization", train, "sharded",
                 "phase 3's shape", "sgd_epoch"),
                ("BPRMF", fb, "sharded", "phase 3's shape", "bpr_epoch"),
                ("MultiCoreBPRMF", fb, "sharded", "phase 3's shape",
                 "bpr_epoch"),
                ("BiasedMatrixFactorization", big, "sharded-tiled",
                 f"{DEFAULT_BIG_ITEMS:,} items", "sgd_epoch_tiled"),
                ("BPRMF", big_fb, "sharded-tiled",
                 f"{DEFAULT_BIG_ITEMS:,} items", "bpr_epoch_tiled")):
            err, model = default_vs_explicit(dev, name, data, route,
                                             resolved, explicit, what)
            worst[kernel] = max(worst.get(kernel, 0.0), err)
            if name == "BPRMF" and route == "sharded":
                bpr_model = model
            del model
            torch.cuda.empty_cache()

        svd, wrmf = [], []
        for mesh in (DEFAULT_MESH, explicit):
            svd.append(default_svdpp(dev, train, test, mesh))
            wrmf.append(default_wrmf(dev, fb, mesh))
        (s_def, s_ms), (s_exp, _) = svd
        if s_def.route() != "sharded" or s_def._shards[0] is not resolved:
            raise AssertionError(f"default SVDPlusPlus: {s_def.route()}")
        gap = table_gap(s_def.params, s_exp.params)
        log(f"default SVDPlusPlus (sharded grouped epoch, "
            f"{s_def._groups.ngroups} groups of {s_def.group_users} on "
            f"{rig.size} devices, k=20): {s_ms:.1f} ms for "
            f"{DEFAULT_EPOCHS} epochs; tables against the explicit mesh's "
            f"{gap:.3e} ({'bit for bit' if gap == 0 else 'tol '}"
            f"{'' if gap == 0 else PLAIN_MESH_TOL})")
        plain_check(gap, "default SVDPlusPlus vs the explicit mesh")
        (w_def, w_ms), (w_exp, _) = wrmf
        if w_def._hist_mesh is not resolved:
            raise AssertionError(f"default WRMF: {w_def._hist_mesh}")
        gap = table_gap(w_def.params, w_exp.params)
        log(f"default WRMF (sharded solves on {rig.size} devices, k=40): "
            f"{w_ms:.1f} ms for {DEFAULT_EPOCHS} alternations; tables "
            f"against the explicit mesh's {gap:.3e} "
            f"({'bit for bit' if gap == 0 else f'tol {WRMF_MESH_TOL}'})")
        plain_check(gap, "default WRMF vs the explicit mesh", WRMF_MESH_TOL)
        del svd, wrmf, s_def, s_exp, w_def, w_exp

        lines = {}
        for label, mesh in (("default", DEFAULT_MESH),
                            ("explicit", explicit), ("one device", None)):
            bpr_model.mesh = mesh
            with eval_parts() as parts, counted_path({}):
                res, ms = timed(lambda: evaluate_items(bpr_model, test_items,
                                                       fb))
            if parts != ([] if mesh is None else [rig.size] * len(parts)) \
                    or (mesh is not None and not parts):
                raise AssertionError(f"the {label} eval split over {parts}")
            lines[label] = (res, ms)
        if len({str(res) for res, _ in lines.values()}) != 1:
            raise AssertionError(f"the eval lines differ: {lines}")
        res = lines["default"][0]
        log(f"default ranking eval of the default BPRMF, {res['num_users']} "
            f"users split over {rig.size} devices: {res}; equal bit for bit "
            f"to the explicit mesh's and to one device's ("
            + ", ".join(f"{k} {ms:.1f} ms" for k, (_, ms) in lines.items())
            + ")")
    return worst


def phase_default_mesh(dev):
    """Phase 26 at phase 3's shape: (a) the resolver on this machine, (b)
    pointed at the rig. Returns (the largest error of each of kernels
    1-4, the seconds)."""
    from mymedialite_tpu_torch.data.synthetic import (
        split_ratings, synthetic_ratings,
    )
    t0 = time.perf_counter()
    train, test = split_ratings(synthetic_ratings(**MESH_CHECK_SHAPE), 0.2,
                                seed=2)
    phase_default_one_card(dev, train, test)
    worst = phase_default_rig(dev, train, test)
    seconds = time.perf_counter() - t0
    log(f"phase 26 (the default mesh): {seconds:.1f} s")
    return worst, seconds


# ---------------------------------------------------------------------------
# phase 27: the quality driver (mymedialite_tpu_torch/quality.py)
# ---------------------------------------------------------------------------

# the kernel each kernel-route row of the driver launches, once an epoch
QUALITY_KERNELS = {
    "BiasedMatrixFactorization": ("resident", "sgd_epoch"),
    "MatrixFactorization": ("resident", "sgd_epoch"),
    "SVDPlusPlus": ("kernel", "svdpp_epoch"),
    "SigmoidSVDPlusPlus": ("kernel", "svdpp_epoch"),
    "SigmoidItemAsymmetricFactorModel": ("kernel", "svdpp_epoch"),
    "BPRMF": ("resident", "bpr_epoch"),
    "WeightedBPRMF": ("resident", "bpr_epoch"),
    "SoftMarginRankingMF": ("resident", "bpr_epoch"),
}
# rows that miss their floor at --small on the CPU as well (reported, not
# held): LeastSquareSLIM's AUC lies under Random's there (PERF.md)
QUALITY_REPORTED = {("item", "LeastSquareSLIM")}
# phase 27 runs the driver twice a seed: the runs must be equal
QUALITY_RUNS = 2


def quality_expected(configs) -> dict:
    """{(name, options): (route, {kernel: launches})} of the driver's rows
    at --small: the kernel rows launch their kernel once an epoch, the
    rest take a plain route and launch none."""
    out = {}
    for name, opts in configs:
        route, kernel = QUALITY_KERNELS.get(name, ("plain", None))
        epochs = int(re.search(r"num_iter=(\d+)", opts).group(1)) \
            if kernel else 0
        out[(name, opts)] = (route, {kernel: epochs} if kernel else {})
    return out


def phase_quality(dev, tmp):
    """Phase 27: the quality driver at --small, one seed, two runs of it
    (``--runs 2``), on the card, in this process, its JSON records written
    and read back. Every row finite, its route and launches as
    ``quality_expected`` says; each row's two runs equal in every metric
    (one seed, one model); each rating row's RMSE under GlobalAverage's
    (the time-aware rows under the timed data's global average), each
    item row's AUC over Random's (``QUALITY_REPORTED`` rows logged, not
    held). Returns the seconds."""
    from mymedialite_tpu_torch import quality

    configs = quality.RATING_CONFIGS + quality.TIME_AWARE_CONFIGS + \
        quality.ITEM_CONFIGS
    expected = quality_expected(configs)
    total = {}
    for config in configs:
        for k, n in expected[config][1].items():
            total[k] = total.get(k, 0) + QUALITY_RUNS * n
    path = os.path.join(tmp, "quality.jsonl")
    t0 = time.perf_counter()
    with counted_path(total):
        records = quality.main(["--small", "--device", str(dev), "--runs",
                                str(QUALITY_RUNS), "--json", path])
    seconds = time.perf_counter() - t0
    with open(path) as f:
        lines = [json.loads(ln) for ln in f]
    if lines != json.loads(json.dumps(records)) or \
            len(lines) != QUALITY_RUNS * len(configs):
        raise AssertionError("the driver's JSON records do not match its "
                             "rows")
    firsts = {(r["section"], r["name"], r["options"], r["seed"]): r
              for r in lines if r["run"] == 0}
    gap = max(abs(v - firsts[(r["section"], r["name"], r["options"],
                              r["seed"])]["metrics"][m])
              for r in lines for m, v in r["metrics"].items())
    if gap != 0:
        raise AssertionError(f"quality: two runs of one seed differ by {gap}")
    lines = [r for r in lines if r["run"] == 0]
    timed_ga = global_average_rmse(*quality.timed_data(0.05))
    floors = {"rating": next(r["metrics"]["RMSE"] for r in lines if
                             r["name"] == "GlobalAverage"),
              "time": timed_ga,
              "item": next(r["metrics"]["AUC"] for r in lines if
                           r["section"] == "item" and r["name"] == "Random")}
    reported = []
    for r in lines:
        what = f"quality {r['section']} {r['name']} ({r['options']})"
        if r["device"] != str(dev) or not all(
                math.isfinite(v) for v in r["metrics"].values()):
            raise AssertionError(f"{what}: not finite or not on the card")
        if (r["route"], r["kernels"]) != expected[(r["name"], r["options"])]:
            raise AssertionError(f"{what}: route {r['route']}, launches "
                                 f"{r['kernels']}; expected "
                                 f"{expected[(r['name'], r['options'])]}")
        if r["name"] in ("GlobalAverage", "Random"):
            continue
        metric = "AUC" if r["section"] == "item" else "RMSE"
        value, floor = r["metrics"][metric], floors[r["section"]]
        ok = value > floor if metric == "AUC" else value < floor
        if (r["section"], r["name"]) in QUALITY_REPORTED:
            reported.append(f"{r['name']} {metric} {value:.5f} (floor "
                            f"{floor:.5f}, {'met' if ok else 'missed'})")
        elif not ok:
            raise AssertionError(f"{what}: {metric} {value} against "
                                 f"{floor}")
    log(f"phase 27 (the quality driver, --small, one seed, "
        f"{QUALITY_RUNS} runs): {len(lines)} rows, each finite and on its "
        f"route, its runs equal (largest gap {gap}); kernel launches "
        f"{total}; "
        f"RMSE under GlobalAverage's {floors['rating']:.5f} (time-aware: "
        f"the timed data's global average {timed_ga:.5f}), AUC over "
        f"Random's {floors['item']:.5f}; reported, not held: "
        f"{'; '.join(reported)}; {seconds:.1f} s")
    return seconds


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} numpy "
        f"{np.__version__} python {sys.version.split()[0]}")

    from mymedialite_tpu_torch.data.synthetic import posonly_from_ratings
    from mymedialite_tpu_torch.ops._build import load_library
    lib = load_library()
    log(f"build: {lib.build_seconds:.1f} s -> {os.path.relpath(lib.path)}")
    for line in lib.compiler_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  {line.strip()}")
    from mymedialite_tpu_torch import native
    t0 = time.perf_counter()
    text_lib = native.get_text_lib()
    log(f"model text library (native/model_text.cpp): "
        f"{'built' if text_lib is not None else 'unavailable, the Python path'}"
        f" ({time.perf_counter() - t0:.1f} s)")

    # phases 1-25 with the default mesh pointed at this card alone, so
    # that on a host of several cards they mean what they mean on one
    # (their child processes see one card); phase 26 looks at the
    # default itself
    from mymedialite_tpu_torch.parallel.mesh import default_devices
    with default_devices([f"cuda:{torch.cuda.current_device()}"]):
        t_start = time.perf_counter()
        sgd_worst = phase_kernel_check(dev)
        bpr_worst = phase_bpr_kernel_check(dev)
        worst = {"sgd_epoch": sgd_worst["resident"],
                 "sgd_epoch_tiled": sgd_worst["tiled"],
                 "bpr_epoch": bpr_worst["resident"],
                 "bpr_epoch_tiled": bpr_worst["tiled"],
                 "catalog_topk": phase_topk_kernel_check(dev)}
        for name, err in phase_mesh_kernel_check(dev).items():
            worst[name] = max(worst[name], err)
        phase25_s = phase_plain_mesh_check(dev)
        default_worst, phase26_s = phase_default_mesh(dev)
        for name, err in default_worst.items():
            worst[name] = max(worst[name], err)
        log(f"kernel checks: {time.perf_counter() - t_start:.1f} s")
        runs = {}
        train, test = shaped_ratings("Netflix-shaped", num_users=480_000,
                                     num_items=17_770,
                                     num_ratings=20_000_000, seed=1)
        runs["sgd_epoch"] = phase_mf_path(dev, train, test, tiled=False)
        runs["bpr_epoch"], bpr_model, bpr_feedback = phase_bpr_path(
            dev, train, test, tiled=False)
        for name, err in phase_mesh_netflix(
                dev, train, test, runs["sgd_epoch"], runs["bpr_epoch"],
                bpr_feedback).items():
            worst[name] = max(worst[name], err)
        torch.cuda.empty_cache()
        runs["catalog_topk"] = phase_serving(dev, bpr_model, bpr_feedback,
                                             "Netflix-shaped")
        worst["svdpp_epoch"] = phase_svdpp_kernel_check(dev)
        runs["svdpp_epoch"], svdpp_model = phase_svdpp_path(dev, train, test)
        torch.cuda.empty_cache()
        blocked = phase_mf_blocked(
            dev, train, test, "Netflix-shaped, frequency regularization",
            "frequency_regularization=true", repeat=True)
        repeat_s = blocked["repeat_s"]
        runs["exact_add"] = phase_exact_add_check(dev, blocked)
        del blocked
        torch.cuda.empty_cache()
        log(f"resident paths: {time.perf_counter() - t_start:.1f} s")
        model, feedback, test_items = phase_wrmf_path(dev, train, test)
        wrmf_serving = phase_serving(dev, model, feedback,
                                     "WRMF Netflix-shaped")
        worst["catalog_topk"] = max(worst["catalog_topk"],
                                    wrmf_serving["max_abs_err"])
        # kernel 6 on the Netflix main path: the BPRMF pass and the WRMF pass
        bpr_serving = runs["catalog_topk"]
        runs["catalog_topk"] = dict(
            {key: bpr_serving[key] + wrmf_serving[key] for key in
             ("launches", "ms", "plain_ms", "bound_ms", "library_ms")},
            max_abs_err=max(bpr_serving["max_abs_err"],
                            wrmf_serving["max_abs_err"]),
            bound_by=bpr_serving["bound_by"])
        torch.cuda.empty_cache()
        phase25_s += phase_plain_mesh_netflix(dev, train, test, svdpp_model,
                                              feedback, test_items)
        phase_knn_path(dev, feedback, test_items)
        phase_rating_knn_path(dev, train, test)
        torch.cuda.empty_cache()
        log(f"WRMF and KNN paths: {time.perf_counter() - t_start:.1f} s")
        with tempfile.TemporaryDirectory() as tmp:
            phase_incremental(dev, train, test,
                              (bpr_model, bpr_feedback, test_items),
                              (model, feedback, test_items), svdpp_model, tmp)
            del model, svdpp_model
            torch.cuda.empty_cache()
            phase23_s = phase_last_models(dev, train, test, runs["sgd_epoch"],
                                          (bpr_model, bpr_feedback), feedback,
                                          test_items, tmp)
        del feedback, test_items, bpr_model, bpr_feedback
        del train, test
        torch.cuda.empty_cache()
        # the published ml-25m catalog (GroupLens' README): 162,541 users,
        # 62,423 movies, 25,000,095 ratings
        train, test = shaped_ratings("MovieLens-25M-shaped",
                                     num_users=162_541, num_items=62_423,
                                     num_ratings=25_000_095, seed=25)
        runs["sgd_epoch_tiled"] = phase_mf_path(dev, train, test, tiled=True)
        runs["bpr_epoch_tiled"], model, feedback = phase_bpr_path(
            dev, train, test, tiled=True)
        ml25m = phase_serving(dev, model, feedback, "MovieLens-25M-shaped")
        worst["catalog_topk"] = max(worst["catalog_topk"],
                                    ml25m["max_abs_err"])
        del model, feedback
        torch.cuda.empty_cache()
        log(f"tiled paths: {time.perf_counter() - t_start:.1f} s")
        phase_svdpp_grouped(dev, train, test)
        del train, test
        torch.cuda.empty_cache()
        # a retail-sized catalog past the tiled schedule's 128 slabs at k=40:
        # 2,149 item blocks in 135 slabs
        train, test = shaped_ratings("big-catalog", num_users=500_000,
                                     num_items=2_200_000,
                                     num_ratings=10_000_000, seed=7)
        mf_blocked = phase_mf_blocked(dev, train, test, "big-catalog")
        bpr_minibatch = phase_bpr_minibatch(dev, train, test, "big-catalog")
        torch.cuda.empty_cache()
        for name, err in phase_mesh_big_catalog(dev, train, test, mf_blocked,
                                                bpr_minibatch).items():
            worst[name] = max(worst[name], err)
        phase25_s += phase_plain_mesh_big_catalog(
            dev, posonly_from_ratings(train), posonly_from_ratings(test),
            bpr_minibatch)
        del train, test
        torch.cuda.empty_cache()
        log(f"XLA-route paths: {time.perf_counter() - t_start:.1f} s")
        with tempfile.TemporaryDirectory() as tmp:
            files = phase_cli(dev, tmp)
            item_files = phase_item_cli(dev, tmp)
            phase_ranking_cli(dev, tmp, files)
            phase_knn_cli(dev, tmp, files, item_files)
            phase_cv_cli(dev, tmp, files, item_files)
            phase23_s += phase_last_clis(dev, tmp, files, item_files)
            phase27_s = phase_quality(dev, tmp)
        log(f"phase 23 (the last eight names): {phase23_s:.1f} s")
        log(f"phase 25 (the plain mesh routes): {phase25_s:.1f} s")
        log(f"phase 26 (the default mesh): {phase26_s:.1f} s")
        counting_s = runs["bpr_epoch"]["csr"][0] + \
            runs["bpr_epoch_tiled"]["csr"][0]
        lexsort_s = runs["bpr_epoch"]["csr"][1] + \
            runs["bpr_epoch_tiled"]["csr"][1]
        saved = lexsort_s - counting_s
        cost = phase27_s + repeat_s
        log(f"the ranking evals' CSR builds (phases 8 and 14): counting sort "
            f"{counting_s:.2f} s, lexsort {lexsort_s:.2f} s, saved "
            f"{saved:.2f} s; phase 27 {phase27_s:.2f} s + the repeated "
            f"blocked training {repeat_s:.2f} s = {cost:.2f} s, "
            f"{'within' if cost <= saved else 'PAST'} the saving")
        log(f"all phases: {time.perf_counter() - t_start:.1f} s after the "
            "build")

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = runs[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=r["launches"],
            max_abs_err=max(worst.get(name, 0.0), r["max_abs_err"]),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"],
            # a sequential epoch of dependent minibatch steps is no single
            # PyTorch call; the top-k's is torch.matmul + torch.topk;
            # exact_add's index_add_ (the same sums in another order)
            library_ms=r.get("library_ms")))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--counted-cli"]:
        sys.exit(counted_clis_child(*sys.argv[2:]))
    sys.exit(main())
