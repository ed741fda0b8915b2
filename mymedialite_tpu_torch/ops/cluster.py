"""The thread-block cluster of epoch kernels 1-5 (``csrc/sgd_epoch.cu``,
``csrc/bpr_epoch.cu``, ``csrc/svdpp_epoch.cu``, through
``csrc/cluster_scatter.cuh``): how many CTAs run a chunk, the shared
memory each takes, and the launch's errors.

Each kernel launches one cluster of N CTAs an epoch (or a mesh cell).
CTA r runs phase 1 on the slots [r cs, (r + 1) cs), cs = ceil(C / N), of
every chunk or step. The values handed to the owner scatter (the entries
in runs of two or more, by compact index: table 0's at w0 float4s an
entry, then table 1's at w1) are striped over the CTAs' shared memory,
float4 o in CTA o // S, S = ceil(total / N); CTA r sums the runs whose
first value lies in [r S, (r + 1) S).
"""

from __future__ import annotations

# the dynamic shared memory a CTA of an epoch kernel takes: what a block
# can have on an H100 (227 KB), less 1 KB for its static shared memory
MAX_SHARED_BYTES = 227 * 1024
DYNAMIC_SHARED_BYTES = MAX_SHARED_BYTES - 1024
# what the launchers return where the card cannot place the cluster
CLUSTER_UNPLACED = -2
# the cluster a chunk spreads over, by kernel: N CTAs for chunks of at
# least C slots (each swept on the card, PERF.md section 6); N <= 8 is
# the portable size
CLUSTER_BY_CHUNK = {
    "sgd": ((256, 8), (0, 1)),      # kernels 1-2, csrc/sgd_epoch.cu
    "bpr": ((128, 8), (0, 1)),      # kernels 3-4, csrc/bpr_epoch.cu
    "svdpp": ((192, 8), (0, 1)),    # kernel 5, csrc/svdpp_epoch.cu
}


def cluster_size(chunk: int, kernel: str) -> int:
    """N, the CTAs of the thread-block cluster that runs each chunk of
    ``kernel`` (the kernels' only grid; CTA r takes slots [r cs, (r + 1)
    cs), cs = ceil(C / N)): the first entry of its ``CLUSTER_BY_CHUNK``
    table whose chunk bound ``chunk`` reaches."""
    return next(n for c, n in CLUSTER_BY_CHUNK[kernel] if chunk >= c)


def check_cluster_launch(what: str, err: int, cluster: int, smem: int):
    """Raise where an epoch kernel's launcher returned an error: the card
    cannot place the cluster of ``cluster`` CTAs of ``smem`` bytes of
    dynamic shared memory (a smaller cluster never runs in its place), or
    a CUDA error."""
    if err == CLUSTER_UNPLACED:
        raise RuntimeError(f"{what}: the card cannot place a cluster of "
                           f"{cluster} blocks of {smem} B of shared memory")
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch failed, CUDA error {err}")
