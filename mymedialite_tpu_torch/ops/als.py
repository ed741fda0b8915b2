"""Batched ALS normal-equation solves for WRMF, in PyTorch.

Counterpart of ``mymedialite_tpu/ops/als.py`` ``wrmf_optimize``
(reference ``WRMF.cs:79-156``): the Gram matrix HtH is one [f, I] x
[I, f] product; each row's system is assembled from its gathered,
masked padded history and all systems of a chunk are solved at once.

The per-row system (Hu/Koren/Volinsky implicit ALS, confidence
c = 1 + alpha on observed entries):

    W[u] = (HtH + alpha * H_S^T H_S + reg*I)^{-1} ((1+alpha) * sum_{i in S} H_i)

The systems are solved by ``torch.linalg.cholesky_ex`` and
``torch.cholesky_solve`` (cuSOLVER's batched factorization on the card);
a non-zero ``info`` (a system that is not positive definite) raises,
checked once per call. The products keep float32 without TF32
(``device.exact_float32``); a float64 ``H`` solves in float64. On an
H100 this route is about 3x faster than a plain-torch port of the JAX
package's unrolled Cholesky (``_batched_spd_solve``) on 480,000 systems
of 40 x 40; ``exp_torch_als_solves.py`` times the two.

``wrmf_solve_row`` solves one row, the online update's primitive.
``wrmf_optimize_sharded`` is the mesh form (JAX ``ops/als.py:107-128``,
the reference's Parallel.For over rows, WRMF.cs:87-91): the rows split
into one contiguous shard per mesh device, H replicated, each device
solving its rows; the rows' systems are independent, so the result is
one device's.
"""

from __future__ import annotations

import torch

from mymedialite_tpu_torch.device import exact_float32


def solve_cholesky(M, b):
    """M [C, f, f] SPD, b [C, f] -> (x [C, f], info [C] int32)."""
    L, info = torch.linalg.cholesky_ex(M)
    return torch.cholesky_solve(b[:, :, None], L)[:, :, 0], info


def gram(H):
    """HtH over all rows of the fixed side (reference WRMF.cs:94-108)."""
    with exact_float32():
        return H.T @ H


def row_systems(H, HH, hist, lens, alpha, reg):
    """The systems (M [C, f, f], b [C, f]) of the rows whose histories
    are ``hist`` [C, L] (pad entries masked by ``lens`` [C])."""
    L = hist.shape[1]
    f = H.shape[1]
    Hs = H[hist.clamp(0, H.shape[0] - 1)]                          # [C, L, f]
    mask = (torch.arange(L, device=hist.device)[None, :]
            < lens[:, None]).to(H.dtype)
    Hsm = Hs * mask[:, :, None]
    eye = torch.eye(f, dtype=H.dtype, device=H.device)
    with exact_float32():
        # alpha * H_S^T H_S (reference HC_minus_IH, WRMF.cs:115-125)
        M = HH[None] + alpha * torch.bmm(Hsm.transpose(1, 2), Hsm) \
            + reg * eye[None]
    b = (1.0 + alpha) * Hsm.sum(dim=1)                # reference HCp :127-133
    return M, b


def wrmf_optimize(H, hist, lens, alpha: float, reg: float, *, chunk: int,
                  HH=None):
    """Solve every row of W given the other side's factors H.

    H: [I, f] factors of the fixed side.
    hist: [U, L] int64 padded per-row histories (pad value arbitrary,
          masked by lens), on H's device.
    lens: [U] true history lengths.
    HH: the fixed side's Gram matrix, if the caller has it.
    Returns W [U, f]; rows are solved ``chunk`` at a time.
    """
    if HH is None:
        HH = gram(H)
    U = hist.shape[0]
    W = torch.empty((U, H.shape[1]), dtype=H.dtype, device=H.device)
    failed = torch.zeros((), dtype=torch.bool, device=H.device)
    for r0 in range(0, U, chunk):
        M, b = row_systems(H, HH, hist[r0:r0 + chunk], lens[r0:r0 + chunk],
                           alpha, reg)
        x, info = solve_cholesky(M, b)
        W[r0:r0 + chunk] = x
        failed |= (info != 0).any()
    if bool(failed):
        raise RuntimeError("wrmf_optimize: a row system is not positive "
                           "definite (cholesky_ex info != 0)")
    return W


def wrmf_solve_row(H, ids, alpha: float, reg: float, HH=None):
    """One row's closed-form solve against the fixed side's factors H,
    its history the ids ``ids`` (JAX ``wrmf_solve_row``; reference
    WRMF.RetrainUser / RetrainItem, WRMF.cs:158-172): the system of
    ``row_systems`` and the same ``cholesky_ex`` solve."""
    ids = torch.as_tensor(ids, dtype=torch.int64, device=H.device)
    n = ids.numel()
    hist = ids.reshape(1, n) if n else ids.new_zeros((1, 1))
    lens = torch.full((1,), n, dtype=torch.int64, device=H.device)
    return wrmf_optimize(H, hist, lens, alpha, reg, chunk=1, HH=HH)[0]


def wrmf_optimize_sharded(mesh, H, hist, lens, alpha: float, reg: float, *,
                          chunk: int, out_device=None):
    """``wrmf_optimize`` over the mesh: ``hist`` [U, L] and ``lens`` [U]
    (U a multiple of ``chunk`` x the global devices, as the JAX package
    pads them; or lists of this process's row shards) split into
    contiguous row shards, shard g solved on global device g against its
    replica of H and its own Gram matrix, ``chunk`` rows at a time, each
    process solving its own shards. Returns W [U, f], every process's
    shards gathered in row order on ``out_device`` (default H's)."""
    D = mesh.global_size
    if not isinstance(hist, (list, tuple)):
        if hist.shape[0] % (chunk * D):
            raise ValueError("rows must be a multiple of chunk x the mesh "
                             "devices (pad them as the JAX package does)")
        hist, lens = mesh.shard_rows(hist), mesh.shard_rows(lens)
    replicas = mesh.replicate(H)
    grams = {}
    parts = []
    for d, dev in enumerate(mesh.devices):
        Hd = replicas[d]
        if dev not in grams:
            grams[dev] = gram(Hd)
        parts.append(wrmf_optimize(Hd, hist[d].to(dev), lens[d].to(dev),
                                   alpha, reg, chunk=chunk, HH=grams[dev]))
    return mesh.gather_rows(parts, H.device if out_device is None
                            else out_device)
