"""Fused catalog scoring + top-k: the CUDA kernel's wrapper and its plain
PyTorch version.

``catalog_topk`` replaces ``mymedialite_tpu/ops/pallas_topk.py:108
catalog_topk`` (kernel body ``_topk_kernel`` :55), with its semantics:
the k best items of each row of ``user_rows @ item_table.T`` under the
order (value descending, id ascending), which is ``lax.top_k``'s; items
whose byte in ``mask8`` is 0 score ``NEG_INF``; ``k > MAX_K`` raises;
when ``k`` exceeds the catalog the trailing slots hold id 0 and
``NEG_INF``. On CUDA tensors it launches ``csrc/catalog_topk.cu`` (one
launch per call) or raises; on CPU tensors it runs ``topk_reference``,
a matmul and a stable descending sort (``torch.topk`` leaves the order
of ties open). It counts its own launches.
"""

from __future__ import annotations

import torch

NEG_INF = -3.0e38
# past 64 the JAX package sends top-k to XLA (pallas_topk.MAX_PALLAS_K);
# the kernel keeps two list entries per lane
MAX_K = 64
# the kernel stages a [128, f] item tile in shared memory
MAX_F = 384
_MASK_DTYPES = (torch.int8, torch.bool)


def _pad(ids, vals, k: int):
    """Pad [B, k_run] results to k columns with id 0 and NEG_INF."""
    short = k - ids.shape[1]
    if short <= 0:
        return ids, vals
    B = ids.shape[0]
    return (torch.cat([ids, ids.new_zeros((B, short))], 1),
            torch.cat([vals, vals.new_full((B, short), NEG_INF)], 1))


def topk_reference(user_rows, item_table, mask8=None, *, k: int):
    """Plain version: the [B, N] scores, the mask, and a stable
    descending sort cut to min(k, N) columns, then padded to k.
    Returns (ids [B, k] int32, vals [B, k] float32)."""
    scores = user_rows @ item_table.T
    if mask8 is not None:
        scores = scores.masked_fill(mask8 == 0, NEG_INF)
    k_run = min(k, item_table.shape[0])
    vals, ids = torch.sort(scores, dim=1, descending=True, stable=True)
    return _pad(ids[:, :k_run].to(torch.int32).contiguous(),
                vals[:, :k_run].contiguous(), k)


def _check(user_rows, item_table, mask8, k: int):
    dev = user_rows.device
    named = [("user_rows", user_rows), ("item_table", item_table)]
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"catalog_topk: {name} is on {t.device}, "
                             f"user_rows on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"catalog_topk: {name} must be float32, got "
                            f"{t.dtype}")
        if t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"catalog_topk: {name} must be 2-D and "
                             "contiguous")
    if user_rows.shape[1] != item_table.shape[1]:
        raise ValueError("catalog_topk: user_rows and item_table must have "
                         "equal widths")
    if user_rows.shape[0] == 0 or item_table.shape[0] == 0:
        raise ValueError("catalog_topk: no users or an empty catalog")
    if mask8 is not None:
        if mask8.device != dev:
            raise ValueError(f"catalog_topk: mask8 is on {mask8.device}, "
                             f"user_rows on {dev}")
        if mask8.dtype not in _MASK_DTYPES:
            raise TypeError(f"catalog_topk: mask8 must be int8 or bool, got "
                            f"{mask8.dtype}")
        if tuple(mask8.shape) != (user_rows.shape[0], item_table.shape[0]) \
                or not mask8.is_contiguous():
            raise ValueError("catalog_topk: mask8 must be a contiguous "
                             "[B, N] tensor")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"catalog_topk: k={k} is outside 1..{MAX_K}; use "
                         "the scorer and a sort past it")


def _launch(user_rows, item_table, mask8, k_run: int):
    """Launch mml_catalog_topk on user_rows' stream; returns (ids, vals)
    [B, k_run]."""
    if user_rows.device.type != "cuda":
        raise ValueError(f"catalog_topk: no kernel for device "
                         f"{user_rows.device}")
    B, f = user_rows.shape
    if f > MAX_F:
        raise ValueError(f"catalog_topk: kernel takes f <= {MAX_F}, got {f}")
    from mymedialite_tpu_torch.ops._build import load_library
    fn = load_library().lib.mml_catalog_topk
    ids = torch.empty((B, k_run), dtype=torch.int32, device=user_rows.device)
    vals = torch.empty((B, k_run), dtype=torch.float32,
                       device=user_rows.device)
    stream = torch.cuda.current_stream(user_rows.device).cuda_stream
    err = fn(user_rows.data_ptr(), item_table.data_ptr(),
             mask8.data_ptr() if mask8 is not None else None,
             ids.data_ptr(), vals.data_ptr(), B, item_table.shape[0], f,
             k_run, stream)
    if err != 0:
        raise RuntimeError(f"catalog_topk: kernel launch failed, CUDA error "
                           f"{err}")
    return ids, vals


def catalog_topk(user_rows, item_table, mask8=None, *, k: int):
    """Top-k of ``user_rows`` [B, f] against ``item_table`` [N, f]
    (float32; fused factor and bias columns work unchanged), ``mask8``
    [B, N] int8 or bool (nonzero = candidate) or None. Returns (ids
    [B, k] int32, vals [B, k] float32)."""
    _check(user_rows, item_table, mask8, k)
    if user_rows.device.type == "cpu":
        return topk_reference(user_rows, item_table, mask8, k=k)
    ids, vals = _launch(user_rows, item_table, mask8,
                        min(k, item_table.shape[0]))
    catalog_topk.launches += 1
    return _pad(ids, vals, k)


catalog_topk.launches = 0
