"""Fused catalog scoring + top-k: the CUDA kernel's wrapper and its plain
PyTorch version.

``catalog_topk`` replaces ``mymedialite_tpu/ops/pallas_topk.py:108
catalog_topk`` (kernel body ``_topk_kernel`` :55), with its semantics:
the k best items of each row of ``user_rows @ item_table.T`` under the
order (value descending, id ascending), which is ``lax.top_k``'s; items
whose byte in ``mask8`` is 0 score ``NEG_INF``; ``k > MAX_K`` raises;
when ``k`` exceeds the catalog the trailing slots hold id 0 and
``NEG_INF``. On CUDA tensors it launches ``csrc/catalog_topk.cu`` or
raises: a split kernel over (user tiles) x (catalog splits), each CTA
keeping the top-k of its split, then a merge kernel, both in one call
(counted once). On CPU tensors it runs ``topk_reference``, a matmul and
a stable descending sort (``torch.topk`` leaves the order of ties open).
It counts its own calls.
"""

from __future__ import annotations

import functools

import torch

NEG_INF = -3.0e38
# past 64 the JAX package sends top-k to XLA (pallas_topk.MAX_PALLAS_K);
# the kernel keeps two list entries per lane
MAX_K = 64
# the kernel stages a [32, f] user tile in shared memory
MAX_F = 384
_MASK_DTYPES = (torch.int8, torch.bool)
# the kernel's tiles (csrc/catalog_topk.cu): 32 users x 128 items per CTA
USERS_PER_CTA = 32
TILE_ITEMS = 128
# the kernel reads 16-byte rows: widths are padded to 4 columns
COLUMN_ALIGN = 4


def pad_columns(rows):
    """``rows`` [n, f] with zero columns appended up to a multiple of
    ``COLUMN_ALIGN`` (the same tensor when f is one already). Scores do
    not move: each zero column adds 0 * 0 to an FP32 sum."""
    short = -rows.shape[1] % COLUMN_ALIGN
    if short == 0:
        return rows
    return torch.nn.functional.pad(rows, (0, short)).contiguous()


def split_items(B: int, N: int, num_sms: int, ctas_per_sm: int) -> int:
    """Items per catalog split of a call on B users and N items: whole
    tiles, as many splits as one round of resident CTAs holds (a grid of
    ceil(B / 32) x splits CTAs, ``ctas_per_sm`` on each of ``num_sms``
    SMs), at least one, never more than the tiles. The call runs
    ceil(N / split_items) splits."""
    tiles = -(-N // TILE_ITEMS)
    user_tiles = -(-B // USERS_PER_CTA)
    splits = max(1, min(tiles, ctas_per_sm * num_sms // user_tiles))
    return -(-tiles // splits) * TILE_ITEMS


@functools.lru_cache(maxsize=None)
def _grid_room(device_index: int, f: int):
    """(SMs, split-kernel CTAs an SM holds at width f) of a card."""
    from mymedialite_tpu_torch.ops._build import load_library
    per_sm = load_library().lib.mml_catalog_topk_ctas_per_sm(f)
    if per_sm <= 0:
        raise RuntimeError(f"catalog_topk: the split kernel fits no SM at "
                           f"f={f} (CUDA error {-per_sm})")
    return (torch.cuda.get_device_properties(device_index)
            .multi_processor_count, per_sm)


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
    user_rows, item_table = pad_columns(user_rows), pad_columns(item_table)
    from mymedialite_tpu_torch.ops._build import load_library
    fn = load_library().lib.mml_catalog_topk
    dev = user_rows.device
    N = item_table.shape[0]
    per = split_items(B, N, *_grid_room(dev.index if dev.index is not None
                                        else torch.cuda.current_device(),
                                        user_rows.shape[1]))
    splits = -(-N // per)
    ids = torch.empty((B, k_run), dtype=torch.int32, device=dev)
    vals = torch.empty((B, k_run), dtype=torch.float32, device=dev)
    part = (torch.empty((B, splits, k_run), dtype=torch.int32, device=dev),
            torch.empty((B, splits, k_run), dtype=torch.float32, device=dev)) \
        if splits > 1 else (None, None)
    # the kernels launch on the current device: make it the rows'
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(user_rows.data_ptr(), item_table.data_ptr(),
                 mask8.data_ptr() if mask8 is not None else None,
                 *(t.data_ptr() if t is not None else None for t in part),
                 ids.data_ptr(), vals.data_ptr(), B, N, user_rows.shape[1],
                 k_run, per, stream)
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
