"""Correlation / similarity of the port, as products on the device.

Counterpart of ``mymedialite_tpu/ops/correlation.py`` (reference
``Correlation/Overlap.cs:26-80``,
``BinaryDataSymmetricCorrelationMatrix.cs:25-100``, ``BinaryCosine.cs:35``,
``Jaccard.cs:30``, ``ConditionalProbability.cs:35``,
``BidirectionalConditionalProbability.cs:59``, ``Cooccurrence.cs:34``,
``Pearson.cs:58``, ``RatingCosine.cs:34``), with the same expressions,
zero-guards and diagonal. Results are tensors on ``device``.

Two paths, as in the JAX package:

* the small-N path (``binary_correlation`` / ``rating_correlation``)
  materializes the full [N, N] correlation, used up to ``DENSE_NMAX``
  entities;
* the scale path (``binary_correlation_topk`` /
  ``rating_correlation_topk``) never materializes [N, N]: the incidence
  lives on the device as one int8 [N, m] table, the overlaps come tile
  by tile ([R, C] per step) from ``torch._int_mm`` (int8 x int8 -> int32,
  exact), and each row keeps a running top-k merged with every tile in
  the reference order, correlation descending, then id ascending
  (``Correlation/Extensions.GetNearestNeighbors``). The order is exact
  whatever ``torch.topk`` does with ties: a score and its column id are
  packed into one int64 key (an order-preserving integer image of the
  float32 value above, the complement of the id below), so no two keys
  are equal and the largest k keys are the reference's k. Rating
  correlations ride the same int8 products on the rating scale's
  (equally spaced) levels: Pearson is affine-invariant and RatingCosine
  scale-invariant, so the level statistics give the exact correlation
  with exact int32 sums (levels <= 127, ``_quantize_levels``), which
  are mapped to the correlation in float64 and rounded once to float32
  (the JAX package maps them in float32, whose rounding can part two
  values that are equal in exact arithmetic by an ulp).

The tile sizes are the port's own (``_tiles``); the result does not
depend on them. Float products (the weighted measures, the dense
path) run without TF32 (``device.exact_float32``); the float Pearson
fallback of the streaming path sums in float64.
"""

from __future__ import annotations

import numpy as np
import torch

from mymedialite_tpu_torch.device import exact_float32, resolve_device

# above this many entities, KNN models switch to the streaming top-k path
DENSE_NMAX = 16_384

# elements of one [R, C] score tile (int64 keys: 512 MB)
TILE_ELEMS = 1 << 26
# bytes of the float copies of a row block and a column block that the
# weighted and float products convert per tile
FLOAT_TILE_BYTES = 1 << 32
_ROWS = 4096


def incidence_dense(data, num_rows: int, num_cols: int,
                    values: np.ndarray = None) -> np.ndarray:
    """Dense [num_rows, num_cols] float32 matrix from COO interaction data
    (binary by default, or carrying rating values; numpy)."""
    M = np.zeros((num_rows, num_cols), dtype=np.float32)
    if values is None:
        M[data.users, data.items] = 1.0
    else:
        M[data.users, data.items] = values
    return M


def _alpha_pair(alpha):
    """alpha and 1 - alpha as the JAX package forms them, in float32."""
    a = np.float32(alpha)
    return float(a), float(np.float32(1.0) - a)


def _map_overlap_values(overlap, cx, cy, alpha, kind: str):
    """Overlap counts -> correlation values (no diagonal handling);
    cx/cy already broadcast-shaped."""
    if kind == "cosine":
        denom = torch.sqrt(cx * cy)
        corr = torch.where(denom > 0, overlap / denom.clamp(min=1e-12), 0.0)
    elif kind == "jaccard":
        denom = cx + cy - overlap
        corr = torch.where(overlap != 0, overlap / denom.clamp(min=1e-12),
                           0.0)
    elif kind == "conditional_probability":
        corr = torch.where(cx != 0, overlap / cx.clamp(min=1e-12), 0.0)
    elif kind == "bidirectional_conditional_probability":
        a, one_minus_a = _alpha_pair(alpha)
        ok = (cx != 0) & (cy != 0)
        x_given_y = overlap / cx.clamp(min=1e-12)
        y_given_x = overlap / cy.clamp(min=1e-12)
        corr = torch.where(
            ok, x_given_y ** a * y_given_x ** one_minus_a, 0.0)
    elif kind == "cooccurrence":
        corr = overlap
    else:
        raise ValueError(f"unknown binary correlation {kind!r}")
    return corr


def _with_unit_diagonal(corr):
    # the reference sets the diagonal to 1 before mapping
    # (BinaryDataSymmetricCorrelationMatrix.cs:48-50)
    corr.fill_diagonal_(1.0)
    return corr


def _map_pearson(nn, Sxy, Sx, Sy, Sxx, Syy, shrinkage, centered: bool):
    """Pearson (Pearson.cs:224-242) or RatingCosine from the co-rated
    sums, with shrinkage (n-1)/(n-1+shrink) and 0 below 2 co-ratings."""
    if centered:
        num = nn * Sxy - Sx * Sy
        den = torch.sqrt(((nn * Sxx - Sx * Sx) * (nn * Syy - Sy * Sy))
                         .clamp(min=0.0))
    else:
        num = Sxy
        den = torch.sqrt((Sxx * Syy).clamp(min=0.0))
    corr = torch.where(den > 0, num / den.clamp(min=1e-12), 0.0)
    corr = corr * ((nn - 1.0) / (nn - 1.0 + float(np.float32(shrinkage))))
    return torch.where(nn < 2, 0.0, corr)


def _feature_weights(freq: np.ndarray) -> np.ndarray:
    """Inverse-log frequency weights (Overlap.ComputeWeighted,
    Overlap.cs:26-56), in float32 as the JAX package forms them."""
    return (1.0 / np.log2(3.0 + freq.astype(np.float32))).astype(np.float32)


def _dense_incidence(eids, fids, n, m, dev, values=None):
    """[n, m] float32 incidence on ``dev`` (ones, or the values; for
    duplicate pairs the last value, as numpy's assignment keeps it)."""
    A = torch.zeros((n, m), dtype=torch.float32, device=dev)
    e = torch.from_numpy(np.asarray(eids, np.int64)).to(dev)
    f = torch.from_numpy(np.asarray(fids, np.int64)).to(dev)
    if values is None:
        A[e, f] = 1.0
        return A
    sel = _last_occurrence(e * m + f)
    A[e[sel], f[sel]] = torch.from_numpy(
        np.asarray(values, np.float32)).to(dev)[sel]
    return A


def binary_correlation(data, num_entities: int, num_features: int,
                       kind: str = "cosine", alpha: float = 0.5,
                       weighted: bool = False, device="cuda"):
    """All-pairs correlation [N, N] (float32, on ``device``) between the
    entity rows of a binary matrix.

    data: InteractionData whose users are entities and items are features.
    weighted: inverse-log-frequency feature weights
          (reference Overlap.ComputeWeighted, Overlap.cs:26-56).
    """
    dev = resolve_device(device) if isinstance(device, str) else device
    A = _dense_incidence(data.users, data.items, num_entities,
                         num_features, dev)
    with exact_float32():
        if weighted:
            w_host = _feature_weights(A.sum(dim=0).cpu().numpy())
            w = torch.from_numpy(w_host).to(dev)
            Aw = A * w[None, :]
            overlap = Aw @ Aw.T
            counts = A @ w
        else:
            counts = A.sum(dim=1)
            overlap = A @ A.T
    return _with_unit_diagonal(_map_overlap_values(
        overlap, counts[:, None], counts[None, :], alpha, kind))


def rating_correlation(ratings, entity: str = "user", kind: str = "pearson",
                       shrinkage: float = 0.0, device="cuda"):
    """All-pairs Pearson/RatingCosine [N, N] over a RatingData
    (reference Pearson.ComputeCorrelations), as sufficient statistics:
    n = B B^T, Sxy = R R^T, Sx = R B^T, Sxx = (R*R) B^T."""
    dev = resolve_device(device) if isinstance(device, str) else device
    if entity == "user":
        R = _dense_incidence(ratings.users, ratings.items, ratings.num_users,
                             ratings.num_items, dev, ratings.values)
    else:
        R = _dense_incidence(ratings.items, ratings.users, ratings.num_items,
                             ratings.num_users, dev, ratings.values)
    B = (R != 0).to(torch.float32)
    with exact_float32():
        nn = B @ B.T
        Sxy = R @ R.T
        Sx = R @ B.T
        Sxx = (R * R) @ B.T
    corr = _map_pearson(nn, Sxy, Sx, Sx.T, Sxx, Sxx.T, shrinkage,
                        centered=(kind == "pearson"))
    return _with_unit_diagonal(corr)


# ---------------------------------------------------------------------------
# streaming top-k correlation — the scale path (never materializes [N, N])
# ---------------------------------------------------------------------------

def _last_occurrence(key):
    """Indices of the last occurrence of each distinct value of ``key``
    (a stable sort keeps equal keys in their original order)."""
    sk, order = torch.sort(key, stable=True)
    last = torch.ones_like(sk, dtype=torch.bool)
    last[:-1] = sk[1:] != sk[:-1]
    return order[last]


def _round_up(x: int, q: int) -> int:
    return -(-x // q) * q


def _tiles(n: int, m: int, float_bytes: int):
    """(R, C, n_pad): row and column tile sizes and the padded entity
    count (a multiple of R; R a multiple of 32, C of 8, as _int_mm
    needs). A float product converts a row block and a column block per
    tile to ``float_bytes`` per entry (0: the int8 products), so
    ``FLOAT_TILE_BYTES`` bounds (R + C) * m * float_bytes there."""
    rows = _ROWS
    if float_bytes:
        rows = min(rows, max(32, (FLOAT_TILE_BYTES // (2 * float_bytes
                                                       * max(m, 1)))
                             // 32 * 32))
    # equal row blocks, so that padding stays under 32 rows a block
    R = _round_up(-(-max(n, 1) // -(-max(n, 1) // rows)), 32)
    n_pad = _round_up(n, R)
    C = max(R, (TILE_ELEMS // R) // R * R)
    if float_bytes:
        C = min(C, max(R, (FLOAT_TILE_BYTES // (float_bytes * max(m, 1))
                           - R) // R * R))
    return R, min(C, n_pad), n_pad


def _order_keys(vals, col_ids):
    """int64 keys whose descending order is (value desc, id asc): an
    order-preserving int32 image of the float32 value (negative values
    have their magnitude bits flipped; -0.0 folds into 0.0) in the high
    half, 2^32 - 1 - id in the low half."""
    bits = (vals + 0.0).view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    return ordered * (1 << 32) + ((1 << 32) - 1 - col_ids.to(torch.int64))


def _decode_keys(keys):
    """(ids int32, values float32) of ``_order_keys``."""
    ordered = (keys >> 32).to(torch.int32)
    bits = torch.where(ordered < 0, ordered ^ 0x7FFFFFFF, ordered)
    ids = ((1 << 32) - 1 - (keys & 0xFFFFFFFF)).to(torch.int32)
    return ids, bits.view(torch.float32)


def _stream_topk(n: int, n_pad: int, R: int, C: int, k: int, tile, dev):
    """Run ``tile(r0, c0, c1) -> corr [R, c1 - c0]`` over every row block
    and column block, masking the padding columns and the diagonal, and
    keep each row's k largest (value, -id) keys. Returns (ids int32
    [n, k], values float32 [n, k]) in the reference order."""
    keys = []
    for r0 in range(0, n_pad, R):
        rid = torch.arange(r0, r0 + R, device=dev)[:, None]
        state = None
        for c0 in range(0, n_pad, C):
            c1 = min(c0 + C, n_pad)
            corr = tile(r0, c0, c1)
            cid = torch.arange(c0, c1, device=dev)[None, :]
            corr = corr.masked_fill((cid >= n) | (cid == rid), -np.inf)
            k_tile = _order_keys(corr, cid.expand_as(corr))
            if state is not None:
                k_tile = torch.cat([state, k_tile], dim=1)
            state = torch.topk(k_tile, min(k, k_tile.shape[1]), dim=1,
                               sorted=False).values
        keys.append(torch.sort(state, dim=1, descending=True).values)
    ids, vals = _decode_keys(torch.cat(keys)[:n])
    return ids, vals


def _empty_topk(n, dev):
    return (torch.zeros((n, 0), dtype=torch.int32, device=dev),
            torch.zeros((n, 0), dtype=torch.float32, device=dev))


def _int8_table(eids, fids, values, n_pad: int, m_pad: int, dev):
    """int8 [n_pad, m_pad] table on ``dev`` with table[e, f] = value."""
    A = torch.zeros((n_pad, m_pad), dtype=torch.int8, device=dev)
    A[eids, fids] = values
    return A


def _overlap_int8(X, Y):
    """X [R, m] @ Y [C, m]^T for int8 0/1 or level tables, exact in
    int32."""
    return torch._int_mm(X, Y.T)


def binary_correlation_topk(data, num_entities: int, num_features: int,
                            k: int, kind: str = "cosine", alpha: float = 0.5,
                            weighted: bool = False, device="cuda"):
    """Per-row top-k binary correlations without materializing [N, N].

    Returns (neighbor_ids [n, k_eff] int32, values [n, k_eff] float32),
    tensors on ``device``, in the reference neighbor order (correlation
    desc, id asc), as ``nearest_neighbors`` orders the dense matrix."""
    dev = resolve_device(device) if isinstance(device, str) else device
    n, m = num_entities, num_features
    k_eff = min(k, n - 1) if k >= 0 else n - 1
    if k_eff <= 0:
        return _empty_topk(n, dev)
    m_pad = _round_up(max(m, 1), 8)
    R, C, n_pad = _tiles(n, m_pad, 4 if weighted else 0)
    e = torch.from_numpy(np.asarray(data.users, np.int64)).to(dev)
    f = torch.from_numpy(np.asarray(data.items, np.int64)).to(dev)
    A = _int8_table(e, f, 1, n_pad, m_pad, dev)
    # counts from the distinct (entity, feature) pairs: a reduction of A
    # with an int dtype would first copy the whole table to that dtype
    pairs = torch.unique(e * m_pad + f)
    ue, uf = pairs // m_pad, pairs % m_pad
    if weighted:
        freq = torch.bincount(uf, minlength=m)[:m].cpu().numpy()
        w = torch.zeros(m_pad, dtype=torch.float32, device=dev)
        w[:m] = torch.from_numpy(_feature_weights(freq)).to(dev)
        # per-entity weight sums in float64 (the JAX package's bincount)
        cnt = torch.zeros(n_pad, dtype=torch.float64, device=dev).index_add_(
            0, ue, w.double()[uf]).float()
    else:
        cnt = torch.bincount(ue, minlength=n_pad).float()
    del pairs, ue, uf

    def tile(r0, c0, c1):
        if weighted:
            with exact_float32():
                ov = (A[r0:r0 + R].float() * w) @ (A[c0:c1].float() * w).T
        else:
            ov = _overlap_int8(A[r0:r0 + R], A[c0:c1]).float()
        return _map_overlap_values(ov, cnt[r0:r0 + R, None],
                                   cnt[None, c0:c1], alpha, kind)

    return _stream_topk(n, n_pad, R, C, k_eff, tile, dev)


def _quantize_levels(values: np.ndarray, centered: bool):
    """Encode ratings as small-int levels when the scale allows the exact
    int8 path: Pearson is affine-invariant (any equally spaced scale),
    RatingCosine scale-invariant (values must be integer multiples of the
    spacing). Returns int levels >= 1, or None to use float32."""
    uniq = np.unique(values)
    if uniq.size < 2:
        return np.ones_like(values, dtype=np.int8) if uniq.size else None
    s = float(np.min(np.diff(uniq)))
    if s <= 0:
        return None
    if centered:
        lev = np.round((values - uniq[0]) / s) + 1
        exact = np.allclose(uniq[0] + (lev - 1) * s, values, atol=1e-9)
    else:
        lev = np.round(values / s)
        exact = np.allclose(lev * s, values, atol=1e-9) and lev.min() >= 1
    if not exact or lev.max() > 127:
        return None
    return lev.astype(np.int8)


def _square_parts(L, rows: int):
    """L*L as int8 tables with their shifts: one while levels <= 11 (121
    fits int8), else l^2 = hi*128 + lo (l <= 127), formed ``rows`` rows
    at a time in int16."""
    if int(L.max()) <= 11:
        return [(L * L, 0)]
    hi, lo = torch.empty_like(L), torch.empty_like(L)
    for r0 in range(0, L.shape[0], rows):
        sq = L[r0:r0 + rows].to(torch.int16) ** 2
        hi[r0:r0 + rows] = (sq >> 7).to(torch.int8)
        lo[r0:r0 + rows] = (sq & 127).to(torch.int8)
    return [(hi, 7), (lo, 0)]


def rating_correlation_topk(ratings, k: int, entity: str = "user",
                            kind: str = "pearson", shrinkage: float = 0.0,
                            device="cuda"):
    """Per-row top-k Pearson/RatingCosine without materializing [N, N]
    (scale path of ``rating_correlation``); (ids, values) as
    ``binary_correlation_topk``."""
    dev = resolve_device(device) if isinstance(device, str) else device
    if entity == "user":
        eids, fids = ratings.users, ratings.items
        n, m = ratings.num_users, ratings.num_items
    else:
        eids, fids = ratings.items, ratings.users
        n, m = ratings.num_items, ratings.num_users
    k_eff = min(k, n - 1) if k >= 0 else n - 1
    if k_eff <= 0:
        return _empty_topk(n, dev)
    centered = kind == "pearson"
    e = torch.from_numpy(np.asarray(eids, np.int64)).to(dev)
    f = torch.from_numpy(np.asarray(fids, np.int64)).to(dev)
    # duplicate (entity, feature) pairs: keep the last occurrence, as
    # incidence_dense's numpy assignment does
    sel = _last_occurrence(e * m + f)
    values = np.asarray(ratings.values, dtype=np.float64)
    e, f = e[sel], f[sel]
    values = values[sel.cpu().numpy()]
    lev = _quantize_levels(values, centered)
    m_pad = _round_up(max(m, 1), 8)
    R, C, n_pad = _tiles(n, m_pad, 0 if lev is not None else 8)
    if lev is not None:
        L = _int8_table(e, f, torch.from_numpy(lev).to(dev), n_pad, m_pad,
                        dev)
        B = L.clamp(max=1)                      # levels are >= 1
        parts = _square_parts(L, R)

        def stats(r0, c0, c1):
            Lr, Br, Lc, Bc = L[r0:r0 + R], B[r0:r0 + R], L[c0:c1], B[c0:c1]
            nn = _overlap_int8(Br, Bc)
            Sxy = _overlap_int8(Lr, Lc)
            Sx = _overlap_int8(Lr, Bc)
            Sy = _overlap_int8(Br, Lc)
            Sxx = sum(_overlap_int8(P[r0:r0 + R], Bc) << s for P, s in parts)
            Syy = sum(_overlap_int8(Br, P[c0:c1]) << s for P, s in parts)
            # mapped in float64, where the int32 sums are exact: in
            # float32, n Sxx - Sx^2 cancels (n Sxx is about 1e11 for
            # popular pairs at 480k users) and the correlation moves by
            # more than 1e-6
            return tuple(x.double() for x in (nn, Sxy, Sx, Sy, Sxx, Syy))
    else:
        L = torch.zeros((n_pad, m_pad), dtype=torch.float32, device=dev)
        L[e, f] = torch.from_numpy(values.astype(np.float32)).to(dev)

        def stats(r0, c0, c1):
            # float64: the float32 sums cancel in n*Sxx - Sx^2 (the JAX
            # package's float path agrees with its own dense one to 1e-3)
            Lr, Lc = L[r0:r0 + R].double(), L[c0:c1].double()
            Br, Bc = (Lr != 0).double(), (Lc != 0).double()
            return (Br @ Bc.T, Lr @ Lc.T, Lr @ Bc.T, Br @ Lc.T,
                    (Lr * Lr) @ Bc.T, Br @ (Lc * Lc).T)

    def tile(r0, c0, c1):
        return _map_pearson(*stats(r0, c0, c1), shrinkage, centered).float()

    return _stream_topk(n, n_pad, R, C, k_eff, tile, dev)


def nearest_neighbors(corr, k: int):
    """Per-row top-k neighbor ids [N, min(k, N-1)] (int32, on corr's
    device) by descending correlation, self excluded, ties by ascending
    id (reference Correlation/Extensions.GetNearestNeighbors :153-175):
    a stable descending sort keeps equal values in id order."""
    n = corr.shape[0]
    k_eff = min(k, n - 1) if k >= 0 else n - 1
    if k_eff <= 0:
        return torch.zeros((n, 0), dtype=torch.int32, device=corr.device)
    c = corr.clone()
    c.fill_diagonal_(-np.inf)
    order = torch.sort(c, dim=1, descending=True, stable=True).indices
    return order[:, :k_eff].to(torch.int32)
