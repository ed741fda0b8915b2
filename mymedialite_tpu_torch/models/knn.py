"""k-nearest-neighbor recommenders of the port (rating + implicit,
collaborative + attribute-based).

Counterparts of ``mymedialite_tpu/models/knn.py`` (reference
``RatingPrediction/KNN.cs:47-175`` + ``UserKNN.cs:28``, ``ItemKNN.cs:28``,
``UserAttributeKNN.cs``, ``ItemAttributeKNN.cs``, and
``ItemRecommendation/KNN.cs:29-178`` + ``UserKNN.cs:30``, ``ItemKNN.cs:31``,
``UserAttributeKNN.cs:26``, ``ItemAttributeKNN.cs:26``). The correlations
come from ``ops/correlation.py`` and live on the model's ``device``
(default ``cuda``), where every score is computed.

Two storage modes, switched on the entity count as in the JAX package:

* dense (N <= ``ops.correlation.DENSE_NMAX``): the full [N, N]
  correlation; implicit scores are one product with the masked
  neighbour weights Wk;
* top-k (larger N): each row's k best neighbours and their correlations
  from the streaming kernels, [N, N] never built. Implicit scores gather
  the neighbours' incidence rows (user entity) or multiply by a sparse
  CSR Wk (item entity), so no fp32 dense [users, items] incidence
  exists either: the feedback lives on the device as int8. Rating KNN
  stores k_store = max(3k, 128) neighbours per row.

Rating prediction (reference ``RatingPrediction/UserKNN.Predict``
:58-93: baseline + sum w (r - b) / sum w over the first K positively
correlated co-raters) is batched on the device: the pairs are grouped by
the length of the co-rater list in power-of-two buckets, and each chunk
of pairs gathers its lists, looks the weights up, and sums. Where more
than K co-raters qualify, the JAX package takes an arbitrary K among
equal weights at the boundary (``np.argpartition``); the port takes the
smaller entity id there (ROADMAP §C, a deliberate deviation).

An online update (``add_ratings`` / ``add_feedback``) retrains the
whole model, as the JAX package does.
"""

from __future__ import annotations

import enum
import warnings

import numpy as np
import torch

from mymedialite_tpu_torch.device import exact_float32, resolve_device
from mymedialite_tpu_torch.io.model_io import ModelReader, ModelWriter
from mymedialite_tpu_torch.models.base import (
    IncrementalItemRecommender, IncrementalRatingPredictor,
    pairs_catalog_scorer,
)
from mymedialite_tpu_torch.models.baselines import UserItemBaseline
from mymedialite_tpu_torch.ops import correlation as corr_ops

INF_K = 2**32 - 1  # reference uint.MaxValue sentinel for K=inf
# unknown users and items score float.MinValue (reference KNN.Predict)
_UNKNOWN = -np.float32(3.4e38)
# elements of the [users, neighbours, items] gather of one user-KNN
# scoring step, and of the [pairs, list length] arrays of one rating
# prediction step
_GATHER_ELEMS = 1 << 26
_PAIR_ELEMS = 1 << 22


class BinaryCorrelationType(enum.Enum):
    COSINE = "Cosine"
    JACCARD = "Jaccard"
    CONDITIONAL_PROBABILITY = "ConditionalProbability"
    BIDIRECTIONAL_CONDITIONAL_PROBABILITY = "BidirectionalConditionalProbability"
    COOCCURRENCE = "Cooccurrence"


class RatingCorrelationType(enum.Enum):
    BINARY_COSINE = "BinaryCosine"
    JACCARD = "Jaccard"
    CONDITIONAL_PROBABILITY = "ConditionalProbability"
    BIDIRECTIONAL_CONDITIONAL_PROBABILITY = "BidirectionalConditionalProbability"
    COOCCURRENCE = "Cooccurrence"
    PEARSON = "Pearson"
    RATING_COSINE = "RatingCosine"


_BINARY_KIND = {
    "Cosine": "cosine",
    "BinaryCosine": "cosine",
    "Jaccard": "jaccard",
    "ConditionalProbability": "conditional_probability",
    "BidirectionalConditionalProbability":
        "bidirectional_conditional_probability",
    "Cooccurrence": "cooccurrence",
}


class _EntityView:
    """COO view with (users=entities, items=features) for correlation."""

    def __init__(self, users, items):
        self.users = users
        self.items = items


def _ids(a, dev):
    return torch.from_numpy(np.asarray(a, dtype=np.int64)).to(dev)


class _CorrelationStore:
    """Dense [N, N] or per-row top-k correlation storage shared by the
    KNN families (reference SymmetricCorrelationMatrix / the precomputed
    neighbour lists of ItemRecommendation/KNN.cs:104-108), on the
    device."""

    def _store_dense(self, corr):
        self.corr = corr
        self.nbr_ids = self.nbr_vals = None
        self._sorted_ids = self._sorted_vals = None
        self._scoring = None

    def _store_topk(self, ids, vals):
        self.corr = None
        self.nbr_ids, self.nbr_vals = ids, vals
        # id-sorted copies for O(log k) correlation lookups
        order = torch.sort(ids.to(torch.int64), dim=1).indices
        self._sorted_ids = ids.to(torch.int64).gather(1, order)
        self._sorted_vals = vals.gather(1, order)
        self._scoring = None

    @property
    def is_topk(self):
        return self.corr is None and self.nbr_ids is not None

    def _corr_rows(self) -> int:
        return (self.nbr_ids if self.is_topk else self.corr).shape[0]

    def _lookup_corr(self, rows, cols):
        """Correlations [P, L] of ``rows`` [P] with ``cols`` [P, L] (int64
        tensors; 0 where not stored)."""
        if not self.is_topk:
            n = self.corr.shape[1]
            w = self.corr[rows[:, None], cols.clamp(0, n - 1)]
            return torch.where(cols < n, w, 0.0)
        ids = self._sorted_ids[rows]
        vals = self._sorted_vals[rows]
        pos = torch.searchsorted(ids, cols.contiguous()).clamp(
            max=ids.shape[1] - 1)
        return torch.where(ids.gather(1, pos) == cols, vals.gather(1, pos),
                           0.0)

    def get_similarity(self, a, b):
        dev = self.tables_device()
        return float(self._lookup_corr(_ids([a], dev), _ids([[b]], dev))[0, 0])

    def get_most_similar(self, entity_id, n=10):
        """All entities but self, by descending correlation, first n
        (reference Correlation/Extensions.GetNearestNeighbors :153-166)."""
        if not self.is_topk:
            row = self.corr[entity_id:entity_id + 1].clone()
            row[0, entity_id] = -np.inf
            order = torch.sort(row, dim=1, descending=True,
                               stable=True).indices[0]
            return order[:min(int(n), row.shape[1] - 1)].cpu().numpy() \
                .astype(np.int32)
        return self.nbr_ids[entity_id][:int(n)].cpu().numpy()

    # model-file sections (discriminated: "dense" -> reference-style
    # matrix, "topk N k" -> flat neighbour id/value arrays)
    def _write_corr(self, w):
        if not self.is_topk:
            w._f.write("dense\n")
            w.matrix(self.corr.cpu().numpy())
        else:
            N, k = self.nbr_ids.shape
            w._f.write(f"topk {N} {k}\n")
            w.int_vector(self.nbr_ids.reshape(-1).cpu().numpy())
            w.vector(self.nbr_vals.reshape(-1).cpu().numpy())

    def _read_corr(self, r):
        dev = resolve_device(self.device)
        parts = r._line().split()
        if parts[0] == "dense":
            self._store_dense(torch.from_numpy(r.matrix()).to(dev))
        else:
            N, k = int(parts[1]), int(parts[2])
            ids = torch.from_numpy(r.int_vector().reshape(N, k)).to(dev)
            vals = torch.from_numpy(r.vector().reshape(N, k)).to(dev)
            self._store_topk(ids, vals)

    def load_state(self, state: dict):
        """Start from a given correlation ({"corr"} or {"nbr_ids",
        "nbr_vals"}, from ``convert.knn_state_from_jax``)."""
        dev = resolve_device(self.device)
        if "corr" in state:
            self._store_dense(torch.as_tensor(
                np.asarray(state["corr"], np.float32)).to(dev))
        else:
            self._store_topk(
                torch.as_tensor(np.asarray(state["nbr_ids"], np.int32)).to(dev),
                torch.as_tensor(np.asarray(state["nbr_vals"],
                                           np.float32)).to(dev))


def _signed_power(x, q: float):
    return torch.sign(x) * x.abs() ** float(np.float32(q))


# ---------------------------------------------------------------------------
# implicit-feedback KNN (reference ItemRecommendation/KNN.cs)
# ---------------------------------------------------------------------------

class _ImplicitKNN(IncrementalItemRecommender, _CorrelationStore):
    HYPERPARAMS = {
        "k": int,
        "correlation": BinaryCorrelationType,
        "q": float,
        "weighted": bool,
        "alpha": float,
    }
    EXTRA_PARAMS = {"device": str}

    ENTITY = "user"      # correlate users or items
    ATTRIBUTES = False   # correlate on attributes instead of feedback

    def __init__(self):
        super().__init__()
        # defaults per reference ItemRecommendation/KNN.cs:32-58
        self.k = 80
        self.q = 1.0
        self.alpha = 0.5
        self.weighted = False
        self.correlation = BinaryCorrelationType.COSINE
        self.device = "cuda"
        self.corr = None            # [N, N] correlation (dense mode)
        self.nbr_ids = None         # [N, k] ids + values (top-k mode)
        self.nbr_vals = None
        self.neighbors = None       # [N, k] neighbour ids
        self.attributes = None      # InteractionData (entity -> attribute)
        self._scoring = None        # cached scoring tensors

    def tables_device(self):
        return resolve_device(self.device)

    def _correlation_data(self):
        f = self.feedback
        if self.ATTRIBUTES:
            if self.attributes is None:
                raise ValueError(f"{type(self).__name__} needs attribute data")
            n = (f.num_users if self.ENTITY == "user" else f.num_items)
            n_attr = self.attributes.num_items
            return self.attributes, max(n, self.attributes.num_users), n_attr
        if self.ENTITY == "user":
            return (_EntityView(f.users, f.items), f.num_users, f.num_items)
        return (_EntityView(f.items, f.users), f.num_items, f.num_users)

    def train(self):
        data, n, m = self._correlation_data()
        kind = _BINARY_KIND[self.correlation.value]
        if n <= corr_ops.DENSE_NMAX:
            self._store_dense(corr_ops.binary_correlation(
                data, n, m, kind=kind, alpha=self.alpha,
                weighted=self.weighted, device=self.device))
        else:
            if self.k == INF_K:
                raise ValueError(
                    f"{type(self).__name__}: k=inf (SumUp) needs the full "
                    f"[N, N] correlation matrix; impossible at N={n} "
                    f"(> DENSE_NMAX={corr_ops.DENSE_NMAX}) — set a finite k")
            self._store_topk(*corr_ops.binary_correlation_topk(
                data, n, m, self.k, kind=kind, alpha=self.alpha,
                weighted=self.weighted, device=self.device))
        self._build_neighbors()

    def _build_neighbors(self):
        if self.is_topk:
            self.neighbors = self.nbr_ids
        elif self.k != INF_K:
            self.neighbors = corr_ops.nearest_neighbors(self.corr, self.k)

    def _incidence(self, rows: int, cols: int):
        """int8 [rows, cols] incidence of the training feedback on the
        device (duplicate events collapse; rows and columns past the
        feedback's stay zero)."""
        f = self.feedback
        dev = self.tables_device()
        M = torch.zeros((rows, cols), dtype=torch.int8, device=dev)
        M[_ids(f.users, dev), _ids(f.items, dev)] = 1
        return M

    def _scoring_state(self):
        """Cached tensors of ``catalog_scorer``: the incidence, the
        neighbour weights sign(c)|c|^q (dense Wk, or top-k rows and a
        sparse CSR Wk) and the row norms."""
        if self._scoring is not None:
            return self._scoring
        f = self.feedback
        N = self._corr_rows()
        user = self.ENTITY == "user"
        M = self._incidence(max(N, f.num_users) if user else f.num_users,
                            f.num_items if user else max(N, f.num_items))
        st = {"M": M}
        if self.is_topk:
            Wq = _signed_power(self.nbr_vals, self.q)
            norm = Wq.sum(dim=1)
            st["norm"] = torch.where(norm == 0, 1.0, norm)
            if user:
                st["Wq"] = Wq
            else:
                k = Wq.shape[1]
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")   # "beta" notices
                    st["Wk"] = torch.sparse_csr_tensor(
                        torch.arange(0, N * k + 1, k, device=Wq.device),
                        self.nbr_ids.reshape(-1).to(torch.int64),
                        Wq.reshape(-1), size=(N, N))
        elif self.k == INF_K:
            # SumUp (reference KNN K=inf): unnormalized sum of corr^q
            st["W"] = _signed_power(self.corr, self.q)
        else:
            rows = torch.arange(N, device=self.corr.device)[:, None].expand(
                -1, self.neighbors.shape[1]).reshape(-1)
            cols = self.neighbors.reshape(-1).to(torch.int64)
            Wk = torch.zeros_like(self.corr)
            Wk[rows, cols] = _signed_power(self.corr[rows, cols], self.q)
            norm = Wk.sum(dim=1)
            st["W"] = Wk
            st["norm"] = torch.where(norm == 0, 1.0, norm)
        if user and not self.is_topk:
            st["Mf"] = M.float()
        self._scoring = st
        return st

    def catalog_scorer(self, device=None):
        if self.corr is None and self.nbr_ids is None:
            raise RuntimeError(f"{type(self).__name__}: model not trained")
        st = self._scoring_state()
        f = self.feedback
        n_users, n_items = f.num_users, f.num_items
        user = self.ENTITY == "user"

        def score(users):
            with exact_float32():
                return scores(users.clamp(0, n_users - 1))

        def scores(users):
            if self.is_topk and user:
                out = self._gather_user_scores(st, users, n_items)
            elif self.is_topk:
                Mu = st["M"][users].float()
                out = torch.sparse.mm(st["Wk"], Mu.T.contiguous()).T \
                    / st["norm"][None, :]
            elif user:
                out = st["W"][users] @ st["Mf"]
                if "norm" in st:
                    out = out / st["norm"][users][:, None]
            else:
                out = st["M"][users].float() @ st["W"].T
                if "norm" in st:
                    out = out / st["norm"][None, :]
            return out[:, :n_items].contiguous()
        return self._on_device(score, device)

    def _gather_user_scores(self, st, users, n_items):
        """Top-k user entity: each user's score row is the weighted sum of
        its k neighbours' incidence rows, gathered in steps of at most
        ``_GATHER_ELEMS`` elements."""
        M, Wq, norm = st["M"], st["Wq"], st["norm"]
        k = Wq.shape[1]
        step = max(1, _GATHER_ELEMS // max(k * n_items, 1))
        out = []
        for s in range(0, users.shape[0], step):
            u = users[s:s + step]
            rows = M[self.nbr_ids[u].to(torch.int64).reshape(-1), :n_items]
            rows = rows.float().reshape(u.shape[0], k, n_items)
            out.append(torch.bmm(Wq[u][:, None, :], rows)[:, 0]
                       / norm[u][:, None])
        return torch.cat(out)

    def score_catalog(self, users):
        return self._scores_from_scorer(users)

    def predict_batch(self, users, items):
        dev = self.tables_device()
        u = _ids(users, dev)
        i = _ids(items, dev)
        f = self.feedback
        ok = (u >= 0) & (u < f.num_users) & (i >= 0) & (i < f.num_items)
        out = torch.full(u.shape, float(_UNKNOWN), dtype=torch.float32,
                         device=dev)
        if bool(ok.any()):
            uniq, inv = torch.unique(u[ok], return_inverse=True)
            with torch.no_grad():
                scores = self.catalog_scorer()(uniq)
            out[ok] = scores[inv, i[ok]]
        return out.cpu().numpy()

    def _retrain(self, users, items):
        """A full retrain on the current data (JAX ``_retrain``)."""
        if self.corr is not None or self.nbr_ids is not None:
            self.train()

    # correlation matrices round-trip in the reference text format
    # (reference ItemRecommendation/KNN.cs:118-160); top-k mode stores
    # the neighbour lists instead
    def save_model(self, path):
        with ModelWriter(path, type(self).__name__, "2.99") as w:
            w._f.write(f"{self.correlation.value}\n")
            self._write_corr(w)

    def load_model(self, path):
        with ModelReader(path, type(self).__name__) as r:
            name = r._line()
            self.correlation = next(m for m in BinaryCorrelationType
                                    if m.value == name)
            self._read_corr(r)
        self._build_neighbors()

    def load_state(self, state: dict):
        super().load_state(state)
        self._build_neighbors()


class _UserSimilarityProvider:
    """Reference IUserSimilarityProvider.cs:7-19."""

    def get_user_similarity(self, user_id1, user_id2):
        return self.get_similarity(user_id1, user_id2)

    def get_most_similar_users(self, user_id, n=10):
        return self.get_most_similar(user_id, n)


class _ItemSimilarityProvider:
    """Reference IItemSimilarityProvider.cs:7-19."""

    def get_item_similarity(self, item_id1, item_id2):
        return self.get_similarity(item_id1, item_id2)

    def get_most_similar_items(self, item_id, n=10):
        return self.get_most_similar(item_id, n)


class UserKNN(_ImplicitKNN, _UserSimilarityProvider):
    """Reference ItemRecommendation/UserKNN.cs:30."""
    ENTITY = "user"


class ItemKNN(_ImplicitKNN, _ItemSimilarityProvider):
    """Reference ItemRecommendation/ItemKNN.cs:31."""
    ENTITY = "item"


class UserAttributeKNN(_ImplicitKNN, _UserSimilarityProvider):
    """Reference ItemRecommendation/UserAttributeKNN.cs:26."""
    ENTITY = "user"
    ATTRIBUTES = True
    REQUIRED_SIDE_INFO = ("user_attributes",)

    @property
    def user_attributes(self):
        return self.attributes

    @user_attributes.setter
    def user_attributes(self, data):
        self.attributes = data


class ItemAttributeKNN(_ImplicitKNN, _ItemSimilarityProvider):
    """Reference ItemRecommendation/ItemAttributeKNN.cs:26."""
    ENTITY = "item"
    ATTRIBUTES = True
    REQUIRED_SIDE_INFO = ("item_attributes",)

    @property
    def item_attributes(self):
        return self.attributes

    @item_attributes.setter
    def item_attributes(self, data):
        self.attributes = data


# ---------------------------------------------------------------------------
# rating-prediction KNN (reference RatingPrediction/KNN.cs)
# ---------------------------------------------------------------------------

class _RatingKNN(IncrementalRatingPredictor, _CorrelationStore):
    HYPERPARAMS = {
        "k": int,
        "correlation": RatingCorrelationType,
        "weighted_binary": bool,
        "alpha": float,
        "reg_u": float,
        "reg_i": float,
        "num_iter": int,
    }
    EXTRA_PARAMS = {"device": str}

    ENTITY = "user"
    ATTRIBUTES = False

    def __init__(self):
        super().__init__()
        # defaults per reference RatingPrediction/KNN.cs:50 + UserItemBaseline
        self.baseline = UserItemBaseline()
        self.k = 80
        self.alpha = 0.0
        self.weighted_binary = False
        self.correlation = RatingCorrelationType.PEARSON
        self.device = "cuda"
        self.corr = None
        self.nbr_ids = None
        self.nbr_vals = None
        self.attributes = None
        self._lists = None

    # the device and the baseline hyperparameters pass through to the
    # baseline (reference KNN.cs:71-78)
    @property
    def device(self):
        return self.baseline.device

    @device.setter
    def device(self, v):
        self.baseline.device = v

    @property
    def reg_u(self):
        return self.baseline.reg_u

    @reg_u.setter
    def reg_u(self, v):
        self.baseline.reg_u = float(v)

    @property
    def reg_i(self):
        return self.baseline.reg_i

    @reg_i.setter
    def reg_i(self, v):
        self.baseline.reg_i = float(v)

    @property
    def num_iter(self):
        return self.baseline.num_iter

    @num_iter.setter
    def num_iter(self, v):
        self.baseline.num_iter = int(v)

    def tables_device(self):
        return resolve_device(self.device)

    def _k_store(self, n: int) -> int:
        """Stored neighbours per row in top-k mode: enough headroom over
        the prediction-time K that truncation rarely bites."""
        k = 512 if self.k == INF_K else max(128, 3 * self.k)
        return min(n - 1, k)

    def train(self):
        self.baseline.ratings = self.ratings
        self.baseline.train()
        data = self.ratings
        dev = self.device
        if self.ATTRIBUTES:
            if self.attributes is None:
                raise ValueError(f"{type(self).__name__} needs attribute data")
            n = (data.num_users if self.ENTITY == "user" else data.num_items)
            n = max(n, self.attributes.num_users)
            kind = _BINARY_KIND.get(self.correlation.value, "cosine")
            if n <= corr_ops.DENSE_NMAX:
                self._store_dense(corr_ops.binary_correlation(
                    self.attributes, n, self.attributes.num_items,
                    kind=kind, alpha=self.alpha,
                    weighted=self.weighted_binary, device=dev))
            else:
                self._store_topk(*corr_ops.binary_correlation_topk(
                    self.attributes, n, self.attributes.num_items,
                    self._k_store(n), kind=kind, alpha=self.alpha,
                    weighted=self.weighted_binary, device=dev))
        elif self.correlation in (RatingCorrelationType.PEARSON,
                                  RatingCorrelationType.RATING_COSINE):
            kind = ("pearson" if self.correlation ==
                    RatingCorrelationType.PEARSON else "cosine")
            n = data.num_users if self.ENTITY == "user" else data.num_items
            if n <= corr_ops.DENSE_NMAX:
                self._store_dense(corr_ops.rating_correlation(
                    data, entity=self.ENTITY, kind=kind,
                    shrinkage=self.alpha, device=dev))
            else:
                self._store_topk(*corr_ops.rating_correlation_topk(
                    data, self._k_store(n), entity=self.ENTITY, kind=kind,
                    shrinkage=self.alpha, device=dev))
        else:
            if self.ENTITY == "user":
                view, n, m = (_EntityView(data.users, data.items),
                              data.num_users, data.num_items)
            else:
                view, n, m = (_EntityView(data.items, data.users),
                              data.num_items, data.num_users)
            kind = _BINARY_KIND[self.correlation.value]
            if n <= corr_ops.DENSE_NMAX:
                self._store_dense(corr_ops.binary_correlation(
                    view, n, m, kind=kind, alpha=self.alpha,
                    weighted=self.weighted_binary, device=dev))
            else:
                self._store_topk(*corr_ops.binary_correlation_topk(
                    view, n, m, self._k_store(n), kind=kind,
                    alpha=self.alpha, weighted=self.weighted_binary,
                    device=dev))

    def _co_lists(self):
        """The training ratings grouped by the entity a pair fixes (item
        for user KNN: its raters; user for item KNN: its rated items), on
        the device: (indptr [K+1], other ids [nnz], values [nnz]), each
        list in ascending other-id order, ties in event order."""
        data = self.ratings
        key = (id(data), str(self.tables_device()))
        if self._lists is not None and self._lists[0] == key:
            return self._lists[1]
        dev = self.tables_device()
        csr = data.by_item if self.ENTITY == "user" else data.by_user
        lists = (_ids(csr.indptr, dev), _ids(csr.keys, dev),
                 torch.from_numpy(data.values[csr.order]).to(dev))
        self._lists = (key, lists)
        return lists

    def _predict_pairs(self, users, items):
        """baseline + sum_w w * (r - baseline) / sum_w over the first K
        positively correlated co-raters in (weight desc, id asc) order
        (reference RatingPrediction/UserKNN.Predict :58-93)."""
        data = self.ratings
        base = self.baseline._predict_pairs(users, items)
        indptr, others, values = self._co_lists()
        user = self.ENTITY == "user"
        rows = users if user else items          # the correlation row
        fixed = items if user else users         # the list's entity
        valid = (rows >= 0) & (rows < self._corr_rows()) & (fixed >= 0) & \
            (fixed < (data.num_items if user else data.num_users))
        f = fixed.clamp(0, indptr.shape[0] - 2)
        start = indptr[f]
        lens = torch.where(valid, indptr[f + 1] - start, 0)
        # pairs grouped by power-of-two list length (16, 32, ...); the
        # pairs with no list (bucket 0) keep the baseline
        L_of = torch.where(lens > 0, torch.log2(
            lens.clamp(min=16).double()).ceil().long(), 0)
        counts = torch.bincount(L_of).tolist()
        order = torch.argsort(L_of, stable=True)
        shift = torch.zeros_like(base)
        pos0 = counts[0]
        for b in range(1, len(counts)):
            L, end = 1 << b, pos0 + counts[b]
            for s in range(pos0, end, max(1, _PAIR_ELEMS // L)):
                idx = order[s:min(s + max(1, _PAIR_ELEMS // L), end)]
                shift[idx] = self._list_shift(
                    rows[idx], fixed[idx], start[idx], lens[idx], L,
                    others, values, user)
            pos0 = end
        out = base.double() + shift.double()
        return out.clamp(self.min_rating, self.max_rating).float()

    def _list_shift(self, rows, fixed, start, lens, L, others, values, user):
        """sum w (r - b) / sum w for a chunk of pairs whose lists hold at
        most L entries (0 where no co-rater qualifies)."""
        ar = torch.arange(L, device=rows.device)
        inside = ar[None, :] < lens[:, None]
        pos = (start[:, None] + ar[None, :]).clamp(max=others.shape[0] - 1)
        oth = others[pos]
        w = self._lookup_corr(rows, oth)
        keep = inside & (w > 0) & (oth != rows[:, None])
        if self.k != INF_K and L > self.k:
            # the first K by weight; equal weights keep the lists' order
            # (other id, then event)
            w_sort, perm = torch.sort(torch.where(keep, w, -np.inf), dim=1,
                                      descending=True, stable=True)
            K = self.k
            perm = perm[:, :K]
            w, oth, keep = w_sort[:, :K], oth.gather(1, perm), \
                keep.gather(1, perm)
            pos = pos.gather(1, perm)
        r = values[pos]
        fx = fixed[:, None].expand_as(oth)
        if user:
            b = self.baseline._predict_pairs(oth.reshape(-1), fx.reshape(-1))
        else:
            b = self.baseline._predict_pairs(fx.reshape(-1), oth.reshape(-1))
        b = b.reshape(oth.shape)
        w = torch.where(keep, w, 0.0)
        num = (w * (r - b)).sum(dim=1)
        den = w.sum(dim=1)
        return torch.where(keep.any(dim=1), num / torch.where(
            den == 0, 1.0, den), 0.0)

    def pair_scorer(self):
        if self.corr is None and self.nbr_ids is None:
            return None
        return self._predict_pairs

    def catalog_scorer(self, device=None):
        return self._on_device(pairs_catalog_scorer(
            self._predict_pairs, self.num_items_trained), device)

    def score_catalog(self, users):
        return self._scores_from_scorer(users)

    def predict_batch(self, users, items):
        dev = self.tables_device()
        with torch.no_grad():
            return self._predict_pairs(_ids(users, dev),
                                       _ids(items, dev)).cpu().numpy()

    def can_predict(self, user_id, item_id):
        return True

    def _retrain(self, users, items):
        """A full retrain on the current data (JAX ``_retrain``)."""
        if self.corr is not None or self.nbr_ids is not None:
            self.train()

    def save_model(self, path):
        self.baseline.ratings = self.ratings
        self.baseline.save_model(path + "-global-effects")
        with ModelWriter(path, type(self).__name__, "3.03") as w:
            w._f.write(f"{self.correlation.value}\n")
            self._write_corr(w)

    def load_model(self, path):
        self.baseline.load_model(path + "-global-effects")
        with ModelReader(path, type(self).__name__) as r:
            name = r._line()
            self.correlation = next(m for m in RatingCorrelationType
                                    if m.value == name)
            self._read_corr(r)


class UserKNNRating(_RatingKNN, _UserSimilarityProvider):
    """Reference RatingPrediction/UserKNN.cs:28."""
    ENTITY = "user"


class ItemKNNRating(_RatingKNN, _ItemSimilarityProvider):
    """Reference RatingPrediction/ItemKNN.cs:28."""
    ENTITY = "item"


class UserAttributeKNNRating(_RatingKNN, _UserSimilarityProvider):
    """Reference RatingPrediction/UserAttributeKNN.cs."""
    ENTITY = "user"
    ATTRIBUTES = True
    REQUIRED_SIDE_INFO = ("user_attributes",)

    def __init__(self):
        super().__init__()
        self.correlation = RatingCorrelationType.BINARY_COSINE

    @property
    def user_attributes(self):
        return self.attributes

    @user_attributes.setter
    def user_attributes(self, data):
        self.attributes = data


class ItemAttributeKNNRating(_RatingKNN, _ItemSimilarityProvider):
    """Reference RatingPrediction/ItemAttributeKNN.cs."""
    ENTITY = "item"
    ATTRIBUTES = True
    REQUIRED_SIDE_INFO = ("item_attributes",)

    def __init__(self):
        super().__init__()
        self.correlation = RatingCorrelationType.BINARY_COSINE

    @property
    def item_attributes(self):
        return self.attributes

    @item_attributes.setter
    def item_attributes(self, data):
        self.attributes = data
