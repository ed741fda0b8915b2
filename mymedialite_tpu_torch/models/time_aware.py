"""Time-aware baseline rating predictors (Koren, TKDD 2009) of the port.

Counterparts of ``mymedialite_tpu/models/time_aware.py`` (reference
``RatingPrediction/TimeAwareBaseline.cs:44``: time-binned item bias,
user drift alpha * dev_u(t), per-day user bias, user scaling c_u +
c_ut; ``TimeAwareBaselineWithFrequencies.cs:42``: plus an item bias per
log-frequency of the user's ratings that day).

Training is the JAX package's minibatch epoch in plain PyTorch on the
model's device: the padded ratings in the order of
``np.random.default_rng(random_seed).permutation`` (the JAX package's
data order, reproduced exactly), cut into batches of ``batch_size``,
taken in a per-epoch batch order. Every update of a batch reads the
tables as they stood at the batch's start, and duplicate ids sum
(``ops/sgd.py add_rows``, whose sums do not depend on their order; the
dense [U, days], [I, bins] and [I, freqs] tables through their flat
views). The JAX package draws the batch order from
threefry, which the port cannot reproduce: the port draws it from a
``torch.Generator`` seeded with ``random_seed``, and ``iterate(order)``
takes a given order (the parity tests hand it the JAX orders).

Prediction without a time is mu + b_u + b_i in float32; with times
(``predict_batch_time``) the tables are read on the device and the
prediction is computed in float64 there, as the JAX package computes it
in float64 on the host; relative days floor (numpy's ``//``) and the
bin is clamped to [0, num_bins - 1].

A pinned fault of the reference that both packages keep: the frequency
model updates ``item_bias_at_frequency`` by ``err * b - reg * b`` with b
the table's own entry, so that from its zero start the table never
moves (ROADMAP §C).
"""

from __future__ import annotations

import numpy as np
import torch

from mymedialite_tpu_torch.device import resolve_device
from mymedialite_tpu_torch.io.model_io import ModelReader, ModelWriter
from mymedialite_tpu_torch.models.base import IterativeModel, RatingPredictor
from mymedialite_tpu_torch.ops.sgd import add_rows

SECONDS_PER_DAY = 86_400


def time_aware_step(p, batch, hp, *, with_freq: bool):
    """One minibatch update of the time-aware tables ``p`` in place (JAX
    ``_time_aware_epoch``'s step): every delta reads the tables as they
    were at the batch's start, duplicate ids sum. ``batch`` holds the
    batch's slices of the epoch arrays; ``hp`` the learn rates, the
    regularizers and ``global_average``. Computes in the tables' dtype."""
    u, i, v, w = batch["users"], batch["items"], batch["values"], \
        batch["weights"]
    day, bin_, dev = batch["days"], batch["bins"], batch["dev"]
    nd = p["user_bias_by_day"].shape[1]
    nb = p["item_bias_by_time_bin"].shape[1]
    ud = u * nd + day
    ib = i * nb + bin_
    bu = p["user_bias"][u]
    bi = p["item_bias"][i]
    al = p["alpha"][u]
    bib = p["item_bias_by_time_bin"].view(-1)[ib]
    bud = p["user_bias_by_day"].view(-1)[ud]
    cu = p["user_scaling"][u]
    cud = p["user_scaling_by_day"].view(-1)[ud]

    pred = hp["global_average"] + bu + al * dev + bud + (bi + bib) * (cu + cud)
    if with_freq:
        nf = p["item_bias_at_frequency"].shape[1]
        fi = i * nf + batch["freqs"]
        biaf = p["item_bias_at_frequency"].view(-1)[fi]
        pred = pred + biaf
    err = (v - pred) * w

    add_rows(p["alpha"], u, hp["alpha_learn_rate"] * (
        err * dev - hp["reg_alpha"] * w * al))
    add_rows(p["user_bias"], u, hp["user_bias_learn_rate"] * (
        err - hp["reg_u"] * w * bu))
    add_rows(
        p["user_bias_by_day"].view(-1), ud, hp["user_bias_by_day_learn_rate"] * (
            err - hp["reg_user_bias_by_day"] * w * bud))
    add_rows(p["item_bias"], i, hp["item_bias_learn_rate"] * (
        err * (cu + cud) - hp["reg_i"] * w * bi))
    add_rows(
        p["item_bias_by_time_bin"].view(-1), ib, hp["item_bias_by_time_bin_learn_rate"] * (
            err * (cu + cud) - hp["reg_item_bias_by_time_bin"] * w * bib))
    add_rows(p["user_scaling"], u, hp["user_scaling_learn_rate"] * (
        err * (bi + bib) - hp["reg_user_scaling"] * w * (cu - 1.0)))
    add_rows(
        p["user_scaling_by_day"].view(-1), ud, hp["user_scaling_by_day_learn_rate"] * (
            err * (bi + bib) - hp["reg_user_scaling_by_day"] * w * cud))
    if with_freq:
        # the reference's update, kept: err * b_{i,f} - reg * b_{i,f}
        add_rows(
            p["item_bias_at_frequency"].view(-1), fi, hp["item_bias_at_frequency_learn_rate"] * (
                err * biaf - hp["reg_item_bias_at_frequency"] * w * biaf))


def epoch_batch(data, start: int, batch_size: int):
    """The slices [start, start + batch_size) of the epoch arrays."""
    return {k: t[start:start + batch_size] for k, t in data.items()}


def time_aware_epoch(p, data, order, hp, *, batch_size: int, with_freq: bool):
    """One epoch: the batches of ``data`` in ``order`` (batch indices)."""
    for b in order:
        time_aware_step(p, epoch_batch(data, int(b) * batch_size, batch_size),
                        hp, with_freq=with_freq)


class TimeAwareBaseline(RatingPredictor, IterativeModel):
    HYPERPARAMS = {
        "num_iter": int,
        "bin_size": int,
        "beta": float,
        "user_bias_learn_rate": float,
        "item_bias_learn_rate": float,
        "alpha_learn_rate": float,
        "item_bias_by_time_bin_learn_rate": float,
        "user_bias_by_day_learn_rate": float,
        "user_scaling_learn_rate": float,
        "user_scaling_by_day_learn_rate": float,
        "reg_u": float,
        "reg_i": float,
        "reg_alpha": float,
        "reg_item_bias_by_time_bin": float,
        "reg_user_bias_by_day": float,
        "reg_user_scaling": float,
        "reg_user_scaling_by_day": float,
    }
    EXTRA_PARAMS = {"batch_size": int, "device": str}

    time_aware = True
    WITH_FREQUENCIES = False

    def __init__(self):
        super().__init__()
        # defaults per reference TimeAwareBaseline.cs:118-143
        self.num_iter = 30
        self.bin_size = 70
        self.beta = 0.4
        self.user_bias_learn_rate = 0.003
        self.item_bias_learn_rate = 0.002
        self.alpha_learn_rate = 0.00001
        self.item_bias_by_time_bin_learn_rate = 0.000005
        self.user_bias_by_day_learn_rate = 0.0025
        self.user_scaling_learn_rate = 0.008
        self.user_scaling_by_day_learn_rate = 0.002
        self.reg_u = 0.03
        self.reg_i = 0.03
        self.reg_alpha = 50.0
        self.reg_item_bias_by_time_bin = 0.1
        self.reg_user_bias_by_day = 0.005
        self.reg_user_scaling = 0.01
        self.reg_user_scaling_by_day = 0.005
        self.batch_size = 65_536
        self.random_seed = 42
        self.device = "cuda"
        self.params = None
        self._epoch = None
        self._order_gen = None

    def _relative_day(self, times):
        """Days since the earliest training time, floored (host)."""
        return ((np.asarray(times, dtype=np.int64) - self._earliest)
                // SECONDS_PER_DAY).astype(np.int32)

    def train(self):
        data = self.ratings
        if data.times is None:
            raise ValueError("TimeAwareBaseline requires timed ratings")
        self._earliest = int(data.times.min())
        days = self._relative_day(data.times)
        self._num_days = int(days.max()) + 1
        self._latest_day = int(days.max())
        self._num_bins = (self._num_days - 1) // self.bin_size + 1
        U, I = data.num_users, data.num_items

        # mean rating day per user (reference Train :150-160)
        sums = np.bincount(data.users, weights=days, minlength=U)
        cu = np.maximum(data.count_by_user, 1)
        mean_day = sums / cu
        mean_day[data.count_by_user == 0] = self._latest_day
        self._user_mean_day = mean_day.astype(np.float32)

        self.global_average = float(data.average)
        dev = resolve_device(self.device)

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=dev)
        self.params = dict(
            user_bias=zeros(U), item_bias=zeros(I), alpha=zeros(U),
            item_bias_by_time_bin=zeros(I, self._num_bins),
            user_bias_by_day=zeros(U, self._num_days),
            user_scaling=torch.ones(U, dtype=torch.float32, device=dev),
            user_scaling_by_day=zeros(U, self._num_days))
        self._prepare_epoch()
        for _ in range(self.num_iter):
            self.iterate()

    def _prepare_epoch(self):
        """The padded epoch arrays on the device, in the JAX package's
        data order; called by ``train()`` and by ``iterate()`` after
        ``load_model``."""
        data = self.ratings
        if data is None or data.times is None:
            raise RuntimeError(f"{type(self).__name__}: timed ratings must "
                               "be set before iterating")
        days = self._relative_day(data.times)
        # dev_u(t) per rating (constant during training), float64 as in
        # the JAX package, then stored as float32
        diff = days - self._user_mean_day[data.users]
        dev_t = np.sign(diff) * np.abs(diff) ** self.beta

        n = len(data)
        perm = np.random.default_rng(self.random_seed).permutation(n)
        B = min(self.batch_size, max(n, 1))
        n_pad = -(-n // B) * B
        device = resolve_device(self.device)

        def pad(a, dtype):
            out = np.zeros(n_pad, dtype)
            out[:n] = np.asarray(a, dtype)[perm]
            return torch.from_numpy(out).to(device)
        ints = np.int64
        self._epoch = dict(
            users=pad(data.users, ints), items=pad(data.items, ints),
            values=pad(data.values, np.float32),
            weights=pad(np.ones(n, np.float32), np.float32),
            days=pad(np.clip(days, 0, self._num_days - 1), ints),
            bins=pad(np.clip(days // self.bin_size, 0, self._num_bins - 1),
                     ints),
            dev=pad(dev_t, np.float32))
        self._B = B
        if self.WITH_FREQUENCIES:
            self._setup_frequencies(days, perm, n_pad)
        self._order_gen = torch.Generator()
        self._order_gen.manual_seed(self.random_seed)

    def _setup_frequencies(self, days, perm, n_pad):
        """The log-frequency of ratings per (user, day) (reference
        TimeAwareBaselineWithFrequencies.Train :90-106): the pairs
        counted on the device, the logarithms in float64 on the host."""
        data = self.ratings
        U, nd = data.num_users, self._num_days
        device = resolve_device(self.device)
        key = torch.from_numpy(data.users.astype(np.int64) * nd + days).to(
            device)
        uniq, inv, counts = torch.unique(key, return_inverse=True,
                                         return_counts=True)
        counts = counts.cpu().numpy()
        logf = np.ceil(np.log(np.maximum(counts, 1)) /
                       np.log(self.frequency_log_base)).astype(np.int32)
        logf_t = torch.from_numpy(logf).to(device)
        fb = torch.zeros(U * nd, dtype=torch.int32, device=device)
        fb[uniq] = logf_t
        self._freq_by_day = fb.view(U, nd)
        self._num_freqs = max(int(logf.max()) + 1 if logf.size else 1, 1)
        tbl = self.params.get("item_bias_at_frequency")
        if tbl is not None:
            # a loaded model keeps its table, grown to the data's
            # frequencies
            if tbl.shape[1] < self._num_freqs:
                tbl = torch.nn.functional.pad(
                    tbl, (0, self._num_freqs - tbl.shape[1]))
            self._num_freqs = int(tbl.shape[1])
            self.params["item_bias_at_frequency"] = tbl
        else:
            self.params["item_bias_at_frequency"] = torch.zeros(
                (data.num_items, self._num_freqs), dtype=torch.float32,
                device=device)
        per_rating = logf_t[inv].long().cpu().numpy()
        out = np.zeros(n_pad, np.int64)
        out[:len(data)] = per_rating[perm]
        self._epoch["freqs"] = torch.from_numpy(out).to(device)

    def _hp(self):
        names = [k for k in self.HYPERPARAMS if k not in ("num_iter",
                                                          "bin_size")]
        hp = {k: float(np.float32(getattr(self, k))) for k in names}
        hp["global_average"] = float(np.float32(self.global_average))
        if self.WITH_FREQUENCIES:
            for k in ("item_bias_at_frequency_learn_rate",
                      "reg_item_bias_at_frequency"):
                hp[k] = float(np.float32(getattr(self, k)))
        return hp

    def iterate(self, order=None):
        """One epoch; ``order`` (batch indices) defaults to a permutation
        from the model's generator."""
        if self._epoch is None:
            self._prepare_epoch()     # a loaded model keeps training
        nb = self._epoch["users"].shape[0] // self._B
        if order is None:
            order = torch.randperm(nb, generator=self._order_gen).tolist()
        with torch.no_grad():
            time_aware_epoch(self.params, self._epoch, order, self._hp(),
                             batch_size=self._B,
                             with_freq=self.WITH_FREQUENCIES)

    def load_state(self, state):
        """Start from a trained state (``convert.time_aware_state_from_jax``):
        the tables, the time grid and the user mean days. The epoch
        arrays are rebuilt from ``ratings`` at the next ``iterate()``."""
        dev = resolve_device(self.device)
        self.params = {k: torch.from_numpy(np.array(v, np.float32)).to(dev)
                       for k, v in state["params"].items()}
        self._earliest = state["earliest"]
        self._num_days = state["num_days"]
        self._latest_day = state["latest_day"]
        self._num_bins = state["num_bins"]
        self._user_mean_day = np.array(state["user_mean_day"], np.float32)
        self.global_average = state["global_average"]
        if "freq_by_day" in state:
            self._freq_by_day = torch.from_numpy(
                np.array(state["freq_by_day"], np.int32)).to(dev)
        self.num_users_trained = self.params["user_bias"].shape[0]
        self.num_items_trained = self.params["item_bias"].shape[0]
        self._epoch = None

    # --- prediction ---

    def _tensor(self, a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a), dtype=dtype,
                               device=self.params["user_bias"].device)

    def predict_batch(self, users, items):
        """Without time: mu + b_u + b_i (reference Predict(u,i) :233-243)."""
        p = self.params
        u, i = self._tensor(users), self._tensor(items)
        U, I = p["user_bias"].shape[0], p["item_bias"].shape[0]
        ok_u = (u >= 0) & (u < U)
        ok_i = (i >= 0) & (i < I)
        zero = torch.zeros((), dtype=torch.float32, device=u.device)
        out = torch.full(u.shape, np.float32(self.global_average),
                         dtype=torch.float32, device=u.device)
        out = out + torch.where(ok_u, p["user_bias"][u.clamp(0, U - 1)], zero)
        out = out + torch.where(ok_i, p["item_bias"][i.clamp(0, I - 1)], zero)
        return out.cpu().numpy()

    def predict_batch_time(self, users, items, times):
        """Full time-aware prediction (reference Predict(u,i,t) :264-295),
        in float64 on the tables' device."""
        p = self.params
        f64 = torch.float64
        u, i = self._tensor(users), self._tensor(items)
        t = self._tensor(times)
        days = torch.div(t - self._earliest, SECONDS_PER_DAY,
                         rounding_mode="floor")
        bins = torch.div(days, self.bin_size, rounding_mode="floor").clamp(
            0, self._num_bins - 1)
        U, I = p["user_bias"].shape[0], p["item_bias"].shape[0]
        ok_u = (u >= 0) & (u < U)
        ok_i = (i >= 0) & (i < I)
        in_days = ok_u & (days >= 0) & (days <= self._latest_day)
        uc, ic = u.clamp(0, U - 1), i.clamp(0, I - 1)
        dc = days.clamp(0, p["user_bias_by_day"].shape[1] - 1)
        zero = torch.zeros((), dtype=f64, device=u.device)

        mean_day = torch.from_numpy(self._user_mean_day).to(u.device)
        diff = days.to(f64) - mean_day[uc].to(f64)
        dev = torch.sign(diff) * diff.abs() ** self.beta
        out = torch.full(u.shape, self.global_average, dtype=f64,
                         device=u.device)
        out = out + torch.where(
            ok_u, p["user_bias"][uc].to(f64) + p["alpha"][uc].to(f64) * dev,
            zero)
        out = out + torch.where(
            in_days, p["user_bias_by_day"][uc, dc].to(f64), zero)
        scaling = torch.where(ok_u, p["user_scaling"][uc].to(f64),
                              torch.ones((), dtype=f64, device=u.device))
        scaling = scaling + torch.where(
            in_days, p["user_scaling_by_day"][uc, dc].to(f64), zero)
        item_term = torch.where(
            ok_i, p["item_bias"][ic].to(f64)
            + p["item_bias_by_time_bin"][ic, bins].to(f64), zero)
        out = out + item_term * scaling
        if self.WITH_FREQUENCIES:
            both = in_days & ok_i
            f = self._freq_by_day[uc, dc].long()
            out = out + torch.where(
                both, p["item_bias_at_frequency"][ic, f].to(f64), zero)
        return out.to(torch.float32).cpu().numpy()

    # --- persistence (the JAX package's text sections) ---

    def save_model(self, path):
        with ModelWriter(path, type(self).__name__, "2.99") as w:
            self._write_sections(w)

    def _write_sections(self, w):
        p = {k: v.cpu().numpy() for k, v in self.params.items()}
        w.scalar(self.global_average)
        w.int_scalar(self._earliest)
        w.int_scalar(self._latest_day)
        w.int_scalar(self._num_bins)
        w.vector(p["user_bias"])
        w.vector(p["item_bias"])
        w.vector(p["alpha"])
        w.vector(self._user_mean_day)
        w.matrix(p["item_bias_by_time_bin"])
        w.matrix(p["user_bias_by_day"])
        w.vector(p["user_scaling"])
        w.matrix(p["user_scaling_by_day"])

    def load_model(self, path):
        with ModelReader(path, type(self).__name__) as r:
            self._read_sections(r)

    def _read_sections(self, r):
        self.global_average = r.scalar()
        self._earliest = r.int_scalar()
        self._latest_day = r.int_scalar()
        self._num_bins = r.int_scalar()
        names = ("user_bias", "item_bias", "alpha")
        arrays = {k: r.vector() for k in names}
        self._user_mean_day = np.asarray(r.vector(), dtype=np.float32)
        arrays["item_bias_by_time_bin"] = r.matrix()
        arrays["user_bias_by_day"] = r.matrix()
        arrays["user_scaling"] = r.vector()
        arrays["user_scaling_by_day"] = r.matrix()
        self._num_days = arrays["user_bias_by_day"].shape[1]
        dev = resolve_device(self.device)
        self.params = {k: torch.from_numpy(np.asarray(v, np.float32)).to(dev)
                       for k, v in arrays.items()}
        self.num_users_trained = arrays["user_bias"].shape[0]
        self.num_items_trained = arrays["item_bias"].shape[0]
        self._epoch = None            # rebuilt on the next iterate()


class TimeAwareBaselineWithFrequencies(TimeAwareBaseline):
    HYPERPARAMS = dict(
        TimeAwareBaseline.HYPERPARAMS,
        frequency_log_base=float,
        item_bias_at_frequency_learn_rate=float,
        reg_item_bias_at_frequency=float,
    )

    WITH_FREQUENCIES = True

    def __init__(self):
        super().__init__()
        # defaults per reference TimeAwareBaselineWithFrequencies.cs:63-87
        self.num_iter = 40
        self.frequency_log_base = 6.76
        self.user_bias_learn_rate = 0.00267
        self.item_bias_learn_rate = 0.000488
        self.alpha_learn_rate = 0.00000311
        self.item_bias_by_time_bin_learn_rate = 0.000115
        self.user_bias_by_day_learn_rate = 0.000257
        self.user_scaling_learn_rate = 0.00564
        self.user_scaling_by_day_learn_rate = 0.00103
        self.item_bias_at_frequency_learn_rate = 0.00236
        self.reg_u = 0.0255
        self.reg_i = 0.0255
        self.reg_alpha = 3.95
        self.reg_item_bias_by_time_bin = 0.0929
        self.reg_user_bias_by_day = 0.00231
        self.reg_user_scaling = 0.0476
        self.reg_user_scaling_by_day = 0.019
        self.reg_item_bias_at_frequency = 0.000000011

    # persistence: the base sections, then item_bias_at_frequency and the
    # sparse per-(user, day) log-frequencies (reference
    # TimeAwareBaselineWithFrequencies.cs:42 SaveModel)

    def _write_sections(self, w):
        super()._write_sections(w)
        w.matrix(self.params["item_bias_at_frequency"].cpu().numpy())
        fb = self._freq_by_day.cpu().numpy()
        uu, dd = np.nonzero(fb)
        w.sparse(fb.shape[0], fb.shape[1], uu, dd,
                 fb[uu, dd].astype(np.float32))

    def _read_sections(self, r):
        super()._read_sections(r)
        biaf = r.matrix()
        rows, cols, uu, dd, vv = r.sparse()
        dev = self.params["user_bias"].device
        self.params["item_bias_at_frequency"] = torch.from_numpy(
            np.asarray(biaf, np.float32)).to(dev)
        self._num_freqs = biaf.shape[1]
        fb = np.zeros((rows, cols), dtype=np.int32)
        fb[uu, dd] = vv.astype(np.int32)
        self._freq_by_day = torch.from_numpy(fb).to(dev)
