"""The port's time-aware baselines (``mymedialite_tpu_torch/models/
time_aware.py``) against the JAX package's, on the CPU.

The JAX epoch takes its batches in a threefry order; the tests draw
those orders from the JAX model's keys and hand them to the port's
``iterate(order)``, so that both packages run the same epochs. Tables
and time-aware predictions agree within 1e-5; model files pass both
ways; the frequency table's pinned fault (it never moves from zero)
holds in both; and the JAX package's own cases (tests/test_time_aware.py)
run on the port.
"""

import re

import jax
import numpy as np
import pytest

from mymedialite_tpu.cli import rating_prediction as jax_cli
from mymedialite_tpu.data.splits import chronological_split_ratio as j_split
from mymedialite_tpu.data.synthetic import synthetic_ratings as j_synth
from mymedialite_tpu.models import time_aware as jta
from mymedialite_tpu_torch import convert
from mymedialite_tpu_torch.cli import rating_prediction as port_cli
from mymedialite_tpu_torch.data.splits import chronological_split_ratio
from mymedialite_tpu_torch.data.synthetic import synthetic_ratings
from mymedialite_tpu_torch.eval.rating import evaluate_ratings
from mymedialite_tpu_torch.models import time_aware as tta
from mymedialite_tpu_torch.models.registry import create_rating_predictor

NAMES = ["TimeAwareBaseline", "TimeAwareBaselineWithFrequencies"]
TOL = 1e-5
SHAPE = dict(num_users=150, num_items=120, num_ratings=5000, seed=21,
             with_times=True, time_drift=1.0)


@pytest.fixture(scope="module")
def timed():
    """(port train, port test, JAX train, JAX test): the same ratings,
    split chronologically 80/20."""
    return (chronological_split_ratio(synthetic_ratings(**SHAPE), 0.2)
            + j_split(j_synth(**SHAPE), 0.2))


def jax_orders(seed: int, nb: int, epochs: int):
    """The batch orders of a JAX model's first ``epochs`` iterate()
    calls."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(epochs):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.permutation(sub, nb)).tolist())
    return out


def pair(name, timed, epochs=2, batch_size=512):
    """A JAX model trained ``epochs`` epochs and the port's model trained
    on the same batch orders."""
    train, _, jtrain, _ = timed
    j = getattr(jta, name)()
    j.ratings, j.num_iter, j.batch_size = jtrain, epochs, batch_size
    j.train()
    t = create_rating_predictor(name, f"num_iter=0 batch_size={batch_size} "
                                "device=cpu")
    t.ratings = train
    t.train()
    nb = t._epoch["users"].shape[0] // t._B
    for order in jax_orders(t.random_seed, nb, epochs):
        t.iterate(order)
    return j, t


@pytest.mark.parametrize("name", NAMES)
def test_two_epochs_match_jax(name, timed):
    j, t = pair(name, timed)
    assert set(t.params) == set(j.params)
    for k, v in j.params.items():
        np.testing.assert_allclose(t.params[k].numpy(), np.asarray(v),
                                   rtol=0, atol=TOL, err_msg=k)
    assert t._earliest == j._earliest and t._num_bins == j._num_bins
    np.testing.assert_array_equal(t._user_mean_day, j._user_mean_day)


def test_epoch_arrays_match_jax(timed):
    """The data order, the days, bins, deviations and frequencies of the
    padded epoch equal the JAX package's."""
    j, t = pair("TimeAwareBaselineWithFrequencies", timed, epochs=0)
    for k in ("users", "items", "values", "weights", "days", "bins", "dev",
              "freqs"):
        np.testing.assert_array_equal(t._epoch[k].numpy(),
                                      np.asarray(j._epoch[k]), err_msg=k)
    np.testing.assert_array_equal(t._freq_by_day.numpy(), j._freq_by_day)


@pytest.mark.parametrize("name", NAMES)
def test_predict_with_time_matches_jax(name, timed):
    _, test, _, jtest = timed
    j, t = pair(name, timed)
    # past the last training day and before the first: the day terms drop
    times = test.times.copy()
    times[:5] = j._earliest - 3 * 86_400
    np.testing.assert_allclose(
        t.predict_batch_time(test.users, test.items, times),
        j.predict_batch_time(jtest.users, jtest.items, times),
        rtol=0, atol=TOL)
    users = np.array([0, 5, 10_000, -1])
    items = np.array([3, 100_000, 2, 1])
    np.testing.assert_allclose(t.predict_batch(users, items),
                               j.predict_batch(users, items), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(
        t.predict_batch_time(users, items, np.full(4, j._earliest)),
        j.predict_batch_time(users, items, np.full(4, j._earliest)),
        rtol=0, atol=TOL)


def test_frequency_bias_never_moves(timed):
    """The pinned fault: item_bias_at_frequency is updated by
    err * b - reg * b with b its own entry, so from zero it stays zero in
    both packages (ROADMAP §C)."""
    j, t = pair("TimeAwareBaselineWithFrequencies", timed)
    assert not t.params["item_bias_at_frequency"].any()
    assert not np.asarray(j.params["item_bias_at_frequency"]).any()
    assert t.params["item_bias_by_time_bin"].abs().max() > 0


def test_state_from_jax_continues_as_jax(timed):
    """A port model started from a JAX model's state
    (``convert.time_aware_state_from_jax``) takes the JAX model's next
    epoch."""
    train, _, jtrain, _ = timed
    j = jta.TimeAwareBaselineWithFrequencies()
    j.ratings, j.num_iter, j.batch_size = jtrain, 1, 512
    j.train()
    t = create_rating_predictor("TimeAwareBaselineWithFrequencies",
                                "batch_size=512 device=cpu")
    t.ratings = train
    t.load_state(convert.time_aware_state_from_jax(j))
    j.iterate()
    nb = -(-len(train) // 512)
    t.iterate(jax_orders(t.random_seed, nb, 2)[1])
    for k, v in j.params.items():
        np.testing.assert_allclose(t.params[k].numpy(), np.asarray(v),
                                   rtol=0, atol=TOL, err_msg=k)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_model_files_across_packages(name, direction, timed, tmp_path):
    _, test, jtrain, jtest = timed
    j, t = pair(name, timed)
    path = str(tmp_path / "ta.model")
    if direction == "port_to_jax":
        t.save_model(path)
        other = getattr(jta, name)()
        other.ratings = jtrain
        other.load_model(path)
        ref = t
    else:
        j.save_model(path)
        other = create_rating_predictor(name, "device=cpu")
        other.ratings = t.ratings
        other.load_model(path)
        ref = j
    np.testing.assert_allclose(
        other.predict_batch_time(test.users, test.items, test.times),
        ref.predict_batch_time(jtest.users, jtest.items, jtest.times),
        rtol=0, atol=1e-6)


def test_step_is_dtype_generic(timed):
    """One batch in float64 from the float32 tables stays within 1e-5 of
    the float32 step (the chip check's witness)."""
    import torch
    _, t = pair("TimeAwareBaseline", timed, epochs=1)
    p32 = {k: v.clone() for k, v in t.params.items()}
    p64 = {k: v.double() for k, v in t.params.items()}
    batch = tta.epoch_batch(t._epoch, 0, t._B)
    hp = t._hp()
    with torch.no_grad():
        tta.time_aware_step(p32, batch, hp, with_freq=False)
        tta.time_aware_step(p64, batch, hp, with_freq=False)
    for k in p32:
        np.testing.assert_allclose(p32[k].numpy(), p64[k].numpy(), rtol=0,
                                   atol=TOL, err_msg=k)


# the JAX package's cases (tests/test_time_aware.py), on the port

@pytest.fixture(scope="module")
def timed_data():
    data = synthetic_ratings(num_ratings=20000, num_users=300, num_items=400,
                             seed=21, with_times=True)
    return chronological_split_ratio(data, 0.2)


def _trained(name, train, num_iter):
    m = create_rating_predictor(name, f"num_iter={num_iter} batch_size=4096 "
                                "device=cpu")
    m.ratings = train
    m.train()
    return m


@pytest.mark.parametrize("name", NAMES)
class TestTimeAware:
    def test_trains_and_predicts(self, name, timed_data):
        train, test = timed_data
        m = _trained(name, train, 5)
        res = evaluate_ratings(m, test)
        assert np.isfinite(res["RMSE"])
        ga = create_rating_predictor("GlobalAverage", "device=cpu")
        ga.ratings = train
        ga.train()
        assert res["RMSE"] < evaluate_ratings(ga, test)["RMSE"] + 0.05

    def test_plain_predict(self, name, timed_data):
        m = _trained(name, timed_data[0], 2)
        assert np.isfinite(m.predict(0, 0))

    def test_save_load(self, name, timed_data, tmp_path):
        train, test = timed_data
        m = _trained(name, train, 2)
        before = m.predict_batch_time(test.users[:20], test.items[:20],
                                      test.times[:20])
        p = str(tmp_path / "ta.model")
        m.save_model(p)
        m2 = create_rating_predictor(name, "device=cpu")
        m2.ratings = train
        m2.load_model(p)
        after = m2.predict_batch_time(test.users[:20], test.items[:20],
                                      test.times[:20])
        np.testing.assert_allclose(before, after, atol=1e-5)

    def test_load_then_iterate(self, name, timed_data, tmp_path):
        train, test = timed_data
        m = _trained(name, train, 2)
        p = str(tmp_path / "ta.model")
        m.save_model(p)
        m2 = create_rating_predictor(name, "batch_size=4096 device=cpu")
        m2.ratings = train
        m2.load_model(p)
        m2.iterate()
        assert np.isfinite(evaluate_ratings(m2, test)["RMSE"])


def test_timed_data_survives_the_splits():
    """select (the --test-ratio split) and the chronological split keep
    the times aligned with their ratings."""
    from mymedialite_tpu_torch.data.splits import simple_split
    data = synthetic_ratings(num_users=40, num_items=30, num_ratings=600,
                             seed=4, with_times=True)
    key = {(u, i): t for u, i, t in zip(data.users, data.items, data.times)}
    parts = simple_split(data, 0.25, np.random.default_rng(0)) + \
        chronological_split_ratio(data, 0.25)
    for part in parts:
        assert part.times is not None
        assert all(key[(u, i)] == t for u, i, t in
                   zip(part.users, part.items, part.times))
    train, test = parts[2:]
    assert train.times.max() <= test.times.min()


@pytest.mark.parametrize("name", NAMES)
def test_cli_reads_the_times_and_prints_the_jax_line(name, tmp_path, capsys,
                                                     monkeypatch):
    """The rating CLI reads the timestamp column for a time-aware model
    and evaluates with the times; at the default batch of 65,536 every
    epoch of this file is one batch, so that both packages take the same
    steps and print the same line; the port's model file then loads in
    the port's CLI and prints it again."""
    monkeypatch.setenv("MMLT_COMPILE_CACHE", "0")
    data = synthetic_ratings(num_users=80, num_items=60, num_ratings=2000,
                             seed=31, with_times=True, time_drift=1.0)
    train, test = chronological_split_ratio(data, 0.2)
    paths = {}
    for part_name, part in (("train", train), ("test", test)):
        paths[part_name] = str(tmp_path / f"{part_name}.tsv")
        with open(paths[part_name], "w") as f:
            for u, i, v, t in zip(part.users, part.items, part.values,
                                  part.times):
                f.write(f"{u + 10}\t{i + 3}\t{v:g}\t{t}\n")
    argv = ["--training-file", paths["train"], "--test-file", paths["test"],
            "--recommender", name]
    times = re.compile(r"(training_time|testing_time|loading_time) "
                       r"[0-9.]+ ?")

    def run(main, extra):
        capsys.readouterr()
        assert main(argv + extra) == 0
        return times.sub("", capsys.readouterr().out)
    model = str(tmp_path / "ta.model")
    jax_out = run(jax_cli.main, ["--recommender-options", "num_iter=3"])
    port_out = run(port_cli.main, ["--recommender-options",
                                   "num_iter=3 device=cpu",
                                   "--save-model", model])
    num = re.compile(r"-?\d+\.\d+")
    assert num.sub("#", port_out) == num.sub("#", jax_out)
    np.testing.assert_allclose(
        [float(x) for x in num.findall(port_out)],
        [float(x) for x in num.findall(jax_out)], rtol=0, atol=1e-5)
    loaded = run(port_cli.main, ["--recommender-options", "device=cpu",
                                 "--load-model", model])
    assert loaded.splitlines()[-1].split("RMSE")[1] == \
        port_out.splitlines()[-1].split("RMSE")[1]
