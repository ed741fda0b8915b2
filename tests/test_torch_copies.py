"""The port's own copies of the JAX package's jax-free helpers against
the originals, on the CPU: the same files parse to equal arrays and
mappings, splits and statistics are equal, the result formatting and
ranking measures agree, model files pass between the two packages'
writers and readers, the native library gives the same counts and the
same chunk plan, and the registry lists the same names."""

import os

import numpy as np
import pytest

from mymedialite_tpu import native as jnative
from mymedialite_tpu.cli import common as jcommon
from mymedialite_tpu.data import io as jio
from mymedialite_tpu.data import mapping as jmapping
from mymedialite_tpu.data import scale as jscale
from mymedialite_tpu.data import splits as jsplits
from mymedialite_tpu.data import statistics as jstats
from mymedialite_tpu.data.synthetic import synthetic_ratings
from mymedialite_tpu.eval import measures as jmeasures
from mymedialite_tpu.eval import ranking as jranking
from mymedialite_tpu.eval import results as jresults
from mymedialite_tpu.io import model_io as jmodel_io
from mymedialite_tpu.models import registry as jregistry
from mymedialite_tpu.ops import pallas_sgd as ps
from mymedialite_tpu.parallel import mesh as jmesh
from mymedialite_tpu.utils import params as jparams
from mymedialite_tpu_torch import native as tnative
from mymedialite_tpu_torch.cli import common as tcommon
from mymedialite_tpu_torch.data import io as tio
from mymedialite_tpu_torch.data import mapping as tmapping
from mymedialite_tpu_torch.data import scale as tscale
from mymedialite_tpu_torch.data import splits as tsplits
from mymedialite_tpu_torch.data import statistics as tstats
from mymedialite_tpu_torch.eval import measures as tmeasures
from mymedialite_tpu_torch.eval import ranking as tranking
from mymedialite_tpu_torch.eval import results as tresults
from mymedialite_tpu_torch.io import model_io as tmodel_io
from mymedialite_tpu_torch.models import registry as tregistry
from mymedialite_tpu_torch.ops import plan as tplan
from mymedialite_tpu_torch.parallel import mesh as tmesh
from mymedialite_tpu_torch.utils import params as tparams


def _same_data(a, b, fields=("users", "items", "values", "times")):
    assert type(a).__name__ == type(b).__name__
    assert (a.num_users, a.num_items, len(a)) == \
        (b.num_users, b.num_items, len(b))
    for name in fields:
        x, y = getattr(a, name, None), getattr(b, name, None)
        if x is None or y is None:
            assert x is None and y is None, name
        else:
            np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The same ratings as numeric ids, string ids and timed lines."""
    d = tmp_path_factory.mktemp("copies")
    data = synthetic_ratings(num_users=60, num_items=80, num_ratings=1500,
                             seed=8)
    times = 1_300_000_000 + 3600 * np.arange(len(data))
    paths = {k: str(d / f"{k}.tsv") for k in
             ("numeric", "named", "timed", "events")}
    with open(paths["numeric"], "w") as f:
        for u, i, v in zip(data.users, data.items, data.values):
            f.write(f"{u + 3}\t{i + 11}\t{v:g}\n")
    with open(paths["named"], "w") as f:
        for u, i, v in zip(data.users, data.items, data.values):
            f.write(f"user{u * 7 % 61},item{i * 5 % 83} {v:g}\n")
    with open(paths["timed"], "w") as f:
        for u, i, v, t in zip(data.users, data.items, data.values, times):
            f.write(f"u{u}\ti{i}\t{v:g}\t{t}\n")
    with open(paths["events"], "w") as f:
        for u, i in zip(data.users, data.items):
            f.write(f"{u}\tx{i}\n")
    return paths


@pytest.mark.parametrize("kind", ["numeric", "named"])
def test_rating_files_parse_equal(files, kind):
    """Identity ids (the native parser) and string ids (mappings)."""
    if kind == "numeric":
        a = tio.read_rating_data(files[kind], use_cache=False)
        b = jio.read_rating_data(files[kind], use_cache=False)
        assert tnative.get_lib() is not None
    else:
        tm = (tmapping.Mapping(), tmapping.Mapping())
        jm = (jmapping.Mapping(), jmapping.Mapping())
        a = tio.read_rating_data(files[kind], *tm)
        b = jio.read_rating_data(files[kind], *jm)
        for x, y in zip(tm, jm):
            assert x.original_ids == y.original_ids
    _same_data(a, b)


def test_item_and_timed_files_parse_equal(files, tmp_path):
    tm = (tmapping.Mapping(), tmapping.Mapping())
    jm = (jmapping.Mapping(), jmapping.Mapping())
    _same_data(tio.read_item_data(files["events"], *tm),
               jio.read_item_data(files["events"], *jm))
    _same_data(tio.read_timed_rating_data(files["timed"], *tm),
               jio.read_timed_rating_data(files["timed"], *jm))
    _same_data(tio.read_item_data_rating_threshold(files["numeric"], 3.5),
               jio.read_item_data_rating_threshold(files["numeric"], 3.5))
    for x, y in zip(tm, jm):
        assert x.original_ids == y.original_ids
        x.save(str(tmp_path / "t.map"))
        assert jmapping.Mapping.load(str(tmp_path / "t.map")).original_ids \
            == y.original_ids


def test_splits_and_statistics_equal(files):
    a = tio.read_timed_rating_data(files["timed"], tmapping.Mapping(),
                                   tmapping.Mapping())
    b = jio.read_timed_rating_data(files["timed"], jmapping.Mapping(),
                                   jmapping.Mapping())
    pairs = [
        (tsplits.simple_split(a, 0.25, np.random.default_rng(3)),
         jsplits.simple_split(b, 0.25, np.random.default_rng(3))),
        (tsplits.chronological_split_ratio(a, 0.3),
         jsplits.chronological_split_ratio(b, 0.3)),
        (tsplits.chronological_split_time(a, int(np.median(a.times))),
         jsplits.chronological_split_time(b, int(np.median(b.times)))),
        (tsplits.per_user_chronological_split(a, num_test_per_user=2),
         jsplits.per_user_chronological_split(b, num_test_per_user=2)),
    ]
    pairs += list(zip(tsplits.crossvalidation_split(a, 3),
                      jsplits.crossvalidation_split(b, 3)))
    for (ta, te), (ja, je) in pairs:
        _same_data(ta, ja)
        _same_data(te, je)
        assert tstats.ratings_statistics(ta, te) == \
            jstats.ratings_statistics(ja, je)
    ev_t = tio.read_item_data(files["events"], tmapping.Mapping(),
                              tmapping.Mapping())
    ev_j = jio.read_item_data(files["events"], jmapping.Mapping(),
                              jmapping.Mapping())
    (ta, te), (ja, je) = (
        tsplits.posonly_simple_split(ev_t, 0.2, np.random.default_rng(4)),
        jsplits.posonly_simple_split(ev_j, 0.2, np.random.default_rng(4)))
    _same_data(ta, ja, ("users", "items"))
    _same_data(te, je, ("users", "items"))
    assert tstats.posonly_statistics(ta, te) == jstats.posonly_statistics(ja, je)
    assert tscale.RatingScale.from_values(a.values).levels == \
        jscale.RatingScale.from_values(b.values).levels


def test_results_and_measures_equal():
    vals = dict(RMSE=0.912345678, MAE=0.7, CBD=0.3123)
    assert str(tresults.RatingPredictionResults(vals)) == \
        str(jresults.RatingPredictionResults(vals))
    ivals = dict(AUC=0.8, MAP=0.1, NDCG=0.3, MRR=0.2, num_users=10,
                 num_items=20, num_lists=10)
    ivals.update({f"{m}@{n}": 0.05 * n for m in ("prec", "recall")
                  for n in (5, 10)})
    assert str(tresults.ItemRecommendationResults(ivals)) == \
        str(jresults.ItemRecommendationResults(ivals))
    for n in (0, 1, 7, 300):
        assert tmeasures.idcg(n) == jmeasures.idcg(n)
    ranked, correct = [4, 2, 9, 7, 1, 3], [2, 3, 7]
    for name in ("auc_list", "average_precision_list", "ndcg_list",
                 "reciprocal_rank_list"):
        assert getattr(tmeasures, name)(ranked, correct) == \
            getattr(jmeasures, name)(ranked, correct), name
    assert tmeasures.precision_at_list(ranked, correct, 5) == \
        jmeasures.precision_at_list(ranked, correct, 5)


def test_measures_batch_and_candidates_equal(files):
    rng = np.random.default_rng(5)
    B, P2 = 40, 9
    ranks = rng.integers(0, 60, (B, P2)).astype(np.int64)
    m_arr = rng.integers(0, P2 + 1, B)
    n_cand = np.full(B, 60) + rng.integers(0, 3, B)
    for n in (-1, 10):
        sums_t = dict.fromkeys(("AUC", "MAP", "NDCG", "MRR", "prec@5",
                                "prec@10", "recall@5", "recall@10"), 0.0)
        sums_j = dict(sums_t)
        assert tranking._measures_batch(ranks, m_arr, n_cand, n, sums_t) == \
            jranking._measures_batch(ranks, m_arr, n_cand, n, sums_j)
        assert sums_t == sums_j
    ev = tio.read_item_data(files["events"], tmapping.Mapping(),
                            tmapping.Mapping())
    train, test = tsplits.posonly_simple_split(ev, 0.3,
                                               np.random.default_rng(1))
    for mode in ("TRAINING", "TEST", "OVERLAP", "UNION", "EXPLICIT"):
        explicit = [5, 1, 5, 30] if mode == "EXPLICIT" else None
        np.testing.assert_array_equal(
            tranking.candidates_for_mode(mode, test, train, explicit),
            jranking.candidates_for_mode(mode, test, train, explicit))


@pytest.mark.parametrize("writer_pkg", ["port", "jax"])
def test_model_files_pass_between_packages(tmp_path, writer_pkg):
    writer, reader = ((tmodel_io, jmodel_io) if writer_pkg == "port"
                      else (jmodel_io, tmodel_io))
    rng = np.random.default_rng(2)
    mat, vec = rng.standard_normal((5, 3)), rng.standard_normal(4)
    path = str(tmp_path / "m.model")
    with writer.ModelWriter(path, "SomeModel") as w:
        w.scalar(0.25)
        w.int_vector([3, 1, 2])
        w.vector(vec)
        w.matrix(mat)
    with reader.ModelReader(path, "SomeModel") as r:
        assert r.scalar() == 0.25
        np.testing.assert_array_equal(r.int_vector(), [3, 1, 2])
        got_vec, got_mat = r.vector(), r.matrix()
    with writer.ModelReader(path, "SomeModel") as r:
        r.scalar(), r.int_vector()
        np.testing.assert_array_equal(got_vec, r.vector())
        np.testing.assert_array_equal(got_mat, r.matrix())
    assert reader.peek_model_name(path) == "SomeModel"


def test_native_library_and_plan_equal():
    assert tnative.get_lib() is not None
    assert os.path.basename(tnative._lib_path()).startswith("libfastparser-")
    data = synthetic_ratings(num_users=300, num_items=500, num_ratings=8000,
                             seed=6)
    np.testing.assert_array_equal(tnative.count_items(data.items, 500),
                                  jnative.count_items(data.items, 500))
    kw = dict(user_block=64, item_block=64, chunk=None, shuffle_seed=2)
    a = tplan.prepare_mxu_data(data.users, data.items, data.values, 300, 500,
                               **kw)
    b = ps.prepare_mxu_data(data.users, data.items, data.values, 300, 500,
                            **kw)
    np.testing.assert_array_equal(a.packed.numpy(), np.asarray(b.packed))


def test_registry_params_and_cli_helpers_equal():
    assert tregistry.RATING_PREDICTORS == set(jregistry.RATING_PREDICTORS)
    assert tregistry.ITEM_RECOMMENDERS == set(jregistry.ITEM_RECOMMENDERS)
    assert tparams.parse_options("a=1 b_c=x") == \
        jparams.parse_options("a=1 b_c=x")
    for s in (0.0, 0.5, 61.25, 3725.0):
        assert tcommon.fmt_seconds(s) == jcommon.fmt_seconds(s)
    import argparse
    pt, pj = argparse.ArgumentParser(), argparse.ArgumentParser()
    tcommon.add_common_options(pt)
    jcommon.add_common_options(pj)
    assert sorted(a.dest for a in pt._actions) == \
        sorted(a.dest for a in pj._actions)


@pytest.mark.parametrize("track", ["train", "test"])
def test_kddcup_rating_files_parse_equal(tmp_path, track):
    """Track 1's blocked format (``user|count`` then ``item<TAB>rating``
    lines; the test format without ratings) read by both packages."""
    from mymedialite_tpu.data import kddcup2011 as jk
    from mymedialite_tpu_torch.data import kddcup2011 as tk
    rng = np.random.default_rng(3)
    path = tmp_path / "kdd.txt"
    with open(path, "w") as f:
        for u in (0, 5, 17, 2):
            n = int(rng.integers(1, 6))
            f.write(f"{u}|{n}\n")
            for i in rng.choice(50, n, replace=False):
                f.write(f"{i}\t{rng.integers(0, 101)}\t0\t00:00:00\n"
                        if track == "train" else f"{i}\t0\t00:00:00\n")
        f.write("\n")
    read_t, read_j = ((tk.read_kddcup_ratings, jk.read_kddcup_ratings)
                      if track == "train" else
                      (tk.read_kddcup_test_ratings,
                       jk.read_kddcup_test_ratings))
    _same_data(read_t(str(path)), read_j(str(path)))


def test_kddcup_taxonomy_reads_equal(tmp_path):
    """Track 2's taxonomy files (tracks, albums, artists, genres)."""
    from mymedialite_tpu.data import kddcup2011 as jk
    from mymedialite_tpu_torch.data import kddcup2011 as tk
    files = {"tracks": ["1|10|20|30|31", "2|None|21", "3||22|32"],
             "albums": ["10|20|30", "11|None"], "artists": ["20", "21", "22"],
             "genres": ["30", "31", "32"]}
    paths = []
    for name, lines in files.items():
        (tmp_path / name).write_text("\n".join(lines) + "\n")
        paths.append(str(tmp_path / name))
    a, b = tk.read_kddcup_items(*paths), jk.read_kddcup_items(*paths)
    for item in (1, 2, 3, 10, 11, 20, 30, 99):
        assert a.get_type(item).name == b.get_type(item).name
        assert (a.get_album(item), a.get_artist(item), a.get_genres(item)) \
            == (b.get_album(item), b.get_artist(item), b.get_genres(item))
        assert (a.has_album(item), a.has_artist(item), a.has_genres(item)) \
            == (b.has_album(item), b.has_artist(item), b.has_genres(item))


@pytest.mark.parametrize("max_len", [None, 3, 1])
def test_padded_history_equals_the_loop(max_len):
    """``padded_history``'s one scatter against the JAX package's loop
    over the keys (empty keys, duplicates, truncation at max_len)."""
    from mymedialite_tpu.data.arrays import PosOnlyData as JPosOnly
    from mymedialite_tpu.data.arrays import padded_history as j_padded
    from mymedialite_tpu_torch.data.arrays import PosOnlyData, padded_history
    rng = np.random.default_rng(6)
    u, i = rng.integers(0, 50, 700), rng.integers(0, 40, 700)
    a = padded_history(PosOnlyData(u, i, num_users=57).by_user, max_len)
    b = j_padded(JPosOnly(u, i, num_users=57).by_user, max_len)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("n,multiple", [(5, 4), (8, 4), (1, 8), (3, 1)])
def test_pad_rows_to_multiple_equal(n, multiple):
    a = np.arange(n * 3, dtype=np.float32).reshape(n, 3) + 1
    out_t = tmesh.pad_rows_to_multiple(a, multiple)
    out_j = jmesh.pad_rows_to_multiple(a, multiple)
    assert out_t.dtype == out_j.dtype
    np.testing.assert_array_equal(out_t, out_j)
