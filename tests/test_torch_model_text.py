"""The model files' text sections of the port (``io/model_io.py`` over
``native/model_text.cpp``) against the JAX package's ``io/model_io.py``.

A file written by the port equals the JAX package's byte for byte, for
vector, dense matrix and sparse sections, on values whose layout Python's
``repr`` decides (1e-05 and 0.0001 on each side of the exponent rule,
-0.0, 1e+16 against 1e+15, the largest float32, subnormals, inf and nan)
and on random bit patterns, natively and in the Python fallback; read
back by either package it gives the same float32 values. Truncated files
and lines that do not parse raise; a last line without a newline reads.
"""

import numpy as np
import pytest

from mymedialite_tpu.io import model_io as jio
from mymedialite_tpu_torch import native
from mymedialite_tpu_torch.io import model_io as tio

SPECIAL = np.array([1e-05, 0.0001, -0.0, 0.0, 1e16, 1e15, 3.4028235e38,
                    -3.4028235e38, 1e-45, 7e-40, 1.1754944e-38, np.inf,
                    -np.inf, np.nan, 0.1, 123.456, -2.5, 1.0, 12345678.0,
                    99999.99, 1e-4 * 0.999, 1e16 * 0.999], np.float32)


def random_values(n, seed=0):
    bits = np.random.default_rng(seed).integers(0, 2 ** 32, n,
                                                dtype=np.uint64)
    return bits.astype(np.uint32).view(np.float32)


def write(module, path, vec, mat, sparse):
    with module.ModelWriter(str(path), "Some", "2.99") as w:
        w.scalar(0.30000001192092896)
        w.vector(vec)
        w.int_vector(np.arange(5))
        w.matrix(mat)
        w.sparse(7, 9, *sparse)


@pytest.fixture(params=["native", "python"])
def backend(request, monkeypatch):
    if request.param == "native":
        assert native.get_text_lib() is not None
    else:
        monkeypatch.setattr(native, "get_text_lib", lambda: None)
    return request.param


def sections():
    vec = np.concatenate([SPECIAL, random_values(3000)])
    mat = np.concatenate([SPECIAL, random_values(60 * 37 - SPECIAL.size,
                                                 1)]).reshape(60, 37)
    ii = np.array([0, 3, 6, 6], np.int32)
    jj = np.array([8, 0, 1, 2], np.int32)
    vv = SPECIAL[[0, 1, 6, 8]]
    return vec, mat, (ii, jj, vv)


def test_writer_equals_jax_byte_for_byte(tmp_path, backend):
    vec, mat, sparse = sections()
    write(jio, tmp_path / "jax.model", vec, mat, sparse)
    write(tio, tmp_path / "port.model", vec, mat, sparse)
    assert (tmp_path / "port.model").read_bytes() == \
        (tmp_path / "jax.model").read_bytes()


def same_float32(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint32)[~np.isnan(a)],
                                  b.view(np.uint32)[~np.isnan(b)])
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_reader_gives_the_jax_values(tmp_path, backend, writer):
    vec, mat, sparse = sections()
    path = tmp_path / "m.model"
    write(jio if writer == "jax" else tio, path, vec, mat, sparse)
    got, want = [], []
    for module, out in ((tio, got), (jio, want)):
        with module.ModelReader(str(path), "Some") as r:
            out += [r.scalar(), r.vector(), r.int_vector(), r.matrix(),
                    r.sparse()]
    assert got[0] == want[0]
    same_float32(got[1], want[1])
    same_float32(got[1], vec)
    np.testing.assert_array_equal(got[2], want[2])
    same_float32(got[3], want[3])
    same_float32(got[3], mat)
    assert got[4][:2] == want[4][:2]
    for a, b in zip(got[4][2:], want[4][2:]):
        assert a.dtype == b.dtype
        same_float32(a, b) if a.dtype == np.float32 else \
            np.testing.assert_array_equal(a, b)


def test_truncated_and_bad_files_raise(tmp_path, backend):
    vec, mat, sparse = sections()
    path = tmp_path / "m.model"
    write(tio, path, vec, mat, sparse)
    text = path.read_bytes()
    cut = tmp_path / "cut.model"
    cut.write_bytes(text[:text.index(b"\n0 0 ") + 40])
    with tio.ModelReader(str(cut)) as r:
        r.scalar(), r.vector(), r.int_vector()
        with pytest.raises((EOFError, ValueError)):
            r.matrix()
    bad = tmp_path / "bad.model"
    bad.write_bytes(b"Some\n2.99\n2\n1.5\nx\n")
    with tio.ModelReader(str(bad)) as r:
        with pytest.raises((EOFError, ValueError)):
            r.vector()
    # the last line may lack its newline
    last = tmp_path / "last.model"
    last.write_bytes(b"Some\n2.99\n1 2\n0 0 1.5\n0 1 -2")
    with tio.ModelReader(str(last)) as r:
        np.testing.assert_array_equal(r.matrix(), [[1.5, -2.0]])


def test_dense_knn_sized_matrix_round_trip(tmp_path):
    """A 1,000 x 1,000 correlation (the UserKNN CLI's file, scaled down)
    writes as the JAX package's text and reads back bit for bit."""
    m = np.random.default_rng(3).uniform(-1, 1, (1000, 1000)).astype(
        np.float32)
    np.fill_diagonal(m, 0.0)
    path = tmp_path / "k.model"
    with tio.ModelWriter(str(path), "UserKNN") as w:
        w.matrix(m)
    text = path.read_bytes().split(b"\n")
    assert text[2] == b"1000 1000" and len(text) == 1000 * 1000 + 4
    assert text[3 + 1234] == f"1 234 {float(m[1, 234])!r}".encode()
    with tio.ModelReader(str(path), "UserKNN") as r:
        same_float32(r.matrix(), m)
