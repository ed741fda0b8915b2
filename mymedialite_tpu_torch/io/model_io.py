"""Versioned plain-text model files.

Counterpart of reference ``IO/Model.cs:31-114``,
``IO/MatrixExtensions.cs:31-95``, ``IO/VectorExtensions.cs:30-80``.

File layout (same scheme as the reference):
  line 1: model class name
  line 2: format version
  then a sequence of named sections; vectors as ``n`` + one value per
  line, matrices as ``rows cols`` + ``i j value`` lines (only the
  reference's dense storage is reproduced; sparse sections store
  ``nnz`` + ``i j value``).

The save -> load -> identical-predictions invariant (reference
``tests/test_load_save.sh``) is guaranteed by writing float32 values
with repr-exact precision.

The port's own copy of ``mymedialite_tpu/io/model_io.py``:
the same text and the same values, and no import of the JAX package.
Vectors and matrices are formatted and parsed a section at a time
rather than a line at a time (a dense KNN correlation at 6,040 users is
36M lines).
"""

from __future__ import annotations

import itertools

import numpy as np

FORMAT_VERSION = "3.0"


def _float32_values(a) -> list:
    """The values of ``a`` rounded to float32, as Python floats (whose
    repr is ``_fmt``'s), in row-major order."""
    return np.asarray(a).astype(np.float32).astype(np.float64).ravel() \
        .tolist()


def _fmt(x: float) -> str:
    # shortest string that round-trips float32 exactly
    return np.format_float_repr if False else repr(float(np.float32(x)))


class ModelWriter:
    def __init__(self, path: str, model_name: str, version: str = FORMAT_VERSION):
        self._f = open(path, "w")
        self._f.write(f"{model_name}\n{version}\n")

    def scalar(self, value):
        self._f.write(f"{_fmt(value)}\n")

    def int_scalar(self, value):
        self._f.write(f"{int(value)}\n")

    def vector(self, v):
        v = np.asarray(v)
        self._f.write(f"{v.shape[0]}\n")
        self._f.write("".join(f"{x!r}\n" for x in _float32_values(v)))

    def int_vector(self, v):
        v = np.asarray(v)
        self._f.write(f"{v.shape[0]}\n")
        self._f.write("".join(f"{x}\n" for x in
                              v.astype(np.int64).ravel().tolist()))

    def matrix(self, m):
        m = np.asarray(m)
        rows, cols = m.shape
        self._f.write(f"{rows} {cols}\n")
        values = _float32_values(m)
        for i in range(rows):
            row = values[i * cols:(i + 1) * cols]
            self._f.write("".join(f"{i} {j} {x!r}\n"
                                  for j, x in enumerate(row)))

    def sparse(self, rows: int, cols: int, ii, jj, vv):
        self._f.write(f"{rows} {cols} {len(ii)}\n")
        for i, j, v in zip(ii, jj, vv):
            self._f.write(f"{int(i)} {int(j)} {_fmt(v)}\n")

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ModelReader:
    def __init__(self, path: str, expected_name: str = None):
        self._f = open(path, "r")
        self.model_name = self._f.readline().strip()
        self.version = self._f.readline().strip()
        if expected_name is not None and self.model_name != expected_name:
            raise ValueError(
                f"model file is for {self.model_name!r}, expected {expected_name!r}")

    def _line(self) -> str:
        line = self._f.readline()
        if not line:
            raise EOFError("unexpected end of model file")
        return line.strip()

    def scalar(self) -> float:
        return float(self._line())

    def int_scalar(self) -> int:
        return int(self._line())

    def _lines(self, n: int):
        lines = list(itertools.islice(self._f, n))
        if len(lines) < n:
            raise EOFError("unexpected end of model file")
        return lines

    def vector(self) -> np.ndarray:
        n = int(self._line())
        return np.array(self._lines(n), dtype=np.float64).astype(np.float32)

    def int_vector(self) -> np.ndarray:
        n = int(self._line())
        return np.array([int(x) for x in self._lines(n)], dtype=np.int32)

    def matrix(self) -> np.ndarray:
        rows, cols = map(int, self._line().split())
        m = np.zeros((rows, cols), dtype=np.float32)
        fields = np.array("".join(self._lines(rows * cols)).split(),
                          dtype=np.float64).reshape(-1, 3)
        m[fields[:, 0].astype(np.int64), fields[:, 1].astype(np.int64)] = \
            fields[:, 2]
        return m

    def sparse(self):
        rows, cols, nnz = map(int, self._line().split())
        ii = np.zeros(nnz, dtype=np.int32)
        jj = np.zeros(nnz, dtype=np.int32)
        vv = np.zeros(nnz, dtype=np.float32)
        for k in range(nnz):
            i, j, v = self._line().split()
            ii[k], jj[k], vv[k] = int(i), int(j), float(v)
        return rows, cols, ii, jj, vv

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def peek_model_name(path: str) -> str:
    """Read just the type-name header (reference Model.Load(filename),
    IO/Model.cs:67-83) so the right model class can be instantiated."""
    with open(path) as f:
        return f.readline().strip()
