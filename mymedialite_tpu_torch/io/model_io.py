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
the same behaviour, and no import of the JAX package.
"""

from __future__ import annotations

import numpy as np

FORMAT_VERSION = "3.0"


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
        for x in v:
            self._f.write(f"{_fmt(x)}\n")

    def int_vector(self, v):
        v = np.asarray(v)
        self._f.write(f"{v.shape[0]}\n")
        for x in v:
            self._f.write(f"{int(x)}\n")

    def matrix(self, m):
        m = np.asarray(m)
        rows, cols = m.shape
        self._f.write(f"{rows} {cols}\n")
        for i in range(rows):
            row = m[i]
            for j in range(cols):
                self._f.write(f"{i} {j} {_fmt(row[j])}\n")

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

    def vector(self) -> np.ndarray:
        n = int(self._line())
        return np.array([float(self._line()) for _ in range(n)], dtype=np.float32)

    def int_vector(self) -> np.ndarray:
        n = int(self._line())
        return np.array([int(self._line()) for _ in range(n)], dtype=np.int32)

    def matrix(self) -> np.ndarray:
        rows, cols = map(int, self._line().split())
        m = np.zeros((rows, cols), dtype=np.float32)
        for _ in range(rows * cols):
            i, j, v = self._line().split()
            m[int(i), int(j)] = float(v)
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
