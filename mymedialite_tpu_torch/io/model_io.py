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
Vectors, matrices and sparse sections are formatted and parsed a
section at a time, natively where the library builds
(``native/model_text.cpp``: the shortest round-trip digits laid out as
Python's ``repr``, on threads), else in Python; a dense KNN correlation
at 6,040 users is 36M lines. The reader takes the whole file in one read.
"""

from __future__ import annotations

import numpy as np

from mymedialite_tpu_torch import native

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

    def _native(self, values, cols: int = 0, ii=None, jj=None) -> bool:
        """Write the section's lines natively; False without the
        library."""
        def write(text):
            self._f.flush()
            self._f.buffer.write(text)
        return native.format_values(write, values, cols, ii, jj)

    def scalar(self, value):
        self._f.write(f"{_fmt(value)}\n")

    def int_scalar(self, value):
        self._f.write(f"{int(value)}\n")

    def vector(self, v):
        v = np.asarray(v)
        self._f.write(f"{v.shape[0]}\n")
        if not self._native(v):
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
        if cols and self._native(m, cols):
            return
        values = _float32_values(m)
        for i in range(rows):
            row = values[i * cols:(i + 1) * cols]
            self._f.write("".join(f"{i} {j} {x!r}\n"
                                  for j, x in enumerate(row)))

    def sparse(self, rows: int, cols: int, ii, jj, vv):
        self._f.write(f"{rows} {cols} {len(ii)}\n")
        if len(ii) and self._native(vv, 0, ii, jj):
            return
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
        with open(path, "rb") as f:
            self._buf = f.read()
        self._pos = 0
        self.model_name = self._readline().strip()
        self.version = self._readline().strip()
        if expected_name is not None and self.model_name != expected_name:
            raise ValueError(
                f"model file is for {self.model_name!r}, expected {expected_name!r}")

    def _readline(self) -> str:
        """The next line ('' at the end of the file), newline included."""
        buf, pos = self._buf, self._pos
        end = buf.find(b"\n", pos)
        end = len(buf) if end < 0 else end + 1
        self._pos = end
        return buf[pos:end].decode()

    def _line(self) -> str:
        line = self._readline()
        if not line:
            raise EOFError("unexpected end of model file")
        return line.strip()

    def scalar(self) -> float:
        return float(self._line())

    def int_scalar(self) -> int:
        return int(self._line())

    def _lines(self, n: int) -> bytes:
        """The next n lines as one bytes object."""
        if n == 0:
            return b""
        buf, pos = self._buf, self._pos
        newlines = np.flatnonzero(np.frombuffer(buf, np.uint8, offset=pos)
                                  == 10)
        if newlines.size < n:
            if newlines.size == n - 1 and pos + (
                    newlines[-1] + 1 if newlines.size else 0) < len(buf):
                self._pos = len(buf)        # the last line, no newline
                return buf[pos:]
            raise EOFError("unexpected end of model file")
        self._pos = pos + int(newlines[n - 1]) + 1
        return buf[pos:self._pos]

    def _parsed(self, n: int, fields: int):
        """(ii, jj, values) of the next n lines, natively where the
        library builds; None otherwise (the lines stay unread)."""
        if n == 0:
            return None
        out = native.parse_values(self._buf, self._pos, n, fields)
        if out is None:
            return None
        parsed, self._pos = out
        return parsed

    def vector(self) -> np.ndarray:
        n = int(self._line())
        parsed = self._parsed(n, 1)
        if parsed is not None:
            return parsed[2].astype(np.float32)
        return np.array(self._lines(n).split(), dtype=np.float64) \
            .astype(np.float32)

    def int_vector(self) -> np.ndarray:
        n = int(self._line())
        return np.array([int(x) for x in self._lines(n).split()],
                        dtype=np.int32)

    def matrix(self) -> np.ndarray:
        rows, cols = map(int, self._line().split())
        m = np.zeros((rows, cols), dtype=np.float32)
        parsed = self._parsed(rows * cols, 3)
        if parsed is not None:
            ii, jj, vv = parsed
        else:
            fields = np.array(self._lines(rows * cols).split(),
                              dtype=np.float64).reshape(-1, 3)
            ii, jj, vv = (fields[:, 0].astype(np.int64),
                          fields[:, 1].astype(np.int64), fields[:, 2])
        m[ii, jj] = vv
        return m

    def sparse(self):
        rows, cols, nnz = map(int, self._line().split())
        parsed = self._parsed(nnz, 3)
        if parsed is not None:
            ii, jj, vv = parsed
            return (rows, cols, ii.astype(np.int32), jj.astype(np.int32),
                    vv.astype(np.float32))
        ii = np.zeros(nnz, dtype=np.int32)
        jj = np.zeros(nnz, dtype=np.int32)
        vv = np.zeros(nnz, dtype=np.float32)
        for k in range(nnz):
            i, j, v = self._line().split()
            ii[k], jj[k], vv[k] = int(i), int(j), float(v)
        return rows, cols, ii, jj, vv

    def close(self):
        self._buf = b""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def peek_model_name(path: str) -> str:
    """Read just the type-name header (reference Model.Load(filename),
    IO/Model.cs:67-83) so the right model class can be instantiated."""
    with open(path) as f:
        return f.readline().strip()
