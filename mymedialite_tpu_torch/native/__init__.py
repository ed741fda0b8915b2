"""Native (C++) host helpers, loaded via ctypes: the numeric rating-file
parser, the threaded item count, the chunk plan's counting sort and the
CSR views' (``csr_order``); and, from ``model_text.cpp`` (a library of
its own), the model files' text sections formatted and parsed
(``format_values``, ``parse_values``).

The port's own copy of ``mymedialite_tpu/native`` (``fast_parser.cpp``
verbatim but for ``mml_csr_order``, the same loader functions). The
library is compiled with the host C++ compiler at first use into
``mymedialite_tpu_torch/build/`` (not committed), under a file name
that carries a hash of the source and the flags, so an edited source is
never served by a stale binary.
Everything degrades to the pure-Python paths when no compiler is
available.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from mymedialite_tpu_torch.ops._build import BUILD_DIR

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "fast_parser.cpp")
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17", "-pthread"]

_lock = threading.Lock()
_lib = None
_tried = False


_TEXT_SRC = os.path.join(_HERE, "model_text.cpp")
_text_lib = None
_text_tried = False


def _lib_path(src: str = _SRC, name: str = "libfastparser") -> str:
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(src, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _build(path: str, src: str = _SRC) -> bool:
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run(["g++", *_FLAGS, src, "-o", tmp],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def get_lib():
    """The loaded shared library, or None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _lib_path()
        if not os.path.exists(path) and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.mml_parse.restype = ctypes.c_int64
        lib.mml_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ]
        lib.mml_free.restype = None
        lib.mml_free.argtypes = [ctypes.c_void_p]
        lib.mml_count_items.restype = None
        lib.mml_count_items.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
        lib.mml_bucket_count.restype = None
        lib.mml_bucket_count.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int64,
            ctypes.c_void_p]
        lib.mml_bucket_fill_packed.restype = None
        lib.mml_bucket_fill_packed.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p]
        lib.mml_csr_order.restype = None
        lib.mml_csr_order.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        _lib = lib
        return _lib


def _c(arr):
    return arr.ctypes.data_as(ctypes.c_void_p)


def count_items(items, size: int):
    """Threaded native bincount of an int32 id array, or None."""
    lib = get_lib()
    if lib is None:
        return None
    items = np.ascontiguousarray(items, dtype=np.int32)
    out = np.zeros(size, np.int64)
    lib.mml_count_items(_c(items), len(items), size, _c(out))
    return out


def mxu_bucketize(users, items, values, perm, new_of_old,
                  UB: int, IB: int, n_ib: int, nbkt: int, chunk_fn):
    """Native counting sort for the middle of ``ops/plan.py
    prepare_mxu_data`` (shuffle-gather, bucket sort, padded scatter).
    ``chunk_fn(bcount) -> chunk`` picks the chunk size from the bucket
    histogram. Returns (packed [nc, 4, chunk] int32, bcount, pcount,
    chunk) or None when the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    users = np.ascontiguousarray(users, dtype=np.int32)
    items = np.ascontiguousarray(items, dtype=np.int32)
    values = np.ascontiguousarray(values, dtype=np.float32)
    new_of_old = np.ascontiguousarray(new_of_old, dtype=np.int32)
    if perm is not None:
        perm = np.ascontiguousarray(perm, dtype=np.int64)
    n = len(users)
    bcount = np.zeros(nbkt, np.int64)
    lib.mml_bucket_count(_c(users), _c(items),
                         _c(perm) if perm is not None else None, n,
                         _c(new_of_old), UB, IB, n_ib, nbkt, _c(bcount))
    chunk = int(chunk_fn(bcount))
    pcount = ((bcount + chunk - 1) // chunk) * chunk
    poff = np.concatenate([[0], np.cumsum(pcount)])
    total = int(poff[-1])
    nc = max(total // chunk, 1)
    packed = np.zeros((nc, 4, chunk), np.int32)
    cursor = np.ascontiguousarray(poff[:-1], dtype=np.int64)
    lib.mml_bucket_fill_packed(
        _c(users), _c(items), _c(values),
        _c(perm) if perm is not None else None, n, _c(new_of_old),
        UB, IB, n_ib, _c(cursor), chunk, _c(packed))
    return packed, bcount, pcount, chunk


def csr_order(primary, secondary, num_keys: int):
    """(indptr int64 [num_keys + 1], order int32 [n]): the CSR view of
    ``data/arrays.py build_csr`` by the native two-pass counting sort,
    ``order`` equal to ``np.lexsort((secondary, primary))``. None where
    the library is unavailable or a key lies outside what it sorts
    (negative, past int32, a primary key at or past ``num_keys``)."""
    lib = get_lib()
    n = len(primary)
    if lib is None or n != len(secondary) or n >= 2**31 or not (
            np.issubdtype(primary.dtype, np.integer)
            and np.issubdtype(secondary.dtype, np.integer)):
        return None
    if n and (min(primary.min(), secondary.min()) < 0
              or primary.max() >= num_keys or secondary.max() >= 2**31 - 1):
        return None
    primary = np.ascontiguousarray(primary, dtype=np.int32)
    secondary = np.ascontiguousarray(secondary, dtype=np.int32)
    num_secondary = int(secondary.max()) + 1 if n else 0
    indptr = np.zeros(num_keys + 1, np.int64)
    order = np.empty(n, np.int32)
    tmp = np.empty(n, np.int32)
    lib.mml_csr_order(_c(primary), _c(secondary), n, num_keys,
                      num_secondary, _c(tmp), _c(indptr), _c(order))
    return indptr, order


def parse_numeric_file(path: str, min_columns: int,
                       skip_first_line: bool = False):
    """Parse a numeric interaction file natively. Returns
    (users, items, values, times) numpy arrays (values/times None when not
    requested), or None if the native parser is unavailable or the file
    contains non-numeric ids (caller falls back to the Python reader)."""
    lib = get_lib()
    if lib is None:
        return None
    users_p = ctypes.POINTER(ctypes.c_int32)()
    items_p = ctypes.POINTER(ctypes.c_int32)()
    values_p = ctypes.POINTER(ctypes.c_float)()
    times_p = ctypes.POINTER(ctypes.c_int64)()
    n = lib.mml_parse(path.encode(), min_columns, int(skip_first_line),
                      ctypes.byref(users_p), ctypes.byref(items_p),
                      ctypes.byref(values_p), ctypes.byref(times_p))
    if n < 0:
        return None
    try:
        def take(ptr, dtype, count):
            if not ptr or count == 0:
                return np.zeros(0, dtype=dtype)
            return np.ctypeslib.as_array(ptr, shape=(count,)).astype(
                dtype, copy=True)

        users = take(users_p, np.int32, n)
        items = take(items_p, np.int32, n)
        values = take(values_p, np.float32, n) if min_columns >= 3 else None
        times = take(times_p, np.int64, n) if min_columns >= 4 else None
    finally:
        for p in (users_p, items_p, values_p, times_p):
            if p:
                lib.mml_free(ctypes.cast(p, ctypes.c_void_p))
    return users, items, values, times


def get_text_lib():
    """The model-text library, or None where it cannot be built (a C++
    compiler without ``std::to_chars`` for doubles, GCC < 11): the model
    files then take their Python paths."""
    global _text_lib, _text_tried
    with _lock:
        if _text_lib is not None or _text_tried:
            return _text_lib
        _text_tried = True
        path = _lib_path(_TEXT_SRC, "libmodeltext")
        if not os.path.exists(path) and not _build(path, _TEXT_SRC):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.mml_format_values.restype = ctypes.c_int64
        lib.mml_format_values.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)]
        lib.mml_text_free.restype = None
        lib.mml_text_free.argtypes = [ctypes.c_void_p]
        lib.mml_parse_values.restype = ctypes.c_int64
        lib.mml_parse_values.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        _text_lib = lib
        return _text_lib


def format_values(write, values, cols: int = 0, ii=None, jj=None):
    """Hand ``write`` the text lines (a bytes-like view) of float32
    ``values`` (row-major): one value a line (``cols`` 0), ``i j value``
    lines of a dense matrix of ``cols`` columns, or of the ids ``ii`` /
    ``jj``; each value laid out as Python's ``repr`` of it widened to
    double. Returns True, or False without the library."""
    lib = get_text_lib()
    if lib is None:
        return False
    vals = np.ascontiguousarray(values, dtype=np.float32).ravel()
    ids = [None if a is None else np.ascontiguousarray(a, dtype=np.int64)
           for a in (ii, jj)]
    if (ids[0] is None) != (ids[1] is None) or any(
            a is not None and a.size != vals.size for a in ids):
        raise ValueError("format_values: ii and jj need one id per value")
    out = ctypes.c_void_p()
    n = lib.mml_format_values(
        _c(vals), vals.size, cols, *(None if a is None else _c(a)
                                     for a in ids),
        min(os.cpu_count() or 1, 16), ctypes.byref(out))
    if n < 0:
        raise MemoryError("mml_format_values: no memory for the text")
    try:
        if n:
            write(memoryview((ctypes.c_char * n).from_address(out.value)))
    finally:
        lib.mml_text_free(out)
    return True


def parse_values(buf, offset: int, n: int, fields: int):
    """``n`` lines of ``buf`` (bytes) from ``offset``: values, or ``i j
    value`` triples (``fields`` 1 or 3). Returns (ii, jj, values) numpy
    (int64, int64, float64; ids None for values only) and the offset past
    the last line; None without the library."""
    lib = get_text_lib()
    if lib is None:
        return None
    vals = np.empty(n, np.float64)
    ii = np.empty(n, np.int64) if fields == 3 else None
    jj = np.empty(n, np.int64) if fields == 3 else None
    # the bytes object's own buffer, no copy
    base = ctypes.cast(ctypes.c_char_p(buf), ctypes.c_void_p).value
    used = lib.mml_parse_values(
        base + offset, len(buf) - offset, n, fields,
        None if ii is None else _c(ii), None if jj is None else _c(jj),
        _c(vals))
    if used < 0:
        raise EOFError("model file: a line does not parse or the file "
                       "ends early")
    return (ii, jj, vals), offset + used
