"""Build and load the port's CUDA kernels.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` file for ``sm_90a``
(with the headers ``csrc/*.cuh`` they include),
one process per file, all started together, and links the objects into
one shared library with a plain C interface under
``mymedialite_tpu_torch/build/`` (not committed); ctypes loads it.
The library's file name carries a hash of the sources and flags, so an
edited source is never served by a stale build. Nothing here runs at
import time: this module imports on machines without nvcc or a GPU.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                       "kernels cannot be built on this machine")


class KernelLibrary:
    """The loaded kernel library, with how it was built."""

    def __init__(self, path: str, build_seconds: float, compiler_log: str):
        self.path = path
        self.build_seconds = build_seconds
        self.compiler_log = compiler_log
        self.lib = ctypes.CDLL(path)
        fn = self.lib.mml_sgd_epoch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                       + [ctypes.c_float] * 3 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        fn = self.lib.mml_bpr_epoch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 12
                       + [ctypes.c_void_p])
        fn = self.lib.mml_bpr_sample
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn = self.lib.mml_svdpp_epoch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
                       + [ctypes.c_float] * 3 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        fn = self.lib.mml_exact_add
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] \
            + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn = self.lib.mml_catalog_topk_ctas_per_sm
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int]
        fn = self.lib.mml_catalog_topk
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]


@functools.lru_cache(maxsize=1)
def load_library() -> KernelLibrary:
    """Compile (if needed) and load the kernels; cached per process."""
    sources = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    headers = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cuh")))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources + headers:
        with open(src, "rb") as f:
            digest.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR,
                        f"libmml_kernels-{digest.hexdigest()[:16]}.so")
    log_path = path + ".log"
    t0 = time.perf_counter()
    if not os.path.exists(path):
        tmp = f"{path}.{os.getpid()}.tmp"
        nvcc = _nvcc()
        objs = [f"{tmp}.{os.path.basename(src)}.o" for src in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources, objs)]
        outs = [(src, p.communicate()[0], p.returncode)
                for src, p in zip(sources, procs)]
        log = "".join(out for _, out, _ in outs)
        failed = [f"{os.path.basename(src)} ({rc})" for src, _, rc in outs
                  if rc != 0]
        if not failed:
            proc = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", tmp,
                                   *objs],
                                  capture_output=True, text=True)
            log += proc.stdout + proc.stderr
            if proc.returncode != 0:
                failed.append(f"link ({proc.returncode})")
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
        if failed:
            raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n{log}")
        with open(log_path, "w") as f:
            f.write(log)
        os.replace(tmp, path)
    build_seconds = time.perf_counter() - t0
    log = ""
    if os.path.exists(log_path):
        with open(log_path) as f:
            log = f.read()
    return KernelLibrary(path, build_seconds, log)
