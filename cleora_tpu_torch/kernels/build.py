"""Build of the port's CUDA kernels at first use.

Each ``<name>.cu`` in this directory is compiled by ``nvcc`` into its own
shared library with a plain C interface, ``_build/lib<name>.so``, and loaded
with ctypes.  A library is rebuilt when its source is newer (the idiom of
the native ingest loader).  Several stale sources are compiled in parallel,
one ``nvcc`` each.  A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "_build")
KERNELS = ("spmm_csr", "row_normalize", "hash_init", "edge_attention",
           "spmm_axpy", "dense_markov", "log_clip", "walk_uniform",
           "pair_enum", "run_length", "ppmi", "walk_p_q", "pq_adc",
           "label_prop", "relu_dropout", "halo_pack", "walk_owned",
           "walk2_owned", "spmm_acc")
DEFAULT_CUDA_HOME = "/usr/local/cuda"
NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of the builds this process ran
build_logs: Dict[str, str] = {}


def source_path(name: str) -> str:
    return os.path.join(_DIR, f"{name}.cu")


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
            "built from source at first use"
        )
    return found


def _stale(name: str) -> bool:
    lib = lib_path(name)
    return not os.path.exists(lib) or (
        os.path.getmtime(source_path(name)) > os.path.getmtime(lib)
    )


def build() -> Dict[str, float]:
    """Compile every stale kernel, all ``nvcc`` processes started together.
    Returns the seconds each build took (0.0 for a library that was up to
    date).  Raises RuntimeError with the compiler's output if any build
    fails."""
    with _lock:
        return _build_locked(KERNELS)


def _build_locked(names) -> Dict[str, float]:
    os.makedirs(BUILD_DIR, exist_ok=True)
    compiler = nvcc()
    started = {}
    for name in names:
        if not _stale(name):
            continue
        # per-process temp name + os.replace: concurrent builders never
        # publish a half-written library
        tmp = f"{lib_path(name)}.{os.getpid()}.tmp"
        cmd = [compiler, *NVCC_FLAGS, source_path(name), "-o", tmp]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    errors = []
    for name, (proc, tmp, t0) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        build_logs[name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            if os.path.exists(tmp):
                os.remove(tmp)
        else:
            os.replace(tmp, lib_path(name))
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if stale, loaded once."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            _build_locked([name])
            _libs[name] = ctypes.CDLL(lib_path(name))
        return _libs[name]
