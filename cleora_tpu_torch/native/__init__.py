"""Native (C++) graph-ingest core of the port.

``builder.cpp`` (with ``stream.cpp`` included into it) is a copy of the JAX
package's ingest core, kept here so that the port imports nothing of that
package.  It is compiled on first use into ``libcleora_native.so`` next to
the source and loaded via ctypes.  Set ``CLEORA_TPU_NATIVE=0`` to force the
pure-numpy fallback.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "builder.cpp")
_SRC_EXTRA = (os.path.join(_DIR, "stream.cpp"),)  # #included into builder.cpp
_LIB = os.path.join(_DIR, "libcleora_native.so")

_lock = threading.Lock()
_lib = None
_load_failed = False


def _compile() -> bool:
    # per-process temp name: concurrent processes would otherwise write the
    # SAME .tmp dirent and could publish a corrupt .so newer than the
    # sources (never rebuilt again)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        "-fopenmp", _SRC, "-o", tmp,
    ]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if proc.returncode != 0:
        sys.stderr.write(
            f"cleora_tpu_torch: native builder compile failed:\n{proc.stderr}\n"
        )
        try:
            os.remove(tmp)
        except OSError:
            pass
        return False
    os.replace(tmp, _LIB)
    return True


def _bind(lib):
    c = ctypes
    lib.ct_build.restype = c.c_void_p
    lib.ct_build.argtypes = [
        c.c_char_p, c.c_int64, c.c_int, c.POINTER(c.c_uint8),
        c.POINTER(c.c_uint8), c.c_int, c.c_int,
    ]
    lib.ct_build_files.restype = c.c_void_p
    lib.ct_build_files.argtypes = [
        c.POINTER(c.c_char_p), c.c_int, c.c_int, c.POINTER(c.c_uint8),
        c.POINTER(c.c_uint8), c.c_int, c.c_int,
    ]
    lib.ct_error.restype = c.c_char_p
    lib.ct_error.argtypes = [c.c_void_p]
    for fn in ("ct_num_entities", "ct_num_edges", "ct_skipped_lines"):
        getattr(lib, fn).restype = c.c_int64
        getattr(lib, fn).argtypes = [c.c_void_p]
    lib.ct_get_arrays.restype = None
    lib.ct_get_arrays.argtypes = [c.c_void_p] + [c.c_void_p] * 7
    lib.ct_id_lens.restype = None
    lib.ct_id_lens.argtypes = [c.c_void_p, c.c_void_p]
    lib.ct_id_bytes.restype = None
    lib.ct_id_bytes.argtypes = [c.c_void_p, c.c_void_p]
    lib.ct_free.restype = None
    lib.ct_free.argtypes = [c.c_void_p]
    # ---- streaming (out-of-core) build
    lib.ct_stream_open.restype = c.c_void_p
    lib.ct_stream_open.argtypes = [
        c.c_int, c.POINTER(c.c_uint8), c.POINTER(c.c_uint8), c.c_int,
        c.c_int, c.c_char_p, c.c_int64,
    ]
    lib.ct_stream_feed.restype = c.c_int
    lib.ct_stream_feed.argtypes = [c.c_void_p, c.c_char_p, c.c_int64, c.c_int]
    lib.ct_stream_feed_pairs.restype = c.c_int
    lib.ct_stream_feed_pairs.argtypes = [
        c.c_void_p, c.c_void_p, c.c_void_p, c.c_int64,
    ]
    lib.ct_stream_finish.restype = c.c_int
    lib.ct_stream_finish.argtypes = [c.c_void_p]
    lib.ct_stream_error.restype = c.c_char_p
    lib.ct_stream_error.argtypes = [c.c_void_p]
    for fn in ("ct_stream_num_entities", "ct_stream_num_edges",
               "ct_stream_skipped", "ct_stream_pairs_emitted"):
        getattr(lib, fn).restype = c.c_int64
        getattr(lib, fn).argtypes = [c.c_void_p]
    lib.ct_stream_num_runs.restype = c.c_int
    lib.ct_stream_num_runs.argtypes = [c.c_void_p]
    lib.ct_stream_set_emit.restype = None
    lib.ct_stream_set_emit.argtypes = [c.c_void_p, c.c_int]
    lib.ct_stream_set_row_filter.restype = None
    lib.ct_stream_set_row_filter.argtypes = [c.c_void_p, c.c_int64, c.c_int64]
    lib.ct_stream_free.restype = None
    lib.ct_stream_free.argtypes = [c.c_void_p]
    lib.ct_sort_u64.restype = c.c_int
    lib.ct_sort_u64.argtypes = [c.c_void_p, c.c_int64, c.c_int]
    return lib


def sort_u64(a, num_workers: int = 0):
    """Ascending sort of a 1-D uint64 numpy array via the native parallel
    radix core.  Sorts IN PLACE when ``a`` is contiguous (and also returns
    it); falls back to ``np.sort`` when the native library is unavailable
    (cleora_tpu/native/__init__.py:sort_u64)."""
    import numpy as np

    a = np.asarray(a)
    if a.dtype != np.uint64:
        raise TypeError(f"sort_u64 needs uint64, got {a.dtype}")
    lib = get_lib()
    if lib is None:
        return np.sort(a, kind="stable")
    if not a.flags.c_contiguous:
        a = np.ascontiguousarray(a)
    lib.ct_sort_u64(a.ctypes.data_as(ctypes.c_void_p), a.shape[0],
                    int(num_workers))
    return a


def get_lib():
    """Load (compiling if needed) the native library, or None if unavailable."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    if os.environ.get("CLEORA_TPU_NATIVE", "1") == "0":
        _load_failed = True
        return None
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            srcs = [p for p in (_SRC,) + _SRC_EXTRA if os.path.exists(p)]
            needs_build = not os.path.exists(_LIB) or (
                srcs
                and max(os.path.getmtime(p) for p in srcs)
                > os.path.getmtime(_LIB)
            )
            if needs_build and not _compile():
                _load_failed = True
                return None
            _lib = _bind(ctypes.CDLL(_LIB))
        except AttributeError:
            # a stale .so (newer mtime than the sources, e.g. restored from
            # a cache) missing newly-added exports: rebuild once, else fall
            # back to numpy rather than crash callers expecting None
            try:
                if _compile():
                    _lib = _bind(ctypes.CDLL(_LIB))
                else:
                    _load_failed = True
            except (OSError, AttributeError) as e:
                sys.stderr.write(
                    f"cleora_tpu_torch: native builder unavailable: {e}\n"
                )
                _load_failed = True
        except OSError as e:
            sys.stderr.write(
                f"cleora_tpu_torch: native builder unavailable: {e}\n")
            _load_failed = True
    return _lib
