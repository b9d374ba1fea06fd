"""ctypes front-end for the C++ graph builder (cleora_tpu_torch/native/builder.cpp).

``build_graph_native`` has the same contract as
:func:`cleora_tpu_torch.graph.builder.build_graph` and is used by SparseMatrix when
the native library is available (CLEORA_TPU_NATIVE=0 disables it).
"""

from __future__ import annotations

import ctypes
from typing import Iterable, List, Optional

import numpy as np

from ..native import get_lib
from .builder import GraphData
from .columns import create_relation_descriptor, parse_fields


def native_available() -> bool:
    return get_lib() is not None


def build_graph_native(
    lines: Iterable[str],
    columns: str,
    hyperedge_trim_n: int = 16,
    num_workers: Optional[int] = None,
) -> GraphData:
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native builder not available")

    cols = parse_fields(columns)
    descriptor = create_relation_descriptor(cols)

    if not isinstance(lines, (list, tuple)):
        lines = list(lines)
    if not lines:
        raise ValueError("No valid hyperedge lines provided")
    buf = "\n".join(lines).encode("utf-8")

    ncols = len(cols)
    complex_flags = (ctypes.c_uint8 * ncols)(*[int(c.complex) for c in cols])
    reflexive_flags = (ctypes.c_uint8 * ncols)(*[int(c.reflexive) for c in cols])

    handle = lib.ct_build(
        buf, len(buf), ncols, complex_flags, reflexive_flags,
        int(hyperedge_trim_n), int(num_workers or 0),
    )
    return _extract(lib, handle, descriptor)


def build_graph_native_files(
    filepaths,
    columns: str,
    hyperedge_trim_n: int = 16,
    num_workers: Optional[int] = None,
) -> GraphData:
    """File-mode fast path: the C++ core reads the files itself (≤4 reader
    threads) and skips blank lines, matching SparseMatrix.from_files."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native builder not available")
    if not hasattr(lib, "ct_build_files"):
        raise RuntimeError("native library too old; rebuild")

    cols = parse_fields(columns)
    descriptor = create_relation_descriptor(cols)
    ncols = len(cols)
    complex_flags = (ctypes.c_uint8 * ncols)(*[int(c.complex) for c in cols])
    reflexive_flags = (ctypes.c_uint8 * ncols)(*[int(c.reflexive) for c in cols])

    encoded = [p.encode("utf-8") for p in filepaths]
    path_arr = (ctypes.c_char_p * len(encoded))(*encoded)
    handle = lib.ct_build_files(
        path_arr, len(encoded), ncols, complex_flags, reflexive_flags,
        int(hyperedge_trim_n), int(num_workers or 0),
    )
    return _extract(lib, handle, descriptor)


def _extract(lib, handle, descriptor) -> GraphData:
    if not handle:  # allocation of the result struct itself failed
        raise MemoryError("native graph build could not allocate its state")
    try:
        err = lib.ct_error(handle)
        if err:
            raise ValueError(err.decode("utf-8"))

        skipped = lib.ct_skipped_lines(handle)
        if skipped:
            import warnings

            # parity: the reference warns per malformed line
            # (src/pipeline.rs:71-78); the native path reports the count.
            # In file mode the counter also covers invalid-UTF-8 lines.
            warnings.warn(
                f"Skipped {skipped} malformed line(s) "
                "(column mismatch or invalid UTF-8)"
            )

        n = lib.ct_num_entities(handle)
        nnz = lib.ct_num_edges(handle)

        hashes = np.empty(n, dtype=np.uint64)
        column_ids = np.empty(n, dtype=np.uint8)
        row_sums = np.empty(n, dtype=np.float32)
        indptr = np.empty(n + 1, dtype=np.int64)
        indices = np.empty(nnz, dtype=np.int32)
        left_vals = np.empty(nnz, dtype=np.float32)
        sym_vals = np.empty(nnz, dtype=np.float32)
        lib.ct_get_arrays(
            handle,
            hashes.ctypes.data_as(ctypes.c_void_p),
            column_ids.ctypes.data_as(ctypes.c_void_p),
            row_sums.ctypes.data_as(ctypes.c_void_p),
            indptr.ctypes.data_as(ctypes.c_void_p),
            indices.ctypes.data_as(ctypes.c_void_p),
            left_vals.ctypes.data_as(ctypes.c_void_p),
            sym_vals.ctypes.data_as(ctypes.c_void_p),
        )
        lens = np.empty(n, dtype=np.uint32)
        lib.ct_id_lens(handle, lens.ctypes.data_as(ctypes.c_void_p))
        blob = np.empty(int(lens.sum()), dtype=np.uint8)
        lib.ct_id_bytes(handle, blob.ctypes.data_as(ctypes.c_void_p))
        entity_ids = _split_blob(blob, lens)
    finally:
        lib.ct_free(handle)

    return GraphData(
        descriptor=descriptor,
        entity_ids=entity_ids,
        entity_hashes=hashes,
        column_ids=column_ids,
        row_sums=row_sums,
        indptr=indptr,
        indices=indices,
        left_vals=left_vals,
        sym_vals=sym_vals,
    )


def _split_blob(blob: np.ndarray, lens: np.ndarray) -> List[str]:
    """Decode the concatenated id blob into a list of strings.

    Vectorized path for all-ASCII ids (ints, typical tokens): scatter the
    blob into a zero-padded (n, max_len) byte matrix, then a C-speed S→U
    astype (NUL-stripping) — ~5x faster than a Python slicing loop at
    millions of entities.  Falls back to the loop for very wide ids
    (padding would blow memory), non-ASCII, or embedded NULs.
    """
    n = int(lens.shape[0])
    if n == 0:
        return []
    max_len = int(lens.max())
    total = int(lens.sum())
    if 0 < max_len <= 64 and not (blob == 0).any() and blob.max() < 128:
        lens64 = lens.astype(np.int64)
        starts = np.concatenate(([0], np.cumsum(lens64)[:-1]))
        dst = (
            np.repeat(np.arange(n, dtype=np.int64) * max_len, lens64)
            + np.arange(total, dtype=np.int64)
            - np.repeat(starts, lens64)
        )
        padded = np.zeros(n * max_len, dtype=np.uint8)
        padded[dst] = blob
        return padded.view(f"S{max_len}").astype(f"U{max_len}").tolist()
    raw = blob.tobytes()
    out = []
    off = 0
    for L in lens:
        try:
            out.append(raw[off:off + L].decode("utf-8"))
        except UnicodeDecodeError as e:  # pragma: no cover - validator bug
            # Raise a non-ValueError so sparse.py's dispatch falls back to
            # the numpy builder (which skips bad lines) rather than treating
            # this as a user-facing validation error and aborting ingest.
            raise RuntimeError(
                f"native builder produced a non-UTF-8 entity id: {e}"
            ) from e
        off += int(L)
    return out
