"""Out-of-core (streaming) graph build + disk-backed graph access.

A copy of the JAX package's ``cleora_tpu/graph/stream.py`` over the port's
own native core (``cleora_tpu_torch/native/stream.cpp``, included into
``builder.cpp``), so that the port imports nothing of that package.  For
the same input and RAM cap both packages write the same files: the CSR
arrays, entity ids and hashes are bitwise equal.

For graphs whose pair stream exceeds RAM the native streaming core ingests
newline-terminated chunks under a RAM cap, spilling sorted duplicate-summed
runs to disk and k-way-merging them into on-disk CSR arrays.  Reference
analogs: the streaming file pipeline (the reference's
src/pipeline.rs:81-104) and its legacy mmap persistence
(legacy/src/persistence.rs).

Result ordering, trimming and Markov numerics are identical to the in-RAM
builder: chunks are consumed in input order, so first-seen entity indexing
and the running-occurrence trimming see the same sequence
(src/sparse_matrix_builder.rs:188-207 semantics).  One f64-rounding caveat:
duplicate pairs whose occurrences straddle a spill-run boundary are summed
as per-run partials combined at merge time, a different grouping than the
in-RAM sequential sum — equal after the final f32 rounding on every tested
input, but not guaranteed bitwise at arbitrary scale.

The output directory holds flat binary arrays (indices.bin int32,
left_vals.bin/sym_vals.bin float32, indptr.bin int64, hashes.bin uint64,
column_ids.bin uint8, row_sums.bin float32, id_lens.bin uint32, id_blob.bin
raw bytes) plus meta.json — loadable with ``DiskGraph`` which memory-maps
everything, or materialized into a regular ``SparseMatrix`` when it fits.
The embed loop of ``parallel/embed.py`` reads a DiskGraph one shard's row
block at a time.
"""

from __future__ import annotations

import ctypes
import json
import os
from typing import Iterable, List, Optional, Sequence, Union

import numpy as np

from ..native import get_lib
from .columns import create_relation_descriptor, parse_fields

_META = "meta.json"


class DiskGraph:
    """Memory-mapped view of a streamed build's output directory.

    Arrays have the same meaning as GraphData's; everything is np.memmap so
    opening a 1B-edge graph costs no RAM.  ``row_range(lo, hi)`` yields COO
    slices for shard loaders; ``to_sparse_matrix()`` materializes the
    port's SparseMatrix (small graphs / tests).
    """

    def __init__(self, path: str):
        self.path = path
        with open(os.path.join(path, _META)) as f:
            self.meta = json.load(f)
        def mm(name, dtype):
            p = os.path.join(path, name)
            if os.path.getsize(p) == 0:  # e.g. an empty sharded-build piece
                return np.empty(0, dtype=dtype)
            return np.memmap(p, dtype=dtype, mode="r")
        self.indptr = mm("indptr.bin", np.int64)
        self.indices = mm("indices.bin", np.int32)
        self.left_vals = mm("left_vals.bin", np.float32)
        self.sym_vals = mm("sym_vals.bin", np.float32)
        self.entity_hashes = mm("hashes.bin", np.uint64)
        self.column_ids = mm("column_ids.bin", np.uint8)
        self.row_sums = mm("row_sums.bin", np.float32)
        self.id_lens = mm("id_lens.bin", np.uint32)
        self.id_blob = mm("id_blob.bin", np.uint8)
        # per-graph cache (same contract as SparseMatrix's)
        self._device_cache: dict = {}

    @property
    def num_entities(self) -> int:
        return int(self.meta["num_entities"])

    @property
    def num_edges(self) -> int:
        return int(self.meta["num_edges"])

    @property
    def columns(self) -> str:
        return self.meta["columns"]

    def entity_id(self, index: int) -> str:
        lens = self.id_lens
        # offsets computed lazily once (n ints of RAM, acceptable)
        if not hasattr(self, "_id_offs"):
            offs = np.zeros(len(lens) + 1, dtype=np.int64)
            np.cumsum(lens, out=offs[1:])
            self._id_offs = offs
        lo, hi = int(self._id_offs[index]), int(self._id_offs[index + 1])
        return bytes(self.id_blob[lo:hi]).decode("utf-8")

    def entity_ids_range(self, lo: int, hi: int) -> List[str]:
        return [self.entity_id(i) for i in range(lo, hi)]

    @property
    def entity_ids(self) -> List[str]:
        """Full id list (materializes ~N strings — fine for export flows;
        at extreme scale prefer ``entity_ids_range`` block reads)."""
        return self.entity_ids_range(0, self.num_entities)

    def row_range(self, lo: int, hi: int, markov_type: str = "left"):
        """COO slice (rows, cols, vals) for output rows [lo, hi) — the shard
        loader primitive for multi-host row-partitioned embedding."""
        s, e = int(self.indptr[lo]), int(self.indptr[hi])
        counts = np.diff(self.indptr[lo:hi + 1]).astype(np.int64)
        rows = np.repeat(np.arange(lo, hi, dtype=np.int64), counts)
        vals = self.sym_vals if markov_type == "symmetric" else self.left_vals
        return rows, np.asarray(self.indices[s:e]), np.asarray(vals[s:e])

    def initialize_deterministically(self, feature_dim: int,
                                     seed: int = 0) -> np.ndarray:
        """Bit-exact reference hash init (src/lib.rs:242-252,478-488) from
        the on-disk entity hash table, on the host.  ``embed(DiskGraph)``
        builds the same rows per shard on the device (kernel K3,
        ``parallel/state.py``)."""
        from .hashing import init_embeddings

        return init_embeddings(np.asarray(self.entity_hashes), feature_dim,
                               seed)

    def to_sparse_matrix(self):
        """Materialize into a regular in-RAM SparseMatrix (must fit)."""
        from .builder import GraphData
        from ..sparse import SparseMatrix

        cols = parse_fields(self.columns)
        data = GraphData(
            descriptor=create_relation_descriptor(cols),
            entity_ids=self.entity_ids_range(0, self.num_entities),
            entity_hashes=np.asarray(self.entity_hashes),
            column_ids=np.asarray(self.column_ids),
            row_sums=np.asarray(self.row_sums),
            indptr=np.asarray(self.indptr),
            indices=np.asarray(self.indices),
            left_vals=np.asarray(self.left_vals),
            sym_vals=np.asarray(self.sym_vals),
        )
        return SparseMatrix._from_graph_data(data)

    def __repr__(self):
        return (f"DiskGraph(path={self.path!r}, entities={self.num_entities}, "
                f"edges={self.num_edges})")


def _open_stream(lib, columns: str, hyperedge_trim_n: int,
                 num_workers: Optional[int], out_dir: str,
                 ram_cap_bytes: int):
    cols = parse_fields(columns)
    create_relation_descriptor(cols)  # validates: exactly one relation
    ncols = len(cols)
    complex_flags = (ctypes.c_uint8 * ncols)(*[int(c.complex) for c in cols])
    reflexive_flags = (ctypes.c_uint8 * ncols)(*[int(c.reflexive) for c in cols])
    handle = lib.ct_stream_open(
        ncols, complex_flags, reflexive_flags, int(hyperedge_trim_n),
        int(num_workers or 0), out_dir.encode(), int(ram_cap_bytes),
    )
    if not handle:
        raise MemoryError(
            "streaming build could not allocate its pair buffer "
            f"(ram_cap_bytes={ram_cap_bytes}); lower the cap"
        )
    return handle, cols


def _finish(lib, handle, columns: str, out_dir: str,
            skipped_warn: bool = True, extra_meta: Optional[dict] = None,
            ) -> DiskGraph:
    if lib.ct_stream_finish(handle):
        err = lib.ct_stream_error(handle)
        msg = err.decode() if err else "streaming build failed"
        lib.ct_stream_free(handle)
        raise ValueError(msg)
    skipped = lib.ct_stream_skipped(handle)
    if skipped and skipped_warn:
        import warnings

        warnings.warn(
            f"Skipped {skipped} malformed line(s) "
            "(column mismatch or invalid UTF-8)"
        )
    meta = {
        "format": "cleora_tpu.disk_graph.v1",
        "columns": columns,
        "num_entities": int(lib.ct_stream_num_entities(handle)),
        "num_edges": int(lib.ct_stream_num_edges(handle)),
        "pairs_emitted": int(lib.ct_stream_pairs_emitted(handle)),
        "skipped_lines": int(skipped),
    }
    if extra_meta:
        meta.update(extra_meta)
    lib.ct_stream_free(handle)
    with open(os.path.join(out_dir, _META), "w") as f:
        json.dump(meta, f, indent=1)
    return DiskGraph(out_dir)


def _feed_source(lib, handle, source, files: bool, chunk_bytes: int) -> None:
    """Feed an iterable of lines (or, with files=True, file paths read in
    chunk_bytes slices) into an open stream handle."""

    def _feed(buf: bytes, file_mode: bool):
        if lib.ct_stream_feed(handle, buf, len(buf), int(file_mode)):
            err = lib.ct_stream_error(handle)
            msg = err.decode() if err else "streaming feed failed"
            lib.ct_stream_free(handle)
            raise ValueError(msg)

    if files and isinstance(source, (str, bytes, os.PathLike)):
        # a bare path would be iterated CHARACTER by character below —
        # each char "opened" as a file and skipped with a warning,
        # silently producing an empty graph
        lib.ct_stream_free(handle)
        raise ValueError(
            "files=True needs a LIST of paths; wrap the single path: "
            f"[{os.fspath(source)!r}]"
        )
    if files:
        for path in source:
            try:
                f = open(path, "rb")
            except OSError as e:
                import warnings

                warnings.warn(f"Cannot open file '{path}': {e}")
                continue
            with f:
                carry = b""
                while True:
                    block = f.read(chunk_bytes)
                    if not block:
                        if carry:
                            _feed(carry + b"\n", True)
                        break
                    block = carry + block
                    cut = block.rfind(b"\n")
                    if cut == -1:
                        carry = block
                        continue
                    _feed(block[: cut + 1], True)
                    carry = block[cut + 1:]
    else:
        batch: List[str] = []
        size = 0
        for line in source:
            if not isinstance(line, str):
                lib.ct_stream_free(handle)
                raise ValueError("Iterator must yield strings")
            if "\n" in line:  # same one-element-one-line contract as
                # SparseMatrix.from_iterator (the chunks below are joined
                # with newlines)
                lib.ct_stream_free(handle)
                raise ValueError(
                    "Iterator elements must be single lines without '\\n'"
                )
            batch.append(line)
            size += len(line) + 1
            if size >= chunk_bytes:
                _feed(("\n".join(batch) + "\n").encode("utf-8"), False)
                batch, size = [], 0
        if batch:
            _feed(("\n".join(batch) + "\n").encode("utf-8"), False)


def build_graph_streaming(
    source: Union[Sequence[str], Iterable[str]],
    columns: str,
    out_dir: str,
    *,
    hyperedge_trim_n: int = 16,
    num_workers: Optional[int] = None,
    ram_cap_bytes: int = 2 << 30,
    chunk_bytes: int = 64 << 20,
    files: bool = False,
    row_range: Optional[tuple] = None,
) -> DiskGraph:
    """Stream-build a graph into ``out_dir`` under a pair-buffer RAM cap.

    ``source`` is an iterable of hyperedge lines (like from_iterator), or —
    with ``files=True`` — a list of file paths read in 64 MB slices (invalid
    UTF-8 / blank lines skipped, matching from_files).  The entity table
    (hashes, ids, row sums) stays in RAM; the pair stream is spilled to
    sorted runs in ``out_dir`` and merged to on-disk CSR.

    ``row_range=(lo, hi)`` builds only the output rows in [lo, hi) — one
    host's piece of a multi-host sharded build.  The full input is still
    scanned (the entity registry, row sums and trimming state are global and
    identical on every host), but only 1/P of the pair stream is sorted,
    spilled and merged.  The piece has the full entity table and a
    full-length indptr (zero outside the range); disjoint pieces concatenate
    into the complete graph via ``merge_disk_graph_shards``.
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError(
            "streaming build requires the native builder "
            "(CLEORA_TPU_NATIVE=0 disables it)"
        )
    os.makedirs(out_dir, exist_ok=True)
    handle, _ = _open_stream(lib, columns, hyperedge_trim_n, num_workers,
                             out_dir, ram_cap_bytes)
    extra_meta = None
    if row_range is not None:
        lo, hi = int(row_range[0]), int(row_range[1])
        if lo < 0 or hi < lo:  # hi == lo is a legitimate EMPTY piece (a
            # host whose devices own zero rows of a small graph)
            lib.ct_stream_free(handle)
            raise ValueError(f"invalid row_range {row_range!r}")
        lib.ct_stream_set_row_filter(handle, lo, hi)
        extra_meta = {"row_range": [lo, hi]}
    _feed_source(lib, handle, source, files, chunk_bytes)
    return _finish(lib, handle, columns, out_dir, extra_meta=extra_meta)


def count_entities_streaming(
    source: Union[Sequence[str], Iterable[str]],
    columns: str,
    *,
    hyperedge_trim_n: int = 16,
    num_workers: Optional[int] = None,
    chunk_bytes: int = 64 << 20,
    files: bool = False,
) -> int:
    """Index-only scan: the total entity count of a build without emitting
    any pairs (no sort, no spill — parse + first-seen registry + row stats
    only).  Pass 1 of a multi-host sharded build: N determines each host's
    row block before the emitting pass."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("streaming build requires the native builder")
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        handle, _ = _open_stream(lib, columns, hyperedge_trim_n, num_workers,
                                 tmp, 64 << 20)
        lib.ct_stream_set_emit(handle, 0)
        _feed_source(lib, handle, source, files, chunk_bytes)
        n = int(lib.ct_stream_num_entities(handle))
        lib.ct_stream_free(handle)
    return n


def build_graph_streaming_pairs(
    pair_chunks: Iterable,
    columns: str,
    out_dir: str,
    *,
    hyperedge_trim_n: int = 16,
    num_workers: Optional[int] = None,
    ram_cap_bytes: int = 2 << 30,
    row_range: Optional[tuple] = None,
) -> DiskGraph:
    """Stream-build from (src, dst) int64 array chunks — the zero-text fast
    path for synthetic scale tests and _LazyEdgeList ingestion.  Ids are
    formatted as decimal strings natively, so the result is identical to
    feeding ``f"{s} {d}"`` lines.  Requires a single complex::reflexive
    column spec.  ``row_range`` builds one host's piece, as in
    ``build_graph_streaming``."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("streaming build requires the native builder")
    os.makedirs(out_dir, exist_ok=True)
    handle, _ = _open_stream(lib, columns, hyperedge_trim_n, num_workers,
                             out_dir, ram_cap_bytes)
    extra_meta = None
    if row_range is not None:
        lo, hi = int(row_range[0]), int(row_range[1])
        if lo < 0 or hi < lo:
            lib.ct_stream_free(handle)
            raise ValueError(f"invalid row_range {row_range!r}")
        lib.ct_stream_set_row_filter(handle, lo, hi)
        extra_meta = {"row_range": [lo, hi]}
    for src, dst in pair_chunks:
        src = np.ascontiguousarray(src, dtype=np.int64)
        dst = np.ascontiguousarray(dst, dtype=np.int64)
        if src.shape != dst.shape or src.ndim != 1:
            lib.ct_stream_free(handle)
            raise ValueError(
                "src/dst chunks must be 1-D arrays of equal length, got "
                f"shapes {src.shape} and {dst.shape}"
            )
        if lib.ct_stream_feed_pairs(
            handle, src.ctypes.data_as(ctypes.c_void_p),
            dst.ctypes.data_as(ctypes.c_void_p), src.shape[0],
        ):
            err = lib.ct_stream_error(handle)
            msg = err.decode() if err else "streaming feed failed"
            lib.ct_stream_free(handle)
            raise ValueError(msg)
    return _finish(lib, handle, columns, out_dir, extra_meta=extra_meta)


def shard_row_params(n_rows: int, n_shards: int,
                     row_multiple: int = 8) -> tuple:
    """(n_rows_padded, rows_per_shard) of the canonical n_shards-way row
    partition — THE cut formula shared by the sharded build (this module)
    and the sharded embed (parallel.shard)."""
    m = n_shards * row_multiple
    n_padded = -(-max(n_rows, m) // m) * m
    return n_padded, n_padded // n_shards


def shard_row_bounds(n_rows: int, n_shards: int,
                     row_multiple: int = 8) -> List[int]:
    """Row-block boundaries of an n_shards-way partition: shard k owns rows
    [bounds[k], bounds[k+1]).  The SAME formula parallel.shard uses to cut
    the embedding matrix across devices, so a sharded build with
    ``row_range=(bounds[k], bounds[k+1])`` yields exactly the edges device k
    will own at embed time (host-granularity: use the range spanning a
    host's devices)."""
    _, rows_per_shard = shard_row_params(n_rows, n_shards, row_multiple)
    return [min(k * rows_per_shard, n_rows) for k in range(n_shards + 1)]


def host_piece_range(n_entities: int, n_shards: int, shards_per_host: int,
                     host_id: int, row_multiple: int = 8) -> tuple:
    """Row range a HOST must build so its piece covers exactly the blocks of
    its own devices: shards are cut per-device (``n_shards`` = total device
    count), and host h owns devices [h·spc, (h+1)·spc).  Use with
    ``build_graph_streaming(..., row_range=...)``; the per-host piece then
    feeds ``parallel.embed_sharded`` directly (no merged graph on any
    host)."""
    bounds = shard_row_bounds(n_entities, n_shards, row_multiple)
    lo = bounds[min(host_id * shards_per_host, n_shards)]
    hi = bounds[min((host_id + 1) * shards_per_host, n_shards)]
    return lo, hi


def build_graph_streaming_sharded(
    source,
    columns: str,
    out_dir: str,
    shard_index: int,
    num_shards: int,
    *,
    n_entities: Optional[int] = None,
    row_multiple: int = 8,
    hyperedge_trim_n: int = 16,
    num_workers: Optional[int] = None,
    ram_cap_bytes: int = 2 << 30,
    chunk_bytes: int = 64 << 20,
    files: bool = False,
) -> DiskGraph:
    """One host's piece of a multi-host sharded build (host ``shard_index``
    of ``num_shards``).

    Every host scans the SAME input (the first-seen entity registry, row
    sums and trimming state are input-order-dependent and must be global —
    the scan is cheap), but each host sorts/spills/merges only its own row
    block: the expensive part of the build parallelizes num_shards-fold.
    Pass 1 (skipped when ``n_entities`` is given, e.g. broadcast from host
    0) is an index-only scan for the global entity count; pass 2 builds rows
    [bounds[k], bounds[k+1]) per ``shard_row_bounds``.  Disjoint pieces on
    shared storage concatenate into the full graph with
    ``merge_disk_graph_shards``; a piece alone also feeds a per-host loader.

    ``source`` must be re-iterable: a list of file paths (``files=True``), a
    sequence of lines, or a zero-arg callable returning a fresh iterator.
    """
    if not 0 <= shard_index < num_shards:
        raise ValueError(f"shard_index {shard_index} not in [0, {num_shards})")

    def _fresh():
        return source() if callable(source) else source

    if not (callable(source) or isinstance(source, (Sequence, list, tuple))):
        # applies in files mode too: a one-shot iterator of paths would be
        # exhausted by the pass-1 entity scan and pass 2 would silently
        # build an empty graph
        raise ValueError(
            "sharded build needs a re-iterable source (both passes scan "
            "it): a list of file paths (files=True), a sequence of lines, "
            "or a callable returning a fresh iterator"
        )
    if n_entities is None:
        n_entities = count_entities_streaming(
            _fresh(), columns, hyperedge_trim_n=hyperedge_trim_n,
            num_workers=num_workers, chunk_bytes=chunk_bytes, files=files,
        )
    bounds = shard_row_bounds(n_entities, num_shards, row_multiple)
    lo, hi = bounds[shard_index], bounds[shard_index + 1]
    dg = build_graph_streaming(
        _fresh(), columns, out_dir, hyperedge_trim_n=hyperedge_trim_n,
        num_workers=num_workers, ram_cap_bytes=ram_cap_bytes,
        chunk_bytes=chunk_bytes, files=files, row_range=(lo, hi),
    )
    dg.meta["shard"] = [int(shard_index), int(num_shards)]
    with open(os.path.join(out_dir, _META), "w") as f:
        json.dump(dg.meta, f, indent=1)
    return dg


def _same_file(a: str, b: str, chunk: int = 16 << 20) -> bool:
    """Streamed byte equality of two files (no full load into RAM)."""
    if os.path.getsize(a) != os.path.getsize(b):
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            ba = fa.read(chunk)
            if ba != fb.read(chunk):
                return False
            if not ba:
                return True


def merge_disk_graph_shards(shard_dirs: Sequence[str],
                            out_dir: str) -> DiskGraph:
    """Concatenate the disjoint row-range pieces of a sharded build into the
    complete on-disk graph (bitwise-identical to an unsharded build).

    Pieces hold contiguous, row-sorted CSR slices, so the merge is a
    streaming file concatenation in row order plus an indptr re-base — pure
    sequential I/O, no sort.  The entity table is global and identical in
    every piece; it is copied from the first and cross-checked."""
    import shutil

    metas = []
    for d in shard_dirs:
        with open(os.path.join(d, _META)) as f:
            metas.append(json.load(f))
    for m in metas:
        if "row_range" not in m:
            raise ValueError("merge_disk_graph_shards needs sharded pieces "
                             "(built with row_range)")
    # (lo, hi) key: an empty piece (hi == lo) must sort BEFORE the
    # non-empty piece starting at the same row or the tiling check trips
    order = sorted(range(len(metas)),
                   key=lambda i: tuple(metas[i]["row_range"]))
    dirs = [shard_dirs[i] for i in order]
    metas = [metas[i] for i in order]
    n = metas[0]["num_entities"]
    columns = metas[0]["columns"]
    for m in metas:
        if m["num_entities"] != n or m["columns"] != columns:
            raise ValueError("shard pieces disagree on entity table/columns")
    cover = 0
    for m in metas:
        lo, hi = m["row_range"]
        if lo != cover:
            raise ValueError(
                f"shard row ranges must tile [0, {n}) exactly; piece starts "
                f"at {lo}, expected {cover}"
            )
        cover = max(cover, hi)
    if cover < n:
        raise ValueError(f"shard pieces leave rows [{cover}, {n}) uncovered")

    os.makedirs(out_dir, exist_ok=True)
    first = DiskGraph(dirs[0])
    for name in ("hashes.bin", "column_ids.bin", "row_sums.bin",
                 "id_lens.bin", "id_blob.bin"):
        shutil.copyfile(os.path.join(dirs[0], name),
                        os.path.join(out_dir, name))
    # stream-concatenate the CSR arrays in row order
    for name in ("indices.bin", "left_vals.bin", "sym_vals.bin"):
        with open(os.path.join(out_dir, name), "wb") as out:
            for d in dirs:
                with open(os.path.join(d, name), "rb") as f:
                    shutil.copyfileobj(f, out, 16 << 20)
    # indptr: each piece's counts live only in its range; re-base cumulative
    offset = 0
    n_edges = 0
    with open(os.path.join(out_dir, "indptr.bin"), "wb") as out:
        out.write(np.zeros(1, dtype=np.int64).tobytes())
        for d, m in zip(dirs, metas):
            lo, hi = m["row_range"]
            piece = DiskGraph(d)
            # piece.indptr[lo] == 0 (no owned edges before lo)
            seg = np.asarray(piece.indptr[lo + 1:hi + 1], dtype=np.int64)
            if d != dirs[0] and not _same_file(
                os.path.join(d, "hashes.bin"),
                os.path.join(dirs[0], "hashes.bin"),
            ):
                raise ValueError(
                    f"piece {d} has a different entity table — pieces must "
                    "come from sharded builds over the SAME input"
                )
            out.write((seg + offset).tobytes())
            offset += int(seg[-1]) if seg.size else 0
            n_edges += m["num_edges"]
        # rows past the last piece's hi (none when cover == n)
    meta = {
        "format": "cleora_tpu.disk_graph.v1",
        "columns": columns,
        "num_entities": n,
        "num_edges": n_edges,
        "pairs_emitted": sum(m.get("pairs_emitted", 0) for m in metas),
        "skipped_lines": metas[0].get("skipped_lines", 0),
        "merged_from": len(dirs),
    }
    with open(os.path.join(out_dir, _META), "w") as f:
        json.dump(meta, f, indent=1)
    return DiskGraph(out_dir)
