"""Host-side hypergraph → Markov transition matrix builder.

Re-implements the reference ingest semantics (clique expansion, hyperedge
trimming, Markov normalization) with vectorized numpy.  Semantics parity
targets (file:line refer to the reference pycleora 3.2.1 checkout):

* entity registration order: first-seen over xxh64 hash values, scanning rows
  in input order and columns left-to-right (src/sparse_matrix_builder.rs:40-75,
  the deterministic sync-indexer path).
* per-hyperedge row stats: every occurrence of node a in side A contributes
  ``occurrence[a] += |B|`` and ``row_sum[a] += 1/|B|`` and symmetrically
  (src/sparse_matrix_builder.rs:170-228).
* hyperedge trimming: a side with more than ``hyperedge_trim_n`` nodes is
  split into the top-n nodes by *running* occurrence count ("high") vs the
  rest ("low"); only high×high, high×low, low×high pairs are emitted —
  low×low pairs are dropped (src/sparse_matrix_builder.rs:188-207).  The
  running counts include the current hyperedge's own update.
* each kept ordered pair (a, b) adds ``1/(|A|·|B|)`` to edge (a, b) AND to
  edge (b, a) (src/sparse_matrix_builder.rs:209-233).
* final normalization: ``left = v / row_sum[row]``,
  ``sym = v / sqrt(row_sum[row] · row_sum[col])``
  (src/sparse_matrix_builder.rs:316-331).

Divergences (documented): the reference's trimming depends on how hyperedges
interleave across worker-thread buffers, which makes it nondeterministic for
num_workers > 1; this builder always implements the deterministic
single-buffer (input-order) semantics.  Ties in the high/low occurrence
partition are broken arbitrarily in the reference (unstable select); here via
numpy argpartition.  Rows with zero edges get an empty CSR row here, whereas
the reference's slice bookkeeping silently assumes none exist.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .columns import (
    Column,
    RelationDescriptor,
    create_relation_descriptor,
    parse_fields,
    parse_line,
)
from .hashing import hash_entities


@dataclass
class GraphData:
    """The built graph: node table + CSR transition matrix (both Markov kinds)."""

    descriptor: RelationDescriptor
    entity_ids: List[str]
    entity_hashes: np.ndarray  # uint64 (N,)
    column_ids: np.ndarray  # uint8 (N,)
    row_sums: np.ndarray  # float32 (N,)  ("degrees" in the reference API)
    indptr: np.ndarray  # int64 (N+1,)
    indices: np.ndarray  # int32 (nnz,)
    left_vals: np.ndarray  # float32 (nnz,)
    sym_vals: np.ndarray  # float32 (nnz,)

    @property
    def num_entities(self) -> int:
        return len(self.entity_ids)

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])


def _tokenize(
    lines: Iterable[str], cols: List[Column]
) -> Tuple[List[str], np.ndarray, np.ndarray, np.ndarray, np.ndarray, bool]:
    """Parse lines into flat per-side token streams.

    Returns (tokens, a_off, a_len, b_off, b_len, reflexive) where tokens is the
    flat list of entity strings in registration order and a_off/a_len index the
    A-side span of each hyperedge within it (b_* for the B side).  For a
    reflexive single-column spec both sides alias the same span.
    """
    ncols = len(cols)
    reflexive = ncols == 1  # single relation ⇒ either 1 reflexive col or 2 cols
    tokens: List[str] = []
    a_off: List[int] = []
    a_len: List[int] = []
    b_off: List[int] = []
    b_len: List[int] = []

    for line in lines:
        row = parse_line(line)
        if len(row) != ncols:
            warnings.warn(
                f"Wrong number of columns (expected: {ncols}, provided: "
                f"{len(row)}). The line [{line}] is skipped."
            )
            continue
        if reflexive:
            col_tokens = row[0]  # complex column: all entities
            off = len(tokens)
            tokens.extend(col_tokens)
            a_off.append(off)
            a_len.append(len(col_tokens))
            b_off.append(off)
            b_len.append(len(col_tokens))
        else:
            spans = []
            for ci in range(2):
                col_tokens = row[ci] if cols[ci].complex else row[ci][:1]
                off = len(tokens)
                tokens.extend(col_tokens)
                spans.append((off, len(col_tokens)))
            a_off.append(spans[0][0])
            a_len.append(spans[0][1])
            b_off.append(spans[1][0])
            b_len.append(spans[1][1])

    return (
        tokens,
        np.asarray(a_off, dtype=np.int64),
        np.asarray(a_len, dtype=np.int64),
        np.asarray(b_off, dtype=np.int64),
        np.asarray(b_len, dtype=np.int64),
        reflexive,
    )


def _index_entities(
    tokens: List[str], token_col_ids: np.ndarray
) -> Tuple[np.ndarray, List[str], np.ndarray, np.ndarray]:
    """First-seen dedup of token hashes → dense indices.

    Returns (token_index, entity_ids, entity_hashes, entity_column_ids).
    """
    hashes = hash_entities(tokens)
    uniq, first_pos, inverse = np.unique(hashes, return_index=True, return_inverse=True)
    order = np.argsort(first_pos, kind="stable")  # first-seen order
    rank_of_sorted = np.empty_like(order)
    rank_of_sorted[order] = np.arange(order.shape[0])
    token_index = rank_of_sorted[inverse].astype(np.int64)
    entity_hashes = uniq[order]
    first_pos_ordered = first_pos[order]
    entity_ids = [tokens[i] for i in first_pos_ordered]
    entity_column_ids = token_col_ids[first_pos_ordered].astype(np.uint8)
    return token_index, entity_ids, entity_hashes, entity_column_ids


def _cartesian_pairs(
    nodes: np.ndarray,
    a_off: np.ndarray,
    a_len: np.ndarray,
    b_off: np.ndarray,
    b_len: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized variable-size cartesian products over many hyperedges.

    Returns (src, dst, val) with val = 1/(|A|·|B|) repeated per pair.
    """
    counts = a_len * b_len
    total = int(counts.sum())
    if total == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, np.zeros(0, dtype=np.float32)
    edge_id = np.repeat(np.arange(counts.shape[0]), counts)
    cum = np.concatenate(([0], np.cumsum(counts)[:-1]))
    k = np.arange(total, dtype=np.int64) - cum[edge_id]
    bl = b_len[edge_id]
    ai = k // bl
    bi = k - ai * bl
    src = nodes[a_off[edge_id] + ai]
    dst = nodes[b_off[edge_id] + bi]
    val = (1.0 / counts.astype(np.float64))[edge_id].astype(np.float32)
    return src, dst, val


def _apply_row_stats(
    occurrence: np.ndarray,
    row_sum: np.ndarray,
    nodes: np.ndarray,
    a_off: np.ndarray,
    a_len: np.ndarray,
    b_off: np.ndarray,
    b_len: np.ndarray,
) -> None:
    """occurrence[a] += |B|, row_sum[a] += 1/|B| per occurrence, and symmetric."""
    eid_a = np.repeat(np.arange(a_len.shape[0]), a_len)
    flat_a = nodes[_span_gather(a_off, a_len)]
    np.add.at(occurrence, flat_a, b_len[eid_a])
    np.add.at(row_sum, flat_a, (1.0 / b_len[eid_a]).astype(np.float32))
    eid_b = np.repeat(np.arange(b_len.shape[0]), b_len)
    flat_b = nodes[_span_gather(b_off, b_len)]
    np.add.at(occurrence, flat_b, a_len[eid_b])
    np.add.at(row_sum, flat_b, (1.0 / a_len[eid_b]).astype(np.float32))


def _span_gather(off: np.ndarray, length: np.ndarray) -> np.ndarray:
    """Flat indices covering [off[i], off[i]+length[i]) for each i, concatenated."""
    total = int(length.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    eid = np.repeat(np.arange(length.shape[0]), length)
    cum = np.concatenate(([0], np.cumsum(length)[:-1]))
    within = np.arange(total, dtype=np.int64) - cum[eid]
    return off[eid] + within


def _trim_side(nodes_side: np.ndarray, occurrence: np.ndarray, trim_n: int):
    """Split one side's node list into (high, low) by descending occurrence."""
    if nodes_side.shape[0] <= trim_n:
        return nodes_side, nodes_side[:0]
    occ = occurrence[nodes_side]
    # Deterministic partition: descending occurrence, ties by list position.
    # (The reference's select_nth_unstable is tie-arbitrary; we pin a stable order.)
    order = np.argsort(-occ, kind="stable")
    return nodes_side[order[:trim_n]], nodes_side[order[trim_n:]]


def build_graph(
    lines: Iterable[str],
    columns: str,
    hyperedge_trim_n: int = 16,
    num_workers: Optional[int] = None,  # accepted for API parity; build is deterministic
) -> GraphData:
    cols = parse_fields(columns)
    descriptor = create_relation_descriptor(cols)

    tokens, a_off, a_len, b_off, b_len, reflexive = _tokenize(lines, cols)
    if len(tokens) == 0:
        raise ValueError("No valid hyperedge lines provided")

    # column id per token position (for entity_column_ids)
    ntok = len(tokens)
    token_col_ids = np.zeros(ntok, dtype=np.uint8)
    if not reflexive:
        # B-side token spans belong to column 1
        token_col_ids[_span_gather(b_off, b_len)] = 1

    token_index, entity_ids, entity_hashes, entity_column_ids = _index_entities(
        tokens, token_col_ids
    )
    return _assemble(
        descriptor, token_index, entity_ids, entity_hashes, entity_column_ids,
        a_off, a_len, b_off, b_len, hyperedge_trim_n,
    )


def build_graph_pairs(
    src: np.ndarray,
    dst: np.ndarray,
    columns: str = "complex::reflexive::node",
    hyperedge_trim_n: int = 16,
) -> GraphData:
    """Direct integer-pair ingest: each (src[i], dst[i]) is one reflexive
    2-node hyperedge with entity names str(id) — identical output to
    ``build_graph(f"{s} {d}" for s, d in zip(src, dst))`` without
    materializing the strings.  Names are hashed vectorized over UNIQUE ids
    only, so ingest cost is O(nnz) integer work + O(n) hashing."""
    cols = parse_fields(columns)
    descriptor = create_relation_descriptor(cols)
    if not (len(cols) == 1 and cols[0].reflexive):
        raise ValueError(
            "build_graph_pairs requires a single reflexive column spec"
        )
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError("src and dst must be 1-D arrays of equal length")
    m = src.shape[0]
    if m == 0:
        raise ValueError("No valid hyperedge lines provided")

    stream = np.empty(2 * m, dtype=np.int64)
    stream[0::2] = src
    stream[1::2] = dst

    uniq, first_pos, inverse = np.unique(
        stream, return_index=True, return_inverse=True
    )
    order = np.argsort(first_pos, kind="stable")  # first-seen order
    rank_of_sorted = np.empty_like(order)
    rank_of_sorted[order] = np.arange(order.shape[0])
    token_index = rank_of_sorted[inverse].astype(np.int64)

    ordered_ids = uniq[order]
    entity_ids = [str(v) for v in ordered_ids]
    entity_hashes = hash_entities(entity_ids)
    entity_column_ids = np.zeros(len(entity_ids), dtype=np.uint8)

    offs = np.arange(m, dtype=np.int64) * 2
    lens = np.full(m, 2, dtype=np.int64)
    return _assemble(
        descriptor, token_index, entity_ids, entity_hashes, entity_column_ids,
        offs, lens, offs, lens, hyperedge_trim_n,
    )


def _assemble(
    descriptor, token_index, entity_ids, entity_hashes, entity_column_ids,
    a_off, a_len, b_off, b_len, hyperedge_trim_n,
) -> GraphData:
    """Shared back half of the build: row stats + trimming + clique pairs +
    dedupe-sum + Markov normalization (semantics in the module docstring)."""
    n_entities = len(entity_ids)
    nodes = token_index  # flat dense-index stream, same layout as tokens

    occurrence = np.zeros(n_entities, dtype=np.int64)
    row_sum = np.zeros(n_entities, dtype=np.float32)

    n_edges_in = a_off.shape[0]
    big = (a_len > hyperedge_trim_n) | (b_len > hyperedge_trim_n)

    src_parts: List[np.ndarray] = []
    dst_parts: List[np.ndarray] = []
    val_parts: List[np.ndarray] = []

    if not big.any():
        _apply_row_stats(occurrence, row_sum, nodes, a_off, a_len, b_off, b_len)
        s, d, v = _cartesian_pairs(nodes, a_off, a_len, b_off, b_len)
        src_parts.append(s)
        dst_parts.append(d)
        val_parts.append(v)
    else:
        # Process input-order segments of small hyperedges vectorized,
        # pausing at each big hyperedge to trim with the running occurrence.
        big_positions = np.flatnonzero(big)
        seg_start = 0
        for bp in big_positions:
            if bp > seg_start:
                sl = slice(seg_start, bp)
                _apply_row_stats(
                    occurrence, row_sum, nodes, a_off[sl], a_len[sl], b_off[sl], b_len[sl]
                )
                s, d, v = _cartesian_pairs(nodes, a_off[sl], a_len[sl], b_off[sl], b_len[sl])
                src_parts.append(s)
                dst_parts.append(d)
                val_parts.append(v)
            # the big hyperedge: stats first (reference updates rows before trim)
            sl = slice(bp, bp + 1)
            _apply_row_stats(
                occurrence, row_sum, nodes, a_off[sl], a_len[sl], b_off[sl], b_len[sl]
            )
            na = nodes[a_off[bp] : a_off[bp] + a_len[bp]]
            nb = nodes[b_off[bp] : b_off[bp] + b_len[bp]]
            value = np.float32(1.0 / (a_len[bp] * b_len[bp]))
            a_hi, a_lo = _trim_side(na, occurrence, hyperedge_trim_n)
            b_hi, b_lo = _trim_side(nb, occurrence, hyperedge_trim_n)
            for pa, pb in ((a_hi, b_hi), (a_hi, b_lo), (a_lo, b_hi)):
                if pa.shape[0] and pb.shape[0]:
                    s = np.repeat(pa, pb.shape[0])
                    d = np.tile(pb, pa.shape[0])
                    src_parts.append(s)
                    dst_parts.append(d)
                    val_parts.append(np.full(s.shape[0], value, dtype=np.float32))
            seg_start = bp + 1
        if seg_start < n_edges_in:
            sl = slice(seg_start, n_edges_in)
            _apply_row_stats(
                occurrence, row_sum, nodes, a_off[sl], a_len[sl], b_off[sl], b_len[sl]
            )
            s, d, v = _cartesian_pairs(nodes, a_off[sl], a_len[sl], b_off[sl], b_len[sl])
            src_parts.append(s)
            dst_parts.append(d)
            val_parts.append(v)

    src = np.concatenate(src_parts) if src_parts else np.zeros(0, dtype=np.int64)
    dst = np.concatenate(dst_parts) if dst_parts else np.zeros(0, dtype=np.int64)
    val = np.concatenate(val_parts) if val_parts else np.zeros(0, dtype=np.float32)

    # each pair inserted symmetrically: (a,b) AND (b,a) both get +value
    rows = np.concatenate([src, dst])
    colsx = np.concatenate([dst, src])
    vals = np.concatenate([val, val]).astype(np.float64)

    # dedupe-sum into sorted COO, then CSR
    key = rows.astype(np.uint64) * np.uint64(n_entities) + colsx.astype(np.uint64)
    order = np.argsort(key, kind="stable")
    key_sorted = key[order]
    vals_sorted = vals[order]
    boundary = np.empty(key_sorted.shape[0], dtype=bool)
    if key_sorted.shape[0]:
        boundary[0] = True
        boundary[1:] = key_sorted[1:] != key_sorted[:-1]
    group_starts = np.flatnonzero(boundary)
    uniq_keys = key_sorted[group_starts]
    summed = np.add.reduceat(vals_sorted, group_starts) if group_starts.size else vals_sorted[:0]

    out_rows = (uniq_keys // np.uint64(n_entities)).astype(np.int64)
    out_cols = (uniq_keys - out_rows.astype(np.uint64) * np.uint64(n_entities)).astype(np.int32)

    indptr = np.zeros(n_entities + 1, dtype=np.int64)
    np.add.at(indptr, out_rows + 1, 1)
    np.cumsum(indptr, out=indptr)

    rs64 = row_sum.astype(np.float64)
    left_vals = (summed / rs64[out_rows]).astype(np.float32)
    sym_vals = (summed / np.sqrt(rs64[out_rows] * rs64[out_cols.astype(np.int64)])).astype(
        np.float32
    )

    return GraphData(
        descriptor=descriptor,
        entity_ids=entity_ids,
        entity_hashes=entity_hashes,
        column_ids=entity_column_ids,
        row_sums=row_sum,
        indptr=indptr,
        indices=out_cols,
        left_vals=left_vals,
        sym_vals=sym_vals,
    )
