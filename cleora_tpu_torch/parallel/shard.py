"""Row-partitioned graph shards and the halo exchange plan.

Partitioning scheme (the JAX package's cleora_tpu/parallel/shard.py, whose
cut this module copies so that both packages give shard k the same rows):

* embedding rows are block-partitioned: shard k owns rows
  [k·rows_per_shard, (k+1)·rows_per_shard) of the (padded) N×D matrix, the
  rows padded to a multiple of 8·P (``graph.stream.shard_row_params``);
* every edge lives on the shard that owns its OUTPUT row, so the SpMM's
  accumulation is local;
* the gather side needs remote rows: an all-gather of the row shards, or
  the halo exchange of only the rows each shard reads (:class:`HaloPlan`),
  either in one ``all_to_all`` or in the JAX package's two other forms:
  P-1 pipelined point-to-point rounds (:class:`OverlapPlan`) and the
  two-level exchange of a ("host", "chip") grid (:class:`HierHaloPlan`).

The JAX package's (P, E) padded COO (:class:`ShardedCoo`, ``shard_coo``,
``shard_graph``, ``shard_disk_graph``) is kept for API parity.  The port's
loop reads each shard's edges as a local CSR instead (:class:`ShardedCsr`):
views of the graph's own row-sorted CSR arrays, so a DiskGraph's memmapped
arrays are read one shard at a time and never copied on the host.  Its
column ids point into the gather table: global rows for the all-gather, the
remapped slab slots for the halo exchange.  This follows the port's rule
that CSR replaces the JAX package's ELL, banded and edge-cut layouts
(``band_shards`` and ``ell_shards`` are not ported).  The overlap and
hierarchical plans are bitwise the JAX package's; the overlap plan adds
one compact CSR per round for kernel K19.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

import numpy as np
import torch


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class ShardedCoo:
    """COO partitioned by output-row blocks; all arrays have a leading
    n_shards dimension with equal per-shard sizes (pad included)."""

    local_rows: np.ndarray  # int32 (P, E) — row index LOCAL to the shard
    cols: np.ndarray  # int32 (P, E) — GLOBAL column index into padded N
    vals: np.ndarray  # float32 (P, E) — zero for padding
    n_rows: int  # true (unpadded) number of rows
    n_rows_padded: int
    rows_per_shard: int

    @property
    def n_shards(self) -> int:
        return self.local_rows.shape[0]


def shard_coo(
    rows: np.ndarray,
    cols: np.ndarray,
    vals: np.ndarray,
    n_rows: int,
    n_shards: int,
    row_multiple: int = 8,
    edge_multiple: int = 512,
) -> ShardedCoo:
    """Partition a row-sorted COO matrix into per-shard blocks, each padded
    to the largest shard's edge count with zero-valued edges pointing at
    the shard's last local row."""
    from ..graph.stream import shard_row_params

    n_padded, rows_per_shard = shard_row_params(n_rows, n_shards, row_multiple)

    order = np.argsort(rows, kind="stable")
    rows = np.asarray(rows)[order].astype(np.int64)
    cols = np.asarray(cols)[order].astype(np.int32)
    vals = np.asarray(vals)[order].astype(np.float32)

    boundaries = np.searchsorted(rows, np.arange(1, n_shards) * rows_per_shard)
    row_parts = np.split(rows, boundaries)
    col_parts = np.split(cols, boundaries)
    val_parts = np.split(vals, boundaries)

    max_e = max(p.shape[0] for p in row_parts)
    max_e = round_up(max(max_e, edge_multiple), edge_multiple)

    lr = np.empty((n_shards, max_e), dtype=np.int32)
    cc = np.zeros((n_shards, max_e), dtype=np.int32)
    vv = np.zeros((n_shards, max_e), dtype=np.float32)
    for k in range(n_shards):
        e = row_parts[k].shape[0]
        lr[k, :e] = row_parts[k] - k * rows_per_shard
        lr[k, e:] = rows_per_shard - 1  # padding: last local row, zero value
        cc[k, :e] = col_parts[k]
        vv[k, :e] = val_parts[k]
    return ShardedCoo(
        local_rows=lr,
        cols=cc,
        vals=vv,
        n_rows=n_rows,
        n_rows_padded=n_padded,
        rows_per_shard=rows_per_shard,
    )


def shard_disk_graph(
    dg,
    markov_type: str,
    n_shards: int,
    row_multiple: int = 8,
    edge_multiple: int = 512,
    edge_capacity: int = None,
) -> ShardedCoo:
    """A ShardedCoo straight off a streamed build's ``DiskGraph``, one row
    block at a time.  ``edge_capacity`` overrides the per-shard edge slot
    count (a piece of a sharded build only knows its own shards' counts)."""
    from ..graph.stream import shard_row_bounds, shard_row_params

    n = dg.num_entities
    n_padded, rows_per_shard = shard_row_params(n, n_shards, row_multiple)
    bounds = shard_row_bounds(n, n_shards, row_multiple)
    counts = [int(dg.indptr[bounds[k + 1]] - dg.indptr[bounds[k]])
              for k in range(n_shards)]
    max_e = (int(edge_capacity) if edge_capacity is not None
             else max(max(counts), edge_multiple))
    max_e = round_up(max(max_e, edge_multiple), edge_multiple)

    lr = np.empty((n_shards, max_e), dtype=np.int32)
    cc = np.zeros((n_shards, max_e), dtype=np.int32)
    vv = np.zeros((n_shards, max_e), dtype=np.float32)
    for k in range(n_shards):
        lo, hi = bounds[k], bounds[k + 1]
        e = counts[k]
        if e:
            rows, cols, vals = dg.row_range(lo, hi, markov_type)
            lr[k, :e] = rows - k * rows_per_shard
            cc[k, :e] = cols
            vv[k, :e] = vals
        lr[k, e:] = rows_per_shard - 1  # padding: last local row, zero value
    return ShardedCoo(
        local_rows=lr,
        cols=cc,
        vals=vv,
        n_rows=n,
        n_rows_padded=n_padded,
        rows_per_shard=rows_per_shard,
    )


def shard_graph(graph, markov_type: str, n_shards: int, **kw) -> ShardedCoo:
    """Shard a SparseMatrix's (or DiskGraph's) transition matrix."""
    if not hasattr(graph, "data"):  # streamed build: graph.stream.DiskGraph
        return shard_disk_graph(graph, markov_type, n_shards, **kw)
    data = graph.data
    n = data.num_entities
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(data.indptr))
    vals = data.sym_vals if markov_type == "symmetric" else data.left_vals
    return shard_coo(rows, data.indices, vals, n, n_shards, **kw)


class _ShardSlices(Sequence):
    """``slices[k]`` is shard k's part of one CSR edge array (a view)."""

    def __init__(self, arr: np.ndarray, edge_bounds: List[int]):
        self._arr = arr
        self._eb = edge_bounds

    def __len__(self) -> int:
        return len(self._eb) - 1

    def __getitem__(self, k):
        return self._arr[self._eb[k]:self._eb[k + 1]]


class ShardedCsr:
    """A row-sorted CSR cut into the canonical row blocks, as views.

    ``cols[k]`` and ``vals[k]`` are shard k's edges (views of the graph's
    arrays, memmapped for a DiskGraph) and :meth:`indptr` its local row
    pointer (rows_per_shard + 1, int64, pad rows empty).  Nothing is read
    until a shard's arrays are used."""

    def __init__(self, indptr: np.ndarray, cols: np.ndarray,
                 vals: np.ndarray, n_rows: int, n_shards: int,
                 row_multiple: int = 8):
        from ..graph.stream import shard_row_bounds, shard_row_params

        self.n_rows = int(n_rows)
        self.n_rows_padded, self.rows_per_shard = shard_row_params(
            self.n_rows, n_shards, row_multiple)
        self.bounds = shard_row_bounds(self.n_rows, n_shards, row_multiple)
        self._indptr = indptr
        eb = [int(indptr[b]) if len(indptr) else 0 for b in self.bounds]
        self.cols = _ShardSlices(cols, eb)
        self.vals = _ShardSlices(vals, eb)

    @property
    def n_shards(self) -> int:
        return len(self.bounds) - 1

    def nnz(self, k: int) -> int:
        return len(self.cols[k])

    def indptr(self, k: int) -> np.ndarray:
        """Shard k's local row pointer, int64 (rows_per_shard + 1,)."""
        lo, hi = self.bounds[k], self.bounds[k + 1]
        out = np.empty(self.rows_per_shard + 1, dtype=np.int64)
        if hi > lo:
            seg = np.asarray(self._indptr[lo:hi + 1], dtype=np.int64)
            out[:hi - lo + 1] = seg - seg[0]
            out[hi - lo + 1:] = out[hi - lo]
        else:
            out[:] = 0
        return out


def shard_csr(graph, markov_type: str, n_shards: int) -> ShardedCsr:
    """The :class:`ShardedCsr` of a SparseMatrix's or DiskGraph's Markov
    matrix of ``markov_type`` ("symmetric", else left)."""
    if hasattr(graph, "data"):
        src = graph.data
        n = src.num_entities
    else:  # streamed build: graph.stream.DiskGraph (memmapped arrays)
        src = graph
        n = graph.num_entities
    vals = src.sym_vals if markov_type == "symmetric" else src.left_vals
    return ShardedCsr(src.indptr, src.indices, vals, n, n_shards)


@dataclass
class HaloPlan:
    """Boundary-row exchange plan: who sends which rows to whom.

    The all-gather ships every shard the full (N, D) table each iteration;
    this plan ships only the rows each shard's edges reference.  Send and
    receive slots are padded to the largest per-pair count M so that the
    exchange is one ``all_to_all_single`` of (P, M, D) slabs.
    """

    send_idx: np.ndarray  # int32 (P, P, M): [k, j] = LOCAL rows k sends to j
    # edge cols → receive-slab slots: (P, E) for a ShardedCoo, one array per
    # shard for a ShardedCsr (None for a shard another process plans)
    remapped_cols: Union[np.ndarray, List[Optional[np.ndarray]]]
    M: int  # padded rows per (sender, receiver) pair

    @property
    def table_rows(self) -> int:
        return self.send_idx.shape[0] * self.M


def _need(cols_j: np.ndarray, n_shards: int, rps: int):
    """Sorted unique columns shard j reads, and where each owner's group
    of them starts."""
    uniq = np.unique(cols_j)
    gs = np.searchsorted(uniq // rps, np.arange(n_shards + 1))
    return uniq, gs


def _remap(cols_j: np.ndarray, uniq, gs, rps: int, M: int) -> np.ndarray:
    """Edge col c → slot owner(c)·M + rank of c within its owner group."""
    rank = np.searchsorted(uniq, cols_j)
    owner = np.asarray(cols_j) // rps
    return (owner * M + (rank - gs[owner])).astype(np.int32)


def _fill_send(send, j, uniq, gs, rps):
    for k in range(send.shape[0]):
        rows_needed = uniq[gs[k]:gs[k + 1]] - k * rps
        send[k, j, :len(rows_needed)] = rows_needed


def _stack_like(sharded, per_shard: list):
    """Per-shard int32 arrays as the source's form: (P, E) for a
    ShardedCoo, one array per shard for a ShardedCsr."""
    return np.stack(per_shard) if isinstance(sharded, ShardedCoo) \
        else per_shard


def plan_halo(sharded: Union[ShardedCoo, ShardedCsr]) -> HaloPlan:
    """The halo exchange plan of every shard, in one process."""
    P = len(sharded.cols)
    rps = sharded.rows_per_shard
    needs = [_need(sharded.cols[j], P, rps) for j in range(P)]
    M = max([1] + [int(np.max(np.diff(gs))) for _, gs in needs])
    send_idx = np.zeros((P, P, M), dtype=np.int32)
    remapped = []
    for j, (uniq, gs) in enumerate(needs):
        _fill_send(send_idx, j, uniq, gs, rps)
        remapped.append(_remap(sharded.cols[j], uniq, gs, rps, M))
    return HaloPlan(send_idx=send_idx,
                    remapped_cols=_stack_like(sharded, remapped), M=M)


def plan_halo_distributed(sharded: Union[ShardedCoo, ShardedCsr],
                          mesh) -> HaloPlan:
    """Halo planning when each process reads only its own shard's edges
    (``mesh.rank``; a sharded-build piece holds no others).  ``M`` is an
    all-reduced max, and the need-lists of every shard are all-gathered so
    that each process holds the full (P, P, M) ``send_idx``.  Equal to
    :func:`plan_halo` of the whole graph, except that ``remapped_cols`` is
    filled for the own shard only (zeros, or None for a ShardedCsr, for
    the others)."""
    P = len(sharded.cols)
    if P != mesh.world_size:
        raise ValueError(
            f"{P} shards but the process group has {mesh.world_size} ranks")
    rps = sharded.rows_per_shard
    j = mesh.rank
    uniq, gs = _need(sharded.cols[j], P, rps)
    m = torch.tensor([max(1, int(np.max(np.diff(gs))))], dtype=torch.int64,
                     device=mesh.device)
    if mesh.group is not None:
        import torch.distributed as dist

        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=mesh.group)
    M = int(m.item())
    need = np.zeros((P, 1, M), dtype=np.int32)  # need[k]: rows j reads of k
    _fill_send(need, 0, uniq, gs, rps)
    gathered = mesh.all_gather(
        torch.from_numpy(need.reshape(1, P, M)).to(mesh.device))
    # gathered[j', k] = what j' needs from k, so send_idx[k, j'] is it
    send_idx = np.ascontiguousarray(
        np.swapaxes(gathered.cpu().numpy().reshape(P, P, M), 0, 1))
    mine = _remap(sharded.cols[j], uniq, gs, rps, M)
    if isinstance(sharded, ShardedCoo):
        remapped = np.zeros_like(sharded.cols)
        remapped[j] = mine
    else:
        remapped = [None] * P
        remapped[j] = mine
    return HaloPlan(send_idx=send_idx, remapped_cols=remapped, M=M)


def _local_rows(sharded, j: int) -> np.ndarray:
    """Shard j's local output row of every edge (pads included for a
    ShardedCoo)."""
    if isinstance(sharded, ShardedCoo):
        return sharded.local_rows[j]
    return np.repeat(np.arange(sharded.rows_per_shard, dtype=np.int32),
                     np.diff(sharded.indptr(j))).astype(np.int32)


@dataclass
class RoundCsr:
    """One overlap round's edges of one shard as a compact CSR: local row
    ``row_ids[i]`` (ascending) sums ``vals[e]·table[cols[e]]`` over
    ``e`` in ``[indptr[i], indptr[i+1])``.  Only rows with an edge in the
    round appear."""

    row_ids: np.ndarray  # int32 (R,)
    indptr: np.ndarray  # int64 (R + 1,)
    cols: np.ndarray  # int32 (E_r,) — the round's table rows
    vals: np.ndarray  # float32 (E_r,)

    @classmethod
    def from_edges(cls, lrows: np.ndarray, cols: np.ndarray,
                   vals: np.ndarray) -> "RoundCsr":
        """From a round's edges in ascending local-row order."""
        row_ids, counts = np.unique(lrows, return_counts=True)
        indptr = np.zeros(len(row_ids) + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return cls(row_ids.astype(np.int32), indptr,
                   np.ascontiguousarray(cols, dtype=np.int32),
                   np.ascontiguousarray(vals, dtype=np.float32))


@dataclass
class OverlapPlan:
    """Per-round edge groups of the overlapped halo exchange
    (cleora_tpu/parallel/shard.py:OverlapPlan).

    The all_to_all of boundary rows becomes P-1 point-to-point rounds: in
    round r shard d sends the slab for peer (d+r) mod P and receives the
    one from (d-r) mod P, while it accumulates the previous round's edges.

    ``groups[r] = (local_rows, cols, vals)``, each (P, E_r), bitwise the
    JAX package's: shard d's edges (zero values dropped) whose column
    owner is (d - r) mod P, padded with (rps - 1, 0, 0.0) to a multiple of
    8.  Round 0's cols index the shard's own rows, later rounds' the
    received slab [0, M).  ``rounds[d][r]`` is the same edges as a
    :class:`RoundCsr`, without the padding, for kernel K19.
    """

    send_idx: np.ndarray  # int32 (P, P, M): [k, j] = LOCAL rows k sends to j
    M: int
    groups: tuple  # per round r: (lrows (P,E_r), cols (P,E_r), vals (P,E_r))
    rounds: list  # rounds[d][r]: RoundCsr


def plan_overlap(sharded: Union[ShardedCoo, ShardedCsr],
                 halo: Optional[HaloPlan] = None) -> OverlapPlan:
    """Group each shard's edges by column owner for the pipelined exchange
    (needs every shard's edges, as in the JAX package)."""
    if halo is None:
        halo = plan_halo(sharded)
    P = len(sharded.cols)
    rps = sharded.rows_per_shard
    M = halo.M
    picks = [[None] * P for _ in range(P)]  # picks[r][j]
    rounds = [[None] * P for _ in range(P)]  # rounds[j][r]
    for j in range(P):
        cols_j = np.asarray(sharded.cols[j])
        vals_j = np.asarray(sharded.vals[j])
        lrows_j = _local_rows(sharded, j)
        owner = (cols_j // rps).astype(np.int64)
        slot = (np.asarray(halo.remapped_cols[j]) % M).astype(np.int32)
        real = vals_j != 0.0
        for r in range(P):
            m = real & (owner == (j - r) % P)
            sc = ((cols_j[m] - j * rps).astype(np.int32) if r == 0
                  else slot[m])
            picks[r][j] = (lrows_j[m], sc, vals_j[m])
            rounds[j][r] = RoundCsr.from_edges(*picks[r][j])
    groups = []
    for r in range(P):
        e_r = round_up(max(1, max(p[0].shape[0] for p in picks[r])), 8)
        lrows = np.full((P, e_r), rps - 1, dtype=np.int32)
        cols = np.zeros((P, e_r), dtype=np.int32)
        vals = np.zeros((P, e_r), dtype=np.float32)
        for j, (lr, sc, sv) in enumerate(picks[r]):
            lrows[j, :lr.shape[0]] = lr
            cols[j, :lr.shape[0]] = sc
            vals[j, :lr.shape[0]] = sv
        groups.append((lrows, cols, vals))
    return OverlapPlan(send_idx=halo.send_idx, M=M, groups=tuple(groups),
                       rounds=rounds)


@dataclass
class HierHaloPlan:
    """The two-level boundary-row exchange of a ("host", "chip") grid
    (cleora_tpu/parallel/shard.py:HierHaloPlan): a chip-axis all_to_all
    of the intra-host slabs, a host-axis all_to_all of per-destination-host
    UNION slabs (a row that several chips of one host read crosses hosts
    once), then a chip-axis all_gather that fans the cross-host slabs out
    within the host.  Receive table per shard: [intra C·Mc rows | cross
    C·H·Mh rows], cross slot (c_owner·H + h_owner)·Mh + rank;
    ``remapped_cols`` point the edges into it.
    """

    send_intra: np.ndarray  # int32 (P, C, Mc): rows k sends to same-host chip c
    send_cross: np.ndarray  # int32 (P, H, Mh): union rows k sends to host h
    # edge cols → receive-table slots: (P, E) for a ShardedCoo, one array
    # per shard for a ShardedCsr
    remapped_cols: Union[np.ndarray, List[np.ndarray]]
    Mc: int
    Mh: int
    n_hosts: int
    chips_per_host: int

    @property
    def table_rows(self) -> int:
        C, H = self.chips_per_host, self.n_hosts
        return C * self.Mc + C * H * self.Mh


def plan_halo_hier(sharded: Union[ShardedCoo, ShardedCsr], n_hosts: int,
                   chips_per_host: int) -> HierHaloPlan:
    """The two-level exchange plan (host-major shard order: shard k =
    host·C + chip, as :func:`.mesh.make_hier_mesh` numbers the ranks);
    needs every shard's edges, as in the JAX package."""
    P = len(sharded.cols)
    H, C = int(n_hosts), int(chips_per_host)
    if H * C != P:
        raise ValueError(f"mesh {H}x{C} != {P} shards")
    rps = sharded.rows_per_shard
    uniq_j = [np.unique(sharded.cols[j]) for j in range(P)]

    # cross need: union over the destination host's chips, per owner shard
    cross_need = {}
    for h in range(H):
        allcols = np.unique(np.concatenate(
            [uniq_j[j] for j in range(h * C, (h + 1) * C)]))
        gs = np.searchsorted(allcols // rps, np.arange(P + 1))
        for k in range(P):
            if k // C != h:
                cross_need[(k, h)] = allcols[gs[k]:gs[k + 1]] - k * rps
    Mh = max(1, max((len(v) for v in cross_need.values()), default=1))

    # intra need: per (same-host owner, destination chip)
    intra_need = {}
    for j in range(P):
        u = uniq_j[j]
        gs = np.searchsorted(u // rps, np.arange(P + 1))
        for c in range(C):
            k = (j // C) * C + c
            intra_need[(k, j)] = u[gs[k]:gs[k + 1]] - k * rps
    Mc = max(1, max(len(v) for v in intra_need.values()))

    send_intra = np.zeros((P, C, Mc), dtype=np.int32)
    for (k, j), rv in intra_need.items():
        send_intra[k, j % C, :len(rv)] = rv
    send_cross = np.zeros((P, H, Mh), dtype=np.int32)
    for (k, h), rv in cross_need.items():
        send_cross[k, h, :len(rv)] = rv

    remapped = []
    for j in range(P):
        hj = j // C
        cols_j = np.asarray(sharded.cols[j]).astype(np.int64)
        owner = cols_j // rps
        local = cols_j - owner * rps
        out = np.empty(len(cols_j), dtype=np.int64)
        for k in range(P):
            m = owner == k
            if not m.any():
                continue
            if k // C == hj:
                out[m] = ((k % C) * Mc
                          + np.searchsorted(intra_need[(k, j)], local[m]))
            else:
                out[m] = (C * Mc + ((k % C) * H + k // C) * Mh
                          + np.searchsorted(cross_need[(k, hj)], local[m]))
        remapped.append(out.astype(np.int32))
    return HierHaloPlan(
        send_intra=send_intra, send_cross=send_cross,
        remapped_cols=_stack_like(sharded, remapped), Mc=Mc, Mh=Mh,
        n_hosts=H, chips_per_host=C,
    )


def local_shard_degrees(sharded: ShardedCoo) -> np.ndarray:
    """(P, rps) per-shard local-row degree counts from real edges."""
    P, _ = sharded.local_rows.shape
    rps = sharded.rows_per_shard
    deg = np.zeros((P, rps), dtype=np.int64)
    real = sharded.vals != 0.0
    for k in range(P):
        deg[k] = np.bincount(sharded.local_rows[k][real[k]], minlength=rps)
    return deg


def pad_rows(x: np.ndarray, n_rows_padded: int) -> np.ndarray:
    """Zero-pad embedding rows up to the sharded row count."""
    n, d = x.shape
    if n == n_rows_padded:
        return np.asarray(x, dtype=np.float32)
    out = np.zeros((n_rows_padded, d), dtype=np.float32)
    out[:n] = x
    return out
