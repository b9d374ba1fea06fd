"""The walk pipeline's PPMI factorization over the shard group.

The port of cleora_tpu/parallel/cooccur.py.  Rank-parallel counting
(``ops/cooccur.py:device_pair_counts`` under a group) leaves hash partition
``s`` on rank ``s % P``; here each rank turns its own partitions into PPMI
rows and the randomized SVD runs where the counts lie: every rank holds
only its partitions' entries (the part that grows with the corpus) and the
(n, r) panels, which every rank repeats.

Parity with the one-card factorization
(``algorithms._device_counts_to_embeddings``): the same PPMI with the
column sums and the pair total of every rank (exact int64 sums all-reduced;
the JAX package sums float64 partials on the host and casts them to
float32, the same float32 values while the counts stay below 2⁵³), the
same host omega (``default_rng(seed ^ 0x5EED)``), and the same subspace
iteration whose product is each rank's K1/K5 over its pieces followed by
one all-reduce of the (n, r) partial: the partitions are row-disjoint, so
every row of the sum has one nonzero term and the product is the one-card
product bit for bit.  QR, SVD and the exit are repeated on every rank.

The JAX package pads every range to one stacked shape for ``shard_map``
(``_align_jit``); the per-range CSRs need no common length.
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import ShardGroup


def home_ranges(ranges, group: ShardGroup):
    """Every partition on every rank, in partition order: partition ``s``
    is the ``s // P``-th range of rank ``s % P`` (``device_pair_counts``'s
    placement), sent from there with one broadcast of its entries."""
    world = group.world_size
    if world == 1:
        return list(ranges)
    dev = group.device
    counts = group.all_gather(torch.tensor([len(ranges)], dtype=torch.int64,
                                           device=dev)).tolist()
    passes = int(sum(counts))
    sizes = torch.zeros((passes,), dtype=torch.int64, device=dev)
    for i, r in enumerate(ranges):
        sizes[i * world + group.rank] = r[3]
    sizes = group.all_reduce_(sizes).tolist()
    out = []
    for s, m in enumerate(sizes):
        owner = s % world
        buf = torch.empty((3, int(m)), dtype=torch.int32, device=dev)
        if owner == group.rank:
            cen, ctx, cnt, _ = ranges[s // world]
            buf[0], buf[1], buf[2] = cen, ctx, cnt
        group.broadcast_(buf, owner)
        out.append((buf[0], buf[1], buf[2], int(m)))
    return out


def sharded_counts_to_embeddings(ranges, m_total, n, feature_dim, seed,
                                 oversample=16, power_iters=4, out=None,
                                 group: ShardGroup = None):
    """PPMI + randomized SVD over count ranges that stay on the ranks that
    counted them (``ranges``: this rank's, consumed).  Every rank returns the
    finalized (n, feature_dim) float32 embedding; with ``out`` rank 0
    streams it into one ``.npy`` and every rank returns its read-only
    memmap."""
    from ..algorithms import (_finalize, _finalize_factor, _pipeline_fit,
                              _write_npy)
    from ..ops.cooccur import ppmi_transform, range_col_sums
    from ..ops.dense import _apply_pieces, rsvd_apply
    from ..ops.spmm import CsrMatrix

    dev = group.device
    k = min(feature_dim, n - 1)
    root = group.rank == 0
    if m_total == 0 or k < 1:
        empty = _finalize(np.zeros((n, 1), dtype=np.float64), feature_dim)
        if out is None:
            return empty
        if root:
            _write_npy(empty, out)
        group.barrier()
        return np.load(out, mmap_mode="r")
    r = min(n, k + oversample)
    # capacity is per rank: the entries shard, the panels repeat
    _pipeline_fit(n, r, sum(int(c.shape[0]) for c, _, _, _ in ranges), dev,
                  "more ranks (more counting partitions spread the counts), "
                  "fewer walks, or a smaller window all shrink the per-rank "
                  "footprint.")
    # ---- global statistics: contexts span every rank's partitions
    col, total = range_col_sums(ranges, n, dev)
    group.all_reduce_(col)
    group.all_reduce_(total)
    # consumes ``ranges`` (the caller's list empties), as the one-card path
    pieces = [CsrMatrix(indptr, cols, vals) for _, cols, vals, indptr
              in ppmi_transform(ranges, n, col, total)]
    del col, total

    def apply(x):
        if pieces:
            y = _apply_pieces(pieces, x)
        else:
            y = torch.zeros((n, x.shape[1]), dtype=torch.float32, device=dev)
        return group.all_reduce_(y)

    rng = np.random.default_rng(seed ^ 0x5EED)
    omega = torch.from_numpy(
        rng.standard_normal((n, r)).astype(np.float32)).to(dev)
    u_su = rsvd_apply(apply, k, omega, power_iters)
    del omega, pieces
    if out is None:
        return _finalize_factor(u_su, feature_dim, None)
    if root:
        _finalize_factor(u_su, feature_dim, out)
    group.barrier()
    return np.load(out, mmap_mode="r")
