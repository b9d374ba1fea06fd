"""Random walks on the device: first-order uniform and second-order p/q.

Counterpart of the JAX package's walk engines (cleora_tpu/algorithms.py
``_device_walk_jit``, :1122-1155, with the batch loop ``_device_walks``,
:1318-1373; ``_device_walk2_jit``, :1768-1963, with ``_device_walks2``,
:1989-2063).  Each hop of a first-order walk moves to a uniformly drawn
out-neighbour of the current node in the self-loop-free walk CSR,
``cols[indptr[cur] + min(int(u·float(deg)), deg-1)]``; a walk that reaches a
node of degree 0 emits the sentinel ``n`` from then on, and a lane that
starts at ``n`` (a pad lane) stays there.  The second-order (Node2Vec)
walk samples its next hop with probability ∝ ``w(cur→x)·α`` by composition
and rejection (see :func:`walk_p_q_plain`).

The uniforms come from Philox4x32-10 (Salmon et al., SC'11), a
counter-based generator keyed by the seed with the counter (global walk
index, hop), so the walks depend on neither the batch size nor the device.
On CUDA :func:`walk_uniform` launches kernel K8
(``kernels/walk_uniform.cu``) and :func:`walk_p_q` kernel K12
(``kernels/walk_p_q.cu``); on the CPU :func:`walk_uniform_plain` and
:func:`walk_p_q_plain` reproduce them bit for bit, emulating the
32×32→64-bit products on int64 words as ``ops/init.py`` does.
``jax.random`` streams cannot be reproduced, so the JAX package's walks
are matched in distribution only.

Over a shard group (``parallel.ShardGroup``) the walks stay these walks,
bit for bit: over replicated tables each rank walks a block of lanes
(:func:`device_walks` with ``group``); over tables cut by rows
(:class:`ShardedWalkTables`, the JAX package's ``_device_walk_sharded_jit``
and ``_device_walk2_sharded_jit``, cleora_tpu/algorithms.py:1380, :1574)
the rank that owns a lane's row computes its hops (kernel K17,
``kernels/walk_owned.cu``: a round walks each lane through the hops whose
rows one slice owns; for the p/q walk kernel K18,
``kernels/walk2_owned.cu``: a hop in one launch where one slice owns both
rows, rejection rounds in chunks across owners), every other rank writes
0, and an all-reduce combines the shares.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

from .. import kernels
from .init import _M32, _mul32

# Philox4x32 round multipliers and Weyl key increments (Random123)
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85

# Walks per device batch (cleora_tpu/algorithms.py:_WALK_BATCH): bounds the
# (B, L) walk matrix and, under device counting, the pair keys of a batch.
WALK_BATCH = 262_144


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 of the counter words ``c0..c3`` (int64 tensors holding
    values in [0, 2³²), broadcast together) under the key ``(k0, k1)``.
    Returns the four output words as int64 tensors."""
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W0) & _M32
            k1 = (k1 + _PHILOX_W1) & _M32
        lo0, hi0 = _mul32(c0, _PHILOX_M0)
        lo1, hi1 = _mul32(c2, _PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _key(seed: int) -> Tuple[int, int]:
    s = int(seed) & ((1 << 64) - 1)
    return s & _M32, s >> 32


def _unit_float(word: torch.Tensor) -> torch.Tensor:
    """``(word >> 8)·2⁻²⁴``: a float32 in [0, 1), exact."""
    return (word >> 8).to(torch.float32) * (2.0 ** -24)


def hop_uniform(walk_index: torch.Tensor, hop, seed: int) -> torch.Tensor:
    """The float32 uniform in [0, 1) of hop ``hop`` (an int, or an int64
    tensor of each lane's hop) of the walks with global indices
    ``walk_index`` (int64): ``(x0 >> 8)·2⁻²⁴`` of Philox4x32-10 at counter
    (index low word, index high word, hop, 0)."""
    k0, k1 = _key(seed)
    zero = torch.zeros_like(walk_index)
    x0 = philox4x32(walk_index & _M32, walk_index >> 32, zero + hop, zero,
                    k0, k1)[0]
    return _unit_float(x0)


def round_uniforms(walk_index: torch.Tensor, hop: int, rnd: int, seed: int):
    """The three float32 uniforms of rejection round ``rnd`` (0-based) of
    hop ``hop`` of the second-order walks with global indices
    ``walk_index``: words x0, x1, x2 of Philox4x32-10 at counter (index low
    word, index high word, hop, rnd + 1), each as ``(x >> 8)·2⁻²⁴``.  The
    fourth counter word is never 0, so the stream is apart from
    :func:`hop_uniform`'s."""
    k0, k1 = _key(seed)
    zero = torch.zeros_like(walk_index)
    x0, x1, x2, _ = philox4x32(walk_index & _M32, walk_index >> 32,
                               zero + hop, zero + (rnd + 1), k0, k1)
    return _unit_float(x0), _unit_float(x1), _unit_float(x2)


def walk_uniform(t: "WalkTables", starts: torch.Tensor, walk_length: int,
                 seed: int, base: int) -> torch.Tensor:
    """(B, walk_length) int32 walks from int32 ``starts`` (lane b is the
    walk of global index ``base + b``) over the tables ``t``.  On CUDA this
    launches K8 on ``t.record`` and ``t.cols``; on the CPU it runs
    :func:`walk_uniform_plain` on the three arrays."""
    if starts.is_cuda:
        return kernels.walk_uniform(t.record, t.cols, starts, walk_length,
                                    seed, base, t.n)
    return walk_uniform_plain(t.indptr, t.cols, t.deg, starts, walk_length,
                              seed, base, t.n)


def walk_uniform_plain(indptr: torch.Tensor, cols: torch.Tensor,
                       deg: torch.Tensor, starts: torch.Tensor,
                       walk_length: int, seed: int, base: int,
                       n: int) -> torch.Tensor:
    """Plain PyTorch version of K8: the hops as one vector step over all
    lanes each, with K8's arithmetic (a round-to-nearest float32 product,
    then truncation)."""
    dev = starts.device
    index = base + torch.arange(starts.shape[0], dtype=torch.int64,
                                device=dev)
    cur = starts.to(torch.int32)
    steps = [cur]
    for hop in range(walk_length - 1):
        live = (cur >= 0) & (cur < n)
        at = torch.where(live, cur, torch.zeros_like(cur)).long()
        d = torch.where(live, deg[at], torch.zeros_like(cur))
        u = hop_uniform(index, hop, seed)
        t = torch.minimum((u * d.to(torch.float32)).to(torch.int32), d - 1)
        step = indptr[at].long() + t.clamp_min(0).long()
        nxt = cols[step.clamp_max(max(cols.shape[0] - 1, 0))] \
            if cols.shape[0] else torch.zeros_like(cur)
        cur = torch.where(d > 0, nxt, torch.full_like(cur, n))
        steps.append(cur)
    return torch.stack(steps, dim=1)


def _check_csr(indptr: np.ndarray, cols: np.ndarray, deg: np.ndarray,
               n: int) -> None:
    """Raise ValueError unless every row ``indptr[i] : indptr[i] + deg[i]``
    lies inside ``cols`` and every column is a node below ``n``."""
    if indptr.size and (np.any(deg < 0) or np.any(indptr < 0) or np.any(
            indptr.astype(np.int64) + deg > cols.shape[0])):
        raise ValueError("malformed walk CSR: row outside cols")
    if cols.size and (cols.min() < 0 or cols.max() >= n):
        raise ValueError("malformed walk CSR: column index out of range")


def _check_sorted_rows(indptr: np.ndarray, cols: np.ndarray,
                       deg: np.ndarray) -> None:
    """Raise ValueError unless each row's columns are ascending (the
    second-order walks' binary searches need it)."""
    # positions i with i and i + 1 in one row: cols[i] <= cols[i + 1]
    deg = np.asarray(deg, dtype=np.int64)
    pairs = np.maximum(deg - 1, 0)
    first = np.repeat(np.asarray(indptr, dtype=np.int64), pairs)
    within = np.arange(first.shape[0]) - np.repeat(
        np.cumsum(pairs) - pairs, pairs)
    pos = first + within
    cols = np.asarray(cols)
    if np.any(cols[pos + 1] < cols[pos]):
        raise ValueError("malformed walk CSR: each row's columns must "
                         "be sorted")


class WalkTables:
    """The walk CSR on one device: int32 row starts ``indptr`` (n,), column
    ids ``cols`` (nnz,) and degrees ``deg`` (n,), and K8's 8-byte record a
    row, ``record`` (``kernels.walk_record``: the row's ``indptr`` and
    ``deg`` in one int32 (n, 2) tensor), validated once so that K8 can
    trust every offset it gathers."""

    def __init__(self, indptr: np.ndarray, cols: np.ndarray, deg: np.ndarray,
                 n: int, device):
        indptr = np.ascontiguousarray(indptr, dtype=np.int32)
        cols = np.ascontiguousarray(cols, dtype=np.int32)
        deg = np.ascontiguousarray(deg, dtype=np.int32)
        n = int(n)
        if indptr.shape != (n,) or deg.shape != (n,):
            raise ValueError("malformed walk CSR: indptr/deg need n entries")
        _check_csr(indptr, cols, deg, n)
        self.n = n
        self.indptr = torch.from_numpy(indptr).to(device)
        self.cols = torch.from_numpy(cols).to(device)
        self.deg = torch.from_numpy(deg).to(device)
        self.record = kernels.walk_record(self.indptr, self.deg)

    @property
    def device(self) -> torch.device:
        return self.indptr.device


def device_walks(tables, starts: np.ndarray, num_walks: int,
                 walk_length: int, seed: int, batch: int = WALK_BATCH,
                 resident: bool = False, group=None) -> Iterator:
    """Walks from every node of ``starts`` (int32, the nodes of degree > 0),
    ``num_walks`` rounds in the JAX package's order
    (``tile(starts, num_walks)``), in batches of at most ``batch`` walks.

    Yields int32 (B, walk_length) host arrays, or with ``resident=True``
    ``(walks, pad)`` with the walks left on the device.  PyTorch has no
    static shapes to keep, so a short last batch is not padded and ``pad``
    is always 0; consumers still honour the JAX contract's pad lanes.
    ``tables`` is a :class:`WalkTables` (under ``group`` each rank walks a
    block of lanes) or this rank's :class:`ShardedWalkTables` (owner-routed
    hops); every rank yields the same batches."""
    t = tables
    if isinstance(t, ShardedWalkTables):
        def launch(chunk, lo):
            return walk_uniform_sharded([t], chunk, walk_length, seed, lo,
                                        group)
    else:
        def launch(chunk, lo):
            return walk_uniform(t, chunk, walk_length, seed, lo)
        if group is not None:
            launch = _lane_blocks(launch, t.n, group)
    yield from _walk_batches(t.device, starts, num_walks, batch, resident,
                             launch)


def _walk_batches(device, starts: np.ndarray, num_walks: int, batch: int,
                  resident: bool, launch) -> Iterator:
    """``launch(starts_chunk, base)`` over ``tile(starts, num_walks)`` in
    chunks of at most ``batch`` walks; yields host arrays, or
    ``(walks, 0)`` left on the device with ``resident=True``."""
    all_starts = np.tile(np.asarray(starts, dtype=np.int32), num_walks)
    for lo in range(0, all_starts.shape[0], batch):
        out = launch(torch.from_numpy(all_starts[lo:lo + batch]).to(device),
                     lo)
        yield (out, 0) if resident else out.cpu().numpy()


# ------------------------------------------------------- second-order walks
# base rejection-proposal budget per hop and its cap
# (cleora_tpu/algorithms.py:1966-1971)
WALK2_TRIES = 64
WALK2_TRIES_CAP = 1024


def walk2_tries(q: float) -> int:
    """The proposals per hop (cleora_tpu/algorithms.py:2014-2015): the
    composition sampler's acceptance depends on neither p nor q below 1, so
    the budget grows only for q ≫ 1, ``min(1024, max(64, ⌈8q⌉))``."""
    return int(min(WALK2_TRIES_CAP, max(WALK2_TRIES, np.ceil(8.0 * q))))


def walk_p_q(t: "WalkTables2", starts: torch.Tensor, walk_length: int,
             inv_p: float, inv_q: float, tries: int, seed: int,
             base: int) -> torch.Tensor:
    """(B, walk_length) int32 second-order walks from int32 ``starts``
    (lane b is the walk of global index ``base + b``) over the tables
    ``t``.  On CUDA this launches K12 on ``t.head``, ``t.cols`` and
    ``t.vals``; on the CPU it runs :func:`walk_p_q_plain` on the four
    arrays."""
    if starts.is_cuda:
        return kernels.walk_p_q(t.head, t.cols, t.vals, starts, walk_length,
                                inv_p, inv_q, tries, seed, base, t.n)
    return walk_p_q_plain(t.indptr, t.cols, t.vals, t.deg, t.wmax, t.wsum,
                          starts, walk_length, inv_p, inv_q, tries, seed,
                          base, t.n)


def _row_search(indptr: torch.Tensor, cols: torch.Tensor, deg: torch.Tensor,
                rows: torch.Tensor, x: torch.Tensor):
    """``(found, position)`` of each ``x`` in the sorted column slice of its
    row, ``cols[indptr[r] : indptr[r] + deg[r]]``: a lower-bound binary
    search that stops on ``lo < hi`` (``rows`` int64, valid).  A range of
    L entries closes within ``L.bit_length()`` steps, so the longest row
    sets the step count (one host read, not one a step)."""
    lo = indptr[rows].long()
    end = lo + deg[rows].long()
    hi = end.clone()
    last = cols.shape[0] - 1
    longest = int((end - lo).max()) if end.numel() else 0
    for _ in range(longest.bit_length()):
        active = lo < hi
        mid = (lo + hi) // 2
        right = active & (cols[mid.clamp(0, last)] < x)
        lo = torch.where(right, mid + 1, lo)
        hi = torch.where(active & ~right, mid, hi)
    found = (lo < end) & (cols[lo.clamp(0, last)] == x)
    return found, lo


def walk_p_q_plain(indptr: torch.Tensor, cols: torch.Tensor,
                   vals: torch.Tensor, deg: torch.Tensor, wmax: torch.Tensor,
                   wsum: torch.Tensor, starts: torch.Tensor, walk_length: int,
                   inv_p: float, inv_q: float, tries: int, seed: int,
                   base: int, n: int) -> torch.Tensor:
    """Plain PyTorch version of K12, the Node2Vec p/q walk of
    ``_device_walk2_jit`` (cleora_tpu/algorithms.py:1768-1963).

    Uniform first hop, then the next hop with probability ∝
    ``w(cur→x)·α``: α = 1/p for ``x == prev``, 1 for a common neighbour of
    ``prev`` and ``cur``, 1/q otherwise.  Sampled by composition +
    rejection: the backtrack edge is an exact point mass ``w_bt =
    vals[pos(prev in row cur)]·inv_p`` taken with probability
    ``π = w_bt / max(env, 1e-30)``,
    ``env = w_bt + d·wmax[cur]·m2``, ``m2 = max(1, inv_q)``; otherwise a
    uniform proposal ``x`` is accepted with ``w·α2 / max(wmax·m2, 1e-30)``
    (α2 = 0 for ``x == prev``).  After ``tries`` rounds the last uniform
    proposal is taken.  A row with ``wsum·m2 + w_bt < 1e-15``, a dead end
    or a pad lane emits the sentinel ``n`` from then on.

    Every hop is one vector step over all lanes and the rounds a loop over
    the lanes still rejecting, with K12's float32 operations in K12's order
    and the same Philox uniforms (:func:`round_uniforms`), so the walks are
    bitwise K12's whatever the batch."""
    dev = starts.device
    index = base + torch.arange(starts.shape[0], dtype=torch.int64,
                                device=dev)
    tables = (indptr, cols, vals, deg, wmax, wsum)
    cur = starts.to(torch.int32)
    prev = torch.full_like(cur, n)
    steps = [cur]
    for hop in range(walk_length - 1):
        nxt = torch.full_like(cur, n)
        valid = (cur >= 0) & (cur < n)
        if cols.shape[0] and bool(valid.any()):
            at = torch.where(valid, cur, torch.zeros_like(cur)).long()
            first = ~((prev >= 0) & (prev < n))
            prev_at = torch.where(first, torch.zeros_like(prev), prev).long()
            head = _hop_head(tables, at, prev, first, inv_p, inv_q)
            _hop_rounds(tables, head, valid, at, prev, prev_at, first, index,
                        hop, inv_q, tries, seed, n, nxt)
        prev, cur = cur, nxt
        steps.append(cur)
    return torch.stack(steps, dim=1)


def _f32(*values, device) -> torch.Tensor:
    """0-d float32 operands, so that every product, sum and comparison with
    them stays float32."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def _hop_terms(d, wm, w_bt, inv_q: float):
    """``(π, cap)`` of a hop from its degree, ``wmax`` and backtrack weight
    (walk2_hop.cuh ``hop_terms``)."""
    env_floor, one, inv_q = _f32(1e-30, 1.0, inv_q, device=d.device)
    m2 = torch.maximum(one, inv_q)
    env = w_bt + (d.to(torch.float32) * wm) * m2
    return (w_bt / torch.maximum(env, env_floor),
            torch.maximum(wm * m2, env_floor))


def _hop_head(tables, at, prev, first, inv_p: float, inv_q: float) -> dict:
    """The head of a hop from the rows ``at`` (int64, valid) of ``tables``
    (walk2_hop.cuh ``hop_head``; ``cols`` not empty): degree ``d``, ``wm``,
    the backtrack weight ``w_bt`` (0 on the first hop) and ``dead``."""
    indptr, cols, vals, deg, wmax, wsum = tables
    zero, inv_p_t, dead_floor, one, inv_q_t = _f32(
        0.0, inv_p, 1e-15, 1.0, inv_q, device=at.device)
    d = deg[at]
    wm = wmax[at]
    prev_c = torch.where(first, torch.zeros_like(prev), prev).long()
    found, pos = _row_search(indptr, cols, deg, at, prev_c)
    w_bt = torch.where(found & ~first,
                       vals[pos.clamp(0, cols.shape[0] - 1)] * inv_p_t, zero)
    dead = wsum[at] * torch.maximum(one, inv_q_t) + w_bt < dead_floor
    return {"d": d, "wm": wm, "w_bt": w_bt, "dead": dead}


def _hop_rounds(tables, head: dict, live, at, prev, prev_at, first, index,
                hop: int, inv_q: float, tries: int, seed: int, n: int,
                nxt: torch.Tensor) -> None:
    """K12's rejection rounds (walk2_hop.cuh ``hop``) for the ``live``
    lanes whose row ``at`` has degree > 0 and is not dead; writes their
    next node into ``nxt``.  ``prev_at`` is ``prev``'s row in ``tables``
    (read only for lanes that are not ``first``)."""
    indptr, cols, vals, deg, _, _ = tables
    d, wm = head["d"], head["wm"]
    pi, cap = _hop_terms(d, wm, head["w_bt"], inv_q)
    zero, one, inv_q_t = _f32(0.0, 1.0, inv_q, device=at.device)
    pending = torch.nonzero(live & (d > 0) & ~head["dead"]).squeeze(1)
    for rnd in range(tries):
        if pending.numel() == 0:
            break
        u0, u1, u2 = round_uniforms(index[pending], hop, rnd, seed)
        e = _proposal(indptr, d[pending], at[pending], u1)
        x = cols[e]
        fp, pp = first[pending], prev[pending]
        is_bt = ~fp & (u0 < pi[pending])
        common, _ = _row_search(indptr, cols, deg, prev_at[pending],
                                x.long())
        alpha2 = torch.where(x == pp, zero, torch.where(common, one, inv_q_t))
        p_acc = torch.where(fp, one, (vals[e] * alpha2) / cap[pending])
        hit = is_bt | (u2 < p_acc)
        if rnd == tries - 1:
            hit = torch.ones_like(hit)
        take = torch.where(is_bt, pp, x)
        nxt[pending[hit]] = take[hit]
        pending = pending[~hit]


def _proposal(indptr, d, at, u1) -> torch.Tensor:
    """The entry of a round's proposal, ``indptr[at] + min(int(u1·d),
    d − 1)`` (int64), clamped to 0 where ``d`` is 0."""
    j = torch.minimum((u1 * d.to(torch.float32)).to(torch.int32), d - 1)
    return indptr[at].long() + j.clamp_min(0).long()


class WalkTables2(WalkTables):
    """The weighted walk CSR on one device for the second-order walk: the
    tables of :class:`WalkTables` plus float32 edge weights ``vals``
    (nnz,) and the per-row max ``wmax`` and sum ``wsum`` (n,), and K12's
    16-byte head record a row, ``head`` (``kernels.walk_head``: the row's
    ``indptr``, ``deg``, ``wmax`` and ``wsum`` in one int32 (n, 4) tensor).
    Validated once: K12 trusts every offset, and its lookups need each
    row's columns in ascending order."""

    def __init__(self, indptr: np.ndarray, cols: np.ndarray, deg: np.ndarray,
                 n: int, vals: np.ndarray, wmax: np.ndarray, wsum: np.ndarray,
                 device):
        super().__init__(indptr, cols, deg, n, device)
        vals = np.ascontiguousarray(vals, dtype=np.float32)
        wmax = np.ascontiguousarray(wmax, dtype=np.float32)
        wsum = np.ascontiguousarray(wsum, dtype=np.float32)
        if vals.shape != (self.cols.shape[0],) or wmax.shape != (self.n,) \
                or wsum.shape != (self.n,):
            raise ValueError("malformed walk CSR: vals need one entry per "
                             "column, wmax/wsum one per node")
        _check_sorted_rows(indptr, cols, deg)
        self.vals = torch.from_numpy(vals).to(device)
        self.wmax = torch.from_numpy(wmax).to(device)
        self.wsum = torch.from_numpy(wsum).to(device)
        self.head = kernels.walk_head(self.indptr, self.deg, self.wmax,
                                      self.wsum)


def device_walks2(tables, starts: np.ndarray, num_walks: int,
                  walk_length: int, p: float, q: float, tries: int, seed: int,
                  batch: int, resident: bool = False,
                  group=None) -> Iterator:
    """Second-order walks from every node of ``starts`` in the JAX
    package's order (``tile(starts, num_walks)``), in batches of at most
    ``batch`` walks; yields as :func:`device_walks` does, over a
    :class:`WalkTables2` or this rank's weighted
    :class:`ShardedWalkTables`.  ``1/p`` and ``1/q`` are rounded to float32
    once, as the JAX package passes them."""
    inv_p, inv_q = float(np.float32(1.0 / p)), float(np.float32(1.0 / q))
    t = tables
    if isinstance(t, ShardedWalkTables):
        def launch(chunk, lo):
            return walk_p_q_sharded([t], chunk, walk_length, inv_p, inv_q,
                                    tries, seed, lo, group)
    else:
        def launch(chunk, lo):
            return walk_p_q(t, chunk, walk_length, inv_p, inv_q, tries,
                            seed, lo)
        if group is not None:
            launch = _lane_blocks(launch, t.n, group)
    yield from _walk_batches(t.device, starts, num_walks, batch, resident,
                             launch)


# ------------------------------------------------ walks over a shard group
# Under a process group (``parallel.ShardGroup``; the functions below use
# only its ``rank``, ``world_size``, ``all_reduce_`` and ``all_gather``) the
# walks are the single-card walks, bit for bit, whichever way the tables
# are placed: replicated tables walk a block of lanes per rank, sharded
# tables route every hop to the rank that owns the lane's current row.

def walk_rows(n: int, world: int) -> int:
    """Rows per rank of the row-sharded walk tables, ``⌈n / world⌉``."""
    return -(-int(n) // int(world))


def walk_table_slice(indptr: np.ndarray, cols: np.ndarray, deg: np.ndarray,
                     n: int, rank: int, world: int, vals=None, wmax=None,
                     wsum=None) -> dict:
    """Rank ``rank``'s rows ``[rank·rps, min((rank + 1)·rps, n))`` of the
    walk CSR, in the layout of the JAX package's ``_shard_walk_tables`` and
    ``_shard_walk_tables2`` (cleora_tpu/algorithms.py:1449-1480,
    :1535-1571): ``indptr`` (rps,) int32 offsets local to the rank's own
    ``cols`` slice, ``deg`` (rps,), ``cols`` (and ``vals``) padded to the
    largest slice of any rank, ``wmax``/``wsum`` (rps,); a row past ``n``
    has degree 0.  Returns numpy arrays by name."""
    n, world, rank = int(n), int(world), int(rank)
    rps = walk_rows(n, world)
    ip64 = np.zeros(n + 1, dtype=np.int64)
    ip64[:n] = indptr
    ip64[n] = (int(indptr[n - 1]) + int(deg[n - 1])) if n else 0
    bounds = np.minimum(np.arange(world + 1) * rps, n)
    counts = np.diff(ip64[bounds])
    width = max(int(counts.max()), 1)
    lo, hi = int(bounds[rank]), int(bounds[rank + 1])
    e0, e1 = int(ip64[lo]), int(ip64[hi])
    out = {"indptr": np.zeros(rps, np.int32), "deg": np.zeros(rps, np.int32),
           "cols": np.zeros(width, np.int32)}
    out["indptr"][:hi - lo] = ip64[lo:hi] - ip64[lo]
    out["deg"][:hi - lo] = deg[lo:hi]
    out["cols"][:e1 - e0] = cols[e0:e1]
    if vals is not None:
        out["vals"] = np.zeros(width, np.float32)
        out["vals"][:e1 - e0] = vals[e0:e1]
        for name, a in (("wmax", wmax), ("wsum", wsum)):
            out[name] = np.zeros(rps, np.float32)
            out[name][:hi - lo] = a[lo:hi]
    return out


class ShardedWalkTables:
    """One rank's slice of the row-sharded walk CSR on its device
    (:func:`walk_table_slice`), with the edge weights and the per-row
    ``wmax``/``wsum`` when ``vals`` is given (the second-order walk).
    ``row_lo`` is the first global row of the slice; validated once, as
    :class:`WalkTables`, so that K17 and K18 can trust every offset."""

    def __init__(self, indptr: np.ndarray, cols: np.ndarray, deg: np.ndarray,
                 n: int, rank: int, world: int, device, vals=None, wmax=None,
                 wsum=None):
        part = walk_table_slice(indptr, cols, deg, n, rank, world, vals,
                                wmax, wsum)
        _check_csr(part["indptr"], part["cols"], part["deg"], int(n))
        if vals is not None:
            _check_sorted_rows(part["indptr"], part["cols"], part["deg"])
        self.n, self.rank, self.world = int(n), int(rank), int(world)
        self.rps = walk_rows(n, world)
        self.row_lo = self.rank * self.rps
        for name, a in part.items():
            setattr(self, name, torch.from_numpy(a).to(device))
        self.weighted = vals is not None

    @property
    def device(self) -> torch.device:
        return self.indptr.device


def _owned(cur: torch.Tensor, row_lo: int, rps: int, n: int):
    """``(valid, owned, local row)`` of frontier nodes ``cur``: valid below
    ``n``, owned in ``[row_lo, row_lo + rps)``, the local row clamped to 0
    where not owned."""
    valid = (cur >= 0) & (cur < n)
    lr = cur.long() - row_lo
    owned = valid & (lr >= 0) & (lr < rps)
    return valid, owned, torch.where(owned, lr, torch.zeros_like(lr))


def walk_owned_round(t: ShardedWalkTables, nodes: torch.Tensor, hops,
                     walks: torch.Tensor, seed: int, base: int, state=None,
                     exclusive: bool = False, live=None) -> torch.Tensor:
    """This slice's part of one round of the first-order walks whose lanes
    stand at ``nodes`` after hop ``hops`` (int32 (B,); None: the first
    round; lane b is walk ``base + b``): each lane whose row the slice owns
    walks K8's hops while its rows stay on the slice, up to the last hop,
    writing each node into ``walks`` (int32 (B, L)); the root slice fills
    the lanes at the sentinel with ``n`` and carries the finished ones.
    The new nodes and hops of the lanes it took go into ``state`` (int32
    (2B,)), and with ``exclusive`` 0 for the others; None for a slice that
    holds every row.  ``live`` (int32 (1,)) gets the count of the input
    lanes short of hop L − 1 added.  On CUDA this launches K17; on the CPU
    it runs :func:`walk_owned_round_plain`.  Returns ``walks``."""
    args = (t.indptr, t.cols, t.deg, nodes, hops, walks, seed, base, t.n,
            t.row_lo, t.rank == 0, state, exclusive, live)
    if nodes.is_cuda:
        return kernels.walk_owned(*args)
    return walk_owned_round_plain(*args)


def walk_owned_round_plain(indptr: torch.Tensor, cols: torch.Tensor,
                           deg: torch.Tensor, nodes: torch.Tensor, hops,
                           walks: torch.Tensor, seed: int, base: int, n: int,
                           row_lo: int, root: bool, state=None,
                           exclusive: bool = False,
                           live=None) -> torch.Tensor:
    """Plain PyTorch version of K17: :func:`walk_uniform_plain`'s hops, one
    vector step over the lanes still walking on the slice each, with the
    writes of K17 (``indptr``/``deg`` local to the slice)."""
    dev = nodes.device
    b, length = walks.shape
    last = length - 1
    lane = torch.arange(b, device=dev)
    index = base + lane
    cur = nodes.to(torch.int32).clone()
    hop = (torch.zeros_like(cur) if hops is None
           else hops.to(torch.int32).clone())
    if live is not None:
        live += (hop < last).sum().to(torch.int32)
    valid, owned, at = _owned(cur, row_lo, indptr.shape[0], n)
    carried = (hop >= last) | ~valid
    mine = torch.where(carried, torch.full_like(owned, bool(root)), owned)
    first = mine & (hop == 0)
    walks[lane[first], 0] = cur[first]
    dead = mine & ~valid & (hop < last)
    step = mine & valid & (hop < last)
    while bool(step.any()):
        d = torch.where(step, deg[at], torch.zeros_like(cur))
        dead |= step & (d == 0)
        step &= d > 0
        u = hop_uniform(index, hop.long(), seed)
        t = torch.minimum((u * d.to(torch.float32)).to(torch.int32), d - 1)
        pos = (indptr[at].long() + t.clamp_min(0).long()).clamp_max(
            max(cols.shape[0] - 1, 0))
        cur = torch.where(step, cols[pos], cur)
        hop = hop + step.to(torch.int32)
        walks[lane[step], hop[step].long()] = cur[step]
        _, owned, at = _owned(cur, row_lo, indptr.shape[0], n)
        step &= owned & (hop < last)
    after = torch.arange(length, device=dev)[None, :] > hop[:, None].long()
    walks[dead[:, None] & after] = n
    cur = torch.where(dead, torch.full_like(cur, n), cur)
    hop = torch.where(dead, torch.full_like(hop, last), hop)
    if state is not None:
        if exclusive:
            state.zero_()
        state[0][mine] = cur[mine]
        state[1][mine] = hop[mine]
    return walks


# rounds between two reads of the live count (one host synchronisation
# each; a read at round r sees the count K17 took in round r - 1, of the
# lanes round r - 2 left short): at most this many rounds after the last
# lane finished change nothing
WALK_ROUND_CHECK = 4


def walk_uniform_sharded(slices, starts: torch.Tensor, walk_length: int,
                         seed: int, base: int, group=None,
                         stats=None) -> torch.Tensor:
    """(B, walk_length) int32 first-order walks over row-sharded tables,
    bitwise :func:`walk_uniform`'s.  ``slices`` are the table slices this
    process holds: its own rank's under a group, or several ranks' in one
    process.

    A slice that holds every row (one rank) walks the batch in one launch
    of K17, with no collective.  Otherwise the walk runs in rounds: in each,
    every slice advances the lanes whose rows it owns through their local
    hops (:func:`walk_owned_round`), so every lane not yet done moves at
    least one hop and a batch takes at most ``walk_length − 1`` rounds.
    Each lane's new state has one writer (a process's one slice writes 0
    for the lanes it does not take; several slices in one process write
    every lane between them), and ``group.all_reduce_`` sums the (2, B)
    int32 states over the ranks, one collective a round; each entry of the
    walk matrix has one writer too, and the zeroed matrices are summed over
    the ranks once a batch.  Each round's first slice also counts the lanes
    the round before left short of their last hop; at round 2 and every
    :data:`WALK_ROUND_CHECK` rounds the host reads the latest count, and
    rounds stop at 0.  Deadlock hazard: every rank must run the same
    collectives; the count is taken from the summed states, so it is the
    same on every rank, and every rank reads it at the same rounds.
    ``stats``, a dict, receives the number of rounds under ``"rounds"``."""
    b = starts.shape[0]
    first = slices[0]
    dev = starts.device
    if first.world == 1:
        walks = torch.empty((b, walk_length), dtype=torch.int32, device=dev)
        walk_owned_round(first, starts, None, walks, seed, base)
        if stats is not None:
            stats["rounds"] = 1
        return walks
    walks = torch.zeros((b, walk_length), dtype=torch.int32, device=dev)
    buffers = [torch.empty((2, b), dtype=torch.int32, device=dev)
               for _ in range(2)]
    most = max(1, walk_length - 1)
    counts = torch.zeros((most, 1), dtype=torch.int32, device=dev)
    alone = len(slices) == 1
    nodes, hops = starts, None
    rnd = 0
    while rnd < most:
        state = buffers[rnd % 2]
        if not alone and group is not None:
            state.zero_()
        for i, t in enumerate(slices):
            live = counts[rnd - 1] if rnd and i == 0 else None
            walk_owned_round(t, nodes, hops, walks, seed, base, state,
                             alone, live)
        if group is not None:
            group.all_reduce_(state)
        nodes, hops = state[0], state[1]
        rnd += 1
        if (rnd == 2 or rnd % WALK_ROUND_CHECK == 0) and rnd < most:
            if int(counts[rnd - 2]) == 0:
                break
    if group is not None:
        group.all_reduce_(walks)
    if stats is not None:
        stats["rounds"] = rnd
    return walks


def _summed(slices, group, stage, out: torch.Tensor) -> torch.Tensor:
    """``stage(t, buffer)`` of every table slice held here, summed into
    ``out`` and then over ``group``: the ranks' shares of one stage."""
    stage(slices[0], out)
    for t in slices[1:]:
        out += stage(t, torch.empty_like(out))
    if group is not None:
        group.all_reduce_(out)
    return out


# K18's buffers travel as int32: a float32 is carried by its bits, and each
# sum over the slices has exactly one nonzero term a lane, so it is exact
def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _floats(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.float32)


# the rejection rounds a chunk of K18's cross-owner lanes runs between two
# pairs of collectives (a power of two, at most kernels.WALK2_MAX_CHUNK):
# one all-reduce carries a chunk's proposals, one its membership answers.
# On an H100, four slices of chip_smoke.py's phase 8 batch (131,072 walks of
# 10, p = 0.5, q = 2) took 55.2, 19.2, 10.4, 6.75 and 6.72 ms at 1, 4, 8,
# 16 and 32 rounds a chunk (scripts/torch_walk2_probe.py --chunks): from 16
# on one chunk settles a hop
WALK2_CHUNK = 16


def walk2_local(t: ShardedWalkTables, cur: torch.Tensor, prev: torch.Tensor,
                hop: int, seed: int, base: int, inv_p: float, inv_q: float,
                tries: int, out: torch.Tensor) -> torch.Tensor:
    """K18's local stage of hop ``hop``, this rank's share, into ``out``:
    with ``out`` (4, B) int32, next + 1 for each lane the slice resolves
    (its current row is the slice's, and so is ``prev``'s, or it is the
    first hop, or the row has degree 0 or is dead: K12's whole hop), 0
    for a cross lane with its degree, ``wmax`` and backtrack weight in rows
    1-3 (floats by their bits), 0 for the lanes of other slices; with
    ``out`` (B,) (a slice holding every row) the next nodes themselves.
    On CUDA this launches K18; on the CPU it runs
    :func:`walk2_local_plain`."""
    if cur.is_cuda:
        return kernels.walk2_local(t.indptr, t.cols, t.vals, t.deg, t.wmax,
                                   t.wsum, cur, prev, hop, seed, base, t.n,
                                   t.row_lo, inv_p, inv_q, tries, out)
    out.copy_(walk2_local_plain(t.indptr, t.cols, t.vals, t.deg, t.wmax,
                                t.wsum, cur, prev, hop, seed, base, t.n,
                                t.row_lo, inv_p, inv_q, tries,
                                shared=out.dim() == 2))
    return out


def walk2_local_plain(indptr, cols, vals, deg, wmax, wsum, cur, prev,
                      hop: int, seed: int, base: int, n: int, row_lo: int,
                      inv_p: float, inv_q: float, tries: int,
                      shared: bool = True) -> torch.Tensor:
    """Plain PyTorch version of K18's local stage: :func:`walk_p_q_plain`'s
    hop on the slice's rows for the lanes it resolves; (4, B) int32 when
    ``shared``, else the (B,) next nodes."""
    tables = (indptr, cols, vals, deg, wmax, wsum)
    index = base + torch.arange(cur.shape[0], dtype=torch.int64,
                                device=cur.device)
    _, owned, at = _owned(cur, row_lo, indptr.shape[0], n)
    _, prev_owned, prev_at = _owned(prev, row_lo, indptr.shape[0], n)
    first = ~((prev >= 0) & (prev < n))
    nxt = torch.full_like(cur, n)
    zero = torch.zeros_like(cur)
    if not (cols.shape[0] and bool(owned.any())):
        return torch.stack([torch.where(owned, nxt + 1, zero), zero, zero,
                            zero]) if shared else nxt
    head = _hop_head(tables, at, prev, first, inv_p, inv_q)
    resolved = owned & (first | prev_owned | (head["d"] <= 0) | head["dead"])
    _hop_rounds(tables, head, resolved, at, prev, prev_at, first, index, hop,
                inv_q, tries, seed, n, nxt)
    if not shared:
        return nxt
    cross = owned & ~resolved
    fzero = torch.zeros((), dtype=torch.float32, device=cur.device)
    return torch.stack([
        torch.where(resolved, nxt + 1, zero),
        torch.where(cross, head["d"], zero),
        _bits(torch.where(cross, head["wm"], fzero)),
        _bits(torch.where(cross, head["w_bt"], fzero))])


def _chunk_terms(stats, lanes, prev, hop: int, r0: int, chunk: int,
                 tries: int, seed: int, base: int, n: int,
                 inv_q: float) -> dict:
    """The replicated terms of a chunk's rounds ``r0 .. r0 + chunk - 1``
    for the cross lanes ``lanes``, each (len(lanes), chunk) or
    (len(lanes),): the round, whether it is below ``tries``, the uniforms,
    ``first``, the backtrack test, the acceptance cap, the degree and
    ``prev``."""
    at = lanes.long()
    rnd = r0 + torch.arange(chunk, dtype=torch.int64, device=stats.device)
    u0, u1, u2 = round_uniforms((base + at)[:, None], hop, rnd[None, :],
                                seed)
    s = stats[:, at]
    d, wm, w_bt = s[0], _floats(s[1]), _floats(s[2])
    pi, cap = _hop_terms(d, wm, w_bt, inv_q)
    p = prev[at]
    first = ~((p >= 0) & (p < n))
    return {"rnd": rnd[None, :], "active": rnd[None, :] < tries, "u1": u1,
            "u2": u2, "first": first,
            "is_bt": ~first[:, None] & (u0 < pi[:, None]), "cap": cap,
            "d": d, "p": p}


def walk2_propose(t: ShardedWalkTables, stats, lanes, cur, prev, hop: int,
                  r0: int, chunk: int, tries: int, seed: int, base: int,
                  inv_q: float, out: torch.Tensor) -> torch.Tensor:
    """K18's proposal stage of a chunk, this rank's share: for each cross
    lane of ``lanes`` (int32, ascending) whose current row the slice owns
    and each round of the chunk below ``tries`` that does not take the
    backtrack edge, the uniform proposal ``x`` and its weight ``w`` into
    ``out`` ((2, len(lanes)·chunk) int32, lane-major); 0 elsewhere.  On
    CUDA this launches K18; on the CPU it runs
    :func:`walk2_propose_plain`."""
    if cur.is_cuda:
        return kernels.walk2_propose(t.indptr, t.cols, t.vals, stats, lanes,
                                     cur, prev, hop, r0, chunk, tries, seed,
                                     base, t.n, t.row_lo, inv_q, out)
    out.copy_(walk2_propose_plain(t.indptr, t.cols, t.vals, stats, lanes,
                                  cur, prev, hop, r0, chunk, tries, seed,
                                  base, t.n, t.row_lo, inv_q))
    return out


def walk2_propose_plain(indptr, cols, vals, stats, lanes, cur, prev,
                        hop: int, r0: int, chunk: int, tries: int, seed: int,
                        base: int, n: int, row_lo: int,
                        inv_q: float) -> torch.Tensor:
    """Plain PyTorch version of K18's proposal stage."""
    c = _chunk_terms(stats, lanes, prev, hop, r0, chunk, tries, seed, base,
                     n, inv_q)
    _, owned, at = _owned(cur[lanes.long()], row_lo, indptr.shape[0], n)
    draw = owned[:, None] & c["active"] & ~c["is_bt"]
    e = _proposal(indptr, c["d"][:, None], at[:, None], c["u1"]).clamp(
        0, max(cols.shape[0] - 1, 0))
    zero = torch.zeros((), dtype=torch.int32, device=cur.device)
    return torch.stack([torch.where(draw, cols[e], zero).reshape(-1),
                        torch.where(draw, _bits(vals[e]), zero).reshape(-1)])


def walk2_member(t: ShardedWalkTables, stats, lanes, prop, prev, hop: int,
                 r0: int, chunk: int, tries: int, seed: int, base: int,
                 inv_q: float, out: torch.Tensor) -> torch.Tensor:
    """K18's membership stage of a chunk, this rank's share: for each
    cross lane whose previous row the slice owns, bit j of ``out[i]``
    ((len(lanes),) int32) is 1 when round ``r0 + j`` tests its summed
    proposal (``prop``: not the backtrack edge, not ``prev``, not the last
    round) and finds it in ``prev``'s row; 0 elsewhere.  On CUDA this
    launches K18; on the CPU it runs :func:`walk2_member_plain`."""
    if prop.is_cuda:
        return kernels.walk2_member(t.indptr, t.cols, t.deg, stats, lanes,
                                    prop, prev, hop, r0, chunk, tries, seed,
                                    base, t.n, t.row_lo, inv_q, out)
    out.copy_(walk2_member_plain(t.indptr, t.cols, t.deg, stats, lanes, prop,
                                 prev, hop, r0, chunk, tries, seed, base,
                                 t.n, t.row_lo, inv_q))
    return out


def walk2_member_plain(indptr, cols, deg, stats, lanes, prop, prev,
                       hop: int, r0: int, chunk: int, tries: int, seed: int,
                       base: int, n: int, row_lo: int,
                       inv_q: float) -> torch.Tensor:
    """Plain PyTorch version of K18's membership stage."""
    c = _chunk_terms(stats, lanes, prev, hop, r0, chunk, tries, seed, base,
                     n, inv_q)
    count = lanes.shape[0]
    x = prop[0].reshape(count, chunk)
    _, owned, at = _owned(c["p"], row_lo, indptr.shape[0], n)
    test = (owned[:, None] & ~c["is_bt"] & (x != c["p"][:, None])
            & (c["rnd"] < tries - 1))
    found, _ = _row_search(indptr, cols, deg,
                           at[:, None].expand(count, chunk).reshape(-1),
                           x.reshape(-1).long())
    hit = test & found.reshape(count, chunk)
    word = (hit.long() << torch.arange(chunk, device=prop.device)).sum(1)
    # bit 31 set: the int32 of the same bits
    return torch.where(word >= 1 << 31, word - (1 << 32), word).to(
        torch.int32)


def walk2_decide(stats, lanes, prop, member, prev, hop: int, r0: int,
                 chunk: int, tries: int, seed: int, base: int, n: int,
                 inv_q: float, nxt: torch.Tensor) -> torch.Tensor:
    """K18's decision stage of a chunk, the same on every rank: each
    cross lane takes the first round of the chunk that hits, in K12's
    order (``prev`` on a backtrack, else its proposal on the last round or
    when accepted with ``(w·α) / cap``, α = 0 for ``x == prev``, 1 for a
    common neighbour, ``inv_q`` otherwise), written into ``nxt``.  Returns
    the bool mask of the lanes still pending.  On CUDA the decision is
    K18's; on the CPU :func:`walk2_decide_plain`'s."""
    if stats.is_cuda:
        return kernels.walk2_decide(stats, lanes, prop, member, prev, hop,
                                    r0, chunk, tries, seed, base, n, inv_q,
                                    nxt)
    return walk2_decide_plain(stats, lanes, prop, member, prev, hop, r0,
                              chunk, tries, seed, base, n, inv_q, nxt)


def walk2_decide_plain(stats, lanes, prop, member, prev, hop: int, r0: int,
                       chunk: int, tries: int, seed: int, base: int, n: int,
                       inv_q: float, nxt: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K18's decision stage: writes ``nxt`` and
    returns the bool mask of the lanes still pending."""
    c = _chunk_terms(stats, lanes, prev, hop, r0, chunk, tries, seed, base,
                     n, inv_q)
    count = lanes.shape[0]
    x = prop[0].reshape(count, chunk)
    w = _floats(prop[1]).reshape(count, chunk)
    zero, one, inv_q_t = _f32(0.0, 1.0, inv_q, device=prop.device)
    bit = (member.long()[:, None]
           >> torch.arange(chunk, device=prop.device)) & 1
    p = c["p"][:, None]
    alpha = torch.where(x == p, zero, torch.where(bit == 1, one, inv_q_t))
    take_x = (c["first"][:, None] | (c["rnd"] == tries - 1)
              | (c["u2"] < (w * alpha) / c["cap"][:, None]))
    hit = c["active"] & (c["is_bt"] | take_x)
    done = hit.any(1)
    j = hit.to(torch.int32).argmax(1, keepdim=True)  # the first hit
    take = torch.where(c["is_bt"].gather(1, j), p, x.gather(1, j))[:, 0]
    nxt[lanes.long()[done]] = take[done]
    return ~done


def _compact(mask: torch.Tensor, lanes=None) -> torch.Tensor:
    """The lanes where ``mask`` holds (``lanes``, else their positions), in
    order, as int32, computed on the device; the count is the one host
    read."""
    m = mask.shape[0]
    pos = torch.cumsum(mask, 0, dtype=torch.int32)
    count = int(pos[-1]) if m else 0
    src = lanes if lanes is not None else torch.arange(
        m, dtype=torch.int32, device=mask.device)
    out = torch.empty((m + 1,), dtype=torch.int32, device=mask.device)
    out.scatter_(0, torch.where(mask, pos - 1, m).long(), src)
    return out[:count]


def walk_p_q_sharded(slices, starts: torch.Tensor, walk_length: int,
                     inv_p: float, inv_q: float, tries: int, seed: int,
                     base: int, group=None) -> torch.Tensor:
    """(B, walk_length) int32 second-order walks over row-sharded weighted
    tables, bitwise :func:`walk_p_q`'s at any batch size.  ``slices`` and
    ``group`` as for :func:`walk_uniform_sharded`.

    A slice that holds every row (one rank) runs each hop in one launch of
    K18's local stage.  Otherwise each hop's local stage resolves the lanes
    whose current and previous rows are on one slice (and first hops, dead
    rows and rows of degree 0) on that slice, and hands the degree,
    ``wmax`` and backtrack weight of the others, the cross lanes, to every
    rank in the same all-reduce.  The cross lanes then run their rejection
    rounds in chunks of :data:`WALK2_CHUNK`: the owner of ``cur`` proposes
    the chunk's rounds (one all-reduce), the owner of ``prev`` answers the
    common-neighbour tests (one all-reduce), and every rank takes the same
    decisions.  Deadlock hazard: every rank must run the same collectives.
    The cross lanes are derived only from summed values and compacted on
    the device in lane order, so every rank holds the same lanes, and the
    one host read between chunks, their count, takes the same branch
    everywhere."""
    dev = starts.device
    b = starts.shape[0]
    n = slices[0].n
    whole = slices[0].world == 1
    walks = torch.empty((walk_length, b), dtype=torch.int32, device=dev)
    walks[0] = starts
    prev = torch.full_like(walks[0], n)
    buf = None if whole else torch.empty((4, b), dtype=torch.int32,
                                         device=dev)
    for hop in range(walk_length - 1):
        cur, nxt = walks[hop], walks[hop + 1]
        if whole:
            walk2_local(slices[0], cur, prev, hop, seed, base, inv_p, inv_q,
                        tries, nxt)
        else:
            _summed(slices, group,
                    lambda t, out: walk2_local(t, cur, prev, hop, seed, base,
                                               inv_p, inv_q, tries, out),
                    buf)
            _cross_rounds(slices, group, buf, cur, prev, nxt, hop, inv_q,
                          tries, seed, base)
        prev = cur
    return walks.T.contiguous()


def _cross_rounds(slices, group, buf, cur, prev, nxt, hop: int, inv_q: float,
                  tries: int, seed: int, base: int) -> None:
    """The rest of a hop after the summed local stage ``buf``: the resolved
    lanes' nodes, the sentinel for lanes at it (decided on every rank
    alone, never summed), and the cross lanes' rounds, chunk by chunk."""
    n, chunk = slices[0].n, WALK2_CHUNK
    valid = (cur >= 0) & (cur < n)
    nxt.copy_(torch.where(valid, buf[0] - 1, n))
    stats = buf[1:]
    lanes = _compact(valid & (buf[0] == 0))
    for r0 in range(0, tries, chunk):
        if lanes.numel() == 0:
            break
        count = lanes.shape[0]
        prop = _summed(
            slices, group,
            lambda t, out: walk2_propose(t, stats, lanes, cur, prev, hop, r0,
                                         chunk, tries, seed, base, inv_q,
                                         out),
            torch.empty((2, count * chunk), dtype=torch.int32,
                        device=cur.device))
        member = _summed(
            slices, group,
            lambda t, out: walk2_member(t, stats, lanes, prop, prev, hop, r0,
                                        chunk, tries, seed, base, inv_q, out),
            torch.empty((count,), dtype=torch.int32, device=cur.device))
        still = walk2_decide(stats, lanes, prop, member, prev, hop, r0, chunk,
                             tries, seed, base, n, inv_q, nxt)
        lanes = _compact(still, lanes)


def _lane_blocks(launch, n: int, group):
    """``launch(starts, base)`` of a batch under a group with replicated
    tables: rank r walks its block of ``⌈B / P⌉`` lanes at the Philox base
    of its first lane (pad lanes start at the sentinel ``n``), and an
    all-gather assembles the batch on every rank, bitwise the one-card
    batch (the counterpart of the JAX package's lane sharding,
    cleora_tpu/algorithms.py:1294-1315)."""
    def blocks(starts: torch.Tensor, base: int) -> torch.Tensor:
        b = starts.shape[0]
        block = -(-b // group.world_size)
        lo = min(group.rank * block, b)
        mine = torch.full((block,), n, dtype=torch.int32,
                          device=starts.device)
        mine[:min(lo + block, b) - lo] = starts[lo:lo + block]
        return group.all_gather(launch(mine, base + lo))[:b]
    return blocks
