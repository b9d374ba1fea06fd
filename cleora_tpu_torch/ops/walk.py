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
the rank that owns a lane's row computes its share of each hop (kernel K17,
``kernels/walk_owned.cu``; for the p/q walk the five stages of kernel K18,
``kernels/walk2_owned.cu``), every other rank writes 0, and an all-reduce
combines the shares.
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


def hop_uniform(walk_index: torch.Tensor, hop: int, seed: int) -> torch.Tensor:
    """The float32 uniform in [0, 1) of hop ``hop`` of the walks with global
    indices ``walk_index`` (int64): ``(x0 >> 8)·2⁻²⁴`` of Philox4x32-10 at
    counter (index low word, index high word, hop, 0)."""
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


def walk_uniform(indptr: torch.Tensor, cols: torch.Tensor, deg: torch.Tensor,
                 starts: torch.Tensor, walk_length: int, seed: int, base: int,
                 n: int) -> torch.Tensor:
    """(B, walk_length) int32 walks from int32 ``starts`` (lane b is the
    walk of global index ``base + b``).  On CUDA this launches K8; on the
    CPU it runs :func:`walk_uniform_plain`."""
    if starts.is_cuda:
        return kernels.walk_uniform(indptr, cols, deg, starts, walk_length,
                                    seed, base, n)
    return walk_uniform_plain(indptr, cols, deg, starts, walk_length, seed,
                              base, n)


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
    ids ``cols`` (nnz,) and degrees ``deg`` (n,), validated once so that K8
    can trust every offset it gathers."""

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
            return walk_uniform(t.indptr, t.cols, t.deg, chunk, walk_length,
                                seed, lo, t.n)
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


def walk_p_q(indptr: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
             deg: torch.Tensor, wmax: torch.Tensor, wsum: torch.Tensor,
             starts: torch.Tensor, walk_length: int, inv_p: float,
             inv_q: float, tries: int, seed: int, base: int,
             n: int) -> torch.Tensor:
    """(B, walk_length) int32 second-order walks from int32 ``starts``
    (lane b is the walk of global index ``base + b``).  On CUDA this
    launches K12; on the CPU it runs :func:`walk_p_q_plain`."""
    if starts.is_cuda:
        return kernels.walk_p_q(indptr, cols, vals, deg, wmax, wsum, starts,
                                walk_length, inv_p, inv_q, tries, seed, base,
                                n)
    return walk_p_q_plain(indptr, cols, vals, deg, wmax, wsum, starts,
                          walk_length, inv_p, inv_q, tries, seed, base, n)


def _row_search(indptr: torch.Tensor, cols: torch.Tensor, deg: torch.Tensor,
                rows: torch.Tensor, x: torch.Tensor):
    """``(found, position)`` of each ``x`` in the sorted column slice of its
    row, ``cols[indptr[r] : indptr[r] + deg[r]]``: a lower-bound binary
    search that stops on ``lo < hi`` (``rows`` int64, valid)."""
    lo = indptr[rows].long()
    end = lo + deg[rows].long()
    hi = end.clone()
    last = cols.shape[0] - 1
    while True:
        active = lo < hi
        if not bool(active.any()):
            break
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
    f32 = torch.float32
    dev = starts.device
    index = base + torch.arange(starts.shape[0], dtype=torch.int64,
                                device=dev)
    # 0-d float32 operands: every product, sum and comparison stays float32
    inv_p, inv_q, env_floor, dead_floor, zero, one = torch.tensor(
        [inv_p, inv_q, 1e-30, 1e-15, 0.0, 1.0], dtype=f32, device=dev)
    m2 = torch.maximum(one, inv_q)
    cur = starts.to(torch.int32)
    prev = torch.full_like(cur, n)
    steps = [cur]
    for hop in range(walk_length - 1):
        nxt = torch.full_like(cur, n)
        valid = (cur >= 0) & (cur < n)
        if cols.shape[0] == 0 or not bool(valid.any()):
            prev, cur = cur, nxt
            steps.append(cur)
            continue
        cur_c = torch.where(valid, cur, torch.zeros_like(cur)).long()
        d = torch.where(valid, deg[cur_c], torch.zeros_like(cur))
        wm = wmax[cur_c]
        first = ~((prev >= 0) & (prev < n))
        prev_c = torch.where(first, torch.zeros_like(prev), prev).long()
        bt_found, bt_pos = _row_search(indptr, cols, deg, cur_c, prev_c)
        w_bt = torch.where(bt_found & ~first,
                           vals[bt_pos.clamp(0, cols.shape[0] - 1)] * inv_p,
                           zero)
        env = w_bt + (d.to(f32) * wm) * m2
        pi = w_bt / torch.maximum(env, env_floor)
        dead = wsum[cur_c] * m2 + w_bt < dead_floor
        cap = torch.maximum(wm * m2, env_floor)
        pending = torch.nonzero(valid & (d > 0) & ~dead).squeeze(1)
        for rnd in range(tries):
            if pending.numel() == 0:
                break
            u0, u1, u2 = round_uniforms(index[pending], hop, rnd, seed)
            dp = d[pending]
            j = torch.minimum((u1 * dp.to(f32)).to(torch.int32), dp - 1)
            e = indptr[cur_c[pending]].long() + j.long()
            x = cols[e]
            fp, pp = first[pending], prev_c[pending]
            is_bt = ~fp & (u0 < pi[pending])
            common, _ = _row_search(indptr, cols, deg, pp, x.long())
            alpha2 = torch.where(x.long() == pp, zero,
                                 torch.where(common, one, inv_q))
            p_acc = torch.where(fp, one, (vals[e] * alpha2) / cap[pending])
            hit = is_bt | (u2 < p_acc)
            if rnd == tries - 1:
                hit = torch.ones_like(hit)
            take = torch.where(is_bt, pp.to(torch.int32), x)
            nxt[pending[hit]] = take[hit]
            pending = pending[~hit]
        prev, cur = cur, nxt
        steps.append(cur)
    return torch.stack(steps, dim=1)


class WalkTables2(WalkTables):
    """The weighted walk CSR on one device for the second-order walk: the
    tables of :class:`WalkTables` plus float32 edge weights ``vals``
    (nnz,) and the per-row max ``wmax`` and sum ``wsum`` (n,).  Validated
    once: K12 trusts every offset, and its binary searches need each row's
    columns in ascending order."""

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
            return walk_p_q(t.indptr, t.cols, t.vals, t.deg, t.wmax, t.wsum,
                            chunk, walk_length, inv_p, inv_q, tries, seed, lo,
                            t.n)
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


def walk_owned_hop(t: ShardedWalkTables, cur: torch.Tensor, hop: int,
                   seed: int, base: int, out: torch.Tensor) -> torch.Tensor:
    """This rank's share of hop ``hop`` of the first-order walks whose
    lanes stand at ``cur`` (int32 (B,); lane b is walk ``base + b``),
    written into ``out`` (int32 (B,)): K8's next node for the lanes whose
    current row the rank owns, ``n`` for a lane at the sentinel on rank 0,
    0 everywhere else, so that the sum over the ranks is K8's hop.  On
    CUDA this launches K17; on the CPU it runs
    :func:`walk_owned_hop_plain`."""
    if cur.is_cuda:
        return kernels.walk_owned(t.indptr, t.cols, t.deg, cur, hop, seed,
                                  base, t.n, t.row_lo, t.rank == 0, out)
    out.copy_(walk_owned_hop_plain(t.indptr, t.cols, t.deg, cur, hop, seed,
                                   base, t.n, t.row_lo, t.rank == 0))
    return out


def walk_owned_hop_plain(indptr: torch.Tensor, cols: torch.Tensor,
                         deg: torch.Tensor, cur: torch.Tensor, hop: int,
                         seed: int, base: int, n: int, row_lo: int,
                         root: bool) -> torch.Tensor:
    """Plain PyTorch version of K17: :func:`walk_uniform_plain`'s hop on
    the rank's rows (``indptr``/``deg`` local to the slice)."""
    index = base + torch.arange(cur.shape[0], dtype=torch.int64,
                                device=cur.device)
    valid, owned, at = _owned(cur, row_lo, indptr.shape[0], n)
    zero = torch.zeros_like(cur)
    d = torch.where(owned, deg[at], zero)
    u = hop_uniform(index, hop, seed)
    t = torch.minimum((u * d.to(torch.float32)).to(torch.int32), d - 1)
    step = indptr[at].long() + t.clamp_min(0).long()
    nxt = cols[step.clamp_max(max(cols.shape[0] - 1, 0))]
    share = torch.where(owned, torch.where(d > 0, nxt, zero + n), zero)
    if root:
        share = torch.where(valid, share, zero + n)
    return share


def _summed(slices, group, stage, out: torch.Tensor) -> torch.Tensor:
    """``stage(t, buffer)`` of every table slice held here, summed into
    ``out`` and then over ``group``: the ranks' shares of one stage."""
    stage(slices[0], out)
    for t in slices[1:]:
        out += stage(t, torch.empty_like(out))
    if group is not None:
        group.all_reduce_(out)
    return out


def walk_uniform_sharded(slices, starts: torch.Tensor, walk_length: int,
                         seed: int, base: int, group=None) -> torch.Tensor:
    """(B, walk_length) int32 first-order walks over row-sharded tables,
    bitwise :func:`walk_uniform`'s.  ``slices`` are the table slices this
    process holds: its own rank's under a group (``group.all_reduce_``
    sums the ranks' shares of every hop), or several ranks' in one process
    (their shares summed here).  Every rank runs the same hops, so the
    collectives line up."""
    walks = torch.empty((walk_length, starts.shape[0]), dtype=torch.int32,
                        device=starts.device)
    walks[0] = starts
    for hop in range(walk_length - 1):
        _summed(slices, group,
                lambda t, out: walk_owned_hop(t, walks[hop], hop, seed, base,
                                              out),
                walks[hop + 1])
    return walks.T.contiguous()


# K18's stage outputs travel as int32: a float32 is carried by its bits,
# and each sum over the ranks has exactly one nonzero term, so it is exact
def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def _floats(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.float32)


def walk2_stats(t: ShardedWalkTables, cur: torch.Tensor, prev: torch.Tensor,
                inv_p: float, out: torch.Tensor) -> torch.Tensor:
    """K18's first stage, this rank's share: for each lane whose current
    row it owns, the degree, ``wmax``, ``wsum`` and the backtrack weight
    ``w_bt`` (the weight of ``cur → prev`` times ``inv_p``, 0 when ``prev``
    is no neighbour or the lane has no ``prev``), written into ``out``
    ((4, B) int32, the floats by their bits); 0 for the other lanes.  On
    CUDA this launches K18; on the CPU it runs :func:`walk2_stats_plain`."""
    if cur.is_cuda:
        return kernels.walk2_stats(t.indptr, t.cols, t.vals, t.deg, t.wmax,
                                   t.wsum, cur, prev, t.n, t.row_lo, inv_p,
                                   out)
    out.copy_(walk2_stats_plain(t.indptr, t.cols, t.vals, t.deg, t.wmax,
                                t.wsum, cur, prev, t.n, t.row_lo, inv_p))
    return out


def walk2_stats_plain(indptr, cols, vals, deg, wmax, wsum, cur, prev,
                      n: int, row_lo: int, inv_p: float) -> torch.Tensor:
    """Plain PyTorch version of K18's first stage (``walk_p_q_plain``'s
    per-hop quantities, on the rank's rows)."""
    f32 = torch.float32
    _, owned, at = _owned(cur, row_lo, indptr.shape[0], n)
    zero = torch.zeros((), dtype=f32, device=cur.device)
    d = torch.where(owned, deg[at], torch.zeros_like(cur))
    first = ~((prev >= 0) & (prev < n))
    prev_c = torch.where(first, torch.zeros_like(prev), prev).long()
    found, pos = _row_search(indptr, cols, deg, at, prev_c)
    last = max(cols.shape[0] - 1, 0)
    w_bt = torch.where(owned & found & ~first,
                       vals[pos.clamp(0, last)]
                       * torch.tensor(inv_p, dtype=f32), zero)
    return torch.stack([d, _bits(torch.where(owned, wmax[at], zero)),
                        _bits(torch.where(owned, wsum[at], zero)),
                        _bits(w_bt)])


def walk2_pending(stats: torch.Tensor, inv_q: float) -> torch.Tensor:
    """The lanes that draw this hop, from the summed stats (the same on
    every rank): degree > 0 and a row that is not dead (``wsum·m2 + w_bt <
    1e-15``), as a sorted int64 index tensor.  On CUDA the mask is K18's;
    on the CPU :func:`walk2_pending_plain`'s."""
    if stats.is_cuda:
        mask = kernels.walk2_pending(stats, inv_q)
    else:
        mask = walk2_pending_plain(stats, inv_q)
    return torch.nonzero(mask).squeeze(1)


def walk2_pending_plain(stats: torch.Tensor, inv_q: float) -> torch.Tensor:
    """Plain PyTorch version of K18's pending stage (a bool mask)."""
    f32 = torch.float32
    m2 = torch.maximum(torch.tensor(1.0, dtype=f32),
                       torch.tensor(inv_q, dtype=f32)).to(stats.device)
    dead = _floats(stats[2]) * m2 + _floats(stats[3]) < torch.tensor(
        1e-15, dtype=f32, device=stats.device)
    return (stats[0] > 0) & ~dead


def _round_terms(stats, lanes, prev, hop, rnd, seed, base, n, inv_q):
    """The replicated quantities of one rejection round of ``lanes``:
    the three uniforms, ``first``, ``is_bt`` and the acceptance cap, in
    ``walk_p_q_plain``'s float32 operations."""
    f32 = torch.float32
    dev = stats.device
    env_floor, one, inv_q_t = torch.tensor([1e-30, 1.0, inv_q], dtype=f32,
                                           device=dev)
    m2 = torch.maximum(one, inv_q_t)
    u0, u1, u2 = round_uniforms(base + lanes, hop, rnd, seed)
    s = stats[:, lanes]
    d, wm, w_bt = s[0], _floats(s[1]), _floats(s[3])
    env = w_bt + (d.to(f32) * wm) * m2
    pi = w_bt / torch.maximum(env, env_floor)
    p = prev[lanes]
    first = ~((p >= 0) & (p < n))
    is_bt = ~first & (u0 < pi)
    cap = torch.maximum(wm * m2, env_floor)
    return u1, u2, d, first, is_bt, cap, p


def walk2_propose(t: ShardedWalkTables, stats, lanes, cur, prev, hop: int,
                  rnd: int, seed: int, base: int, inv_q: float,
                  out: torch.Tensor) -> torch.Tensor:
    """K18's proposal stage, this rank's share: for each pending lane
    (``lanes``, sorted int64) that does not take the backtrack edge and
    whose current row the rank owns, the uniform proposal ``x`` and its
    weight ``w`` of round ``rnd`` into ``out`` ((2, len(lanes)) int32);
    0 elsewhere.  On CUDA this launches K18; on the CPU it runs
    :func:`walk2_propose_plain`."""
    if cur.is_cuda:
        return kernels.walk2_propose(t.indptr, t.cols, t.vals, stats, lanes,
                                     cur, prev, hop, rnd, seed, base, t.n,
                                     t.row_lo, inv_q, out)
    out.copy_(walk2_propose_plain(t.indptr, t.cols, t.vals, stats, lanes,
                                  cur, prev, hop, rnd, seed, base, t.n,
                                  t.row_lo, inv_q))
    return out


def walk2_propose_plain(indptr, cols, vals, stats, lanes, cur, prev,
                        hop: int, rnd: int, seed: int, base: int, n: int,
                        row_lo: int, inv_q: float) -> torch.Tensor:
    """Plain PyTorch version of K18's proposal stage."""
    u1, _, d, _, is_bt, _, _ = _round_terms(stats, lanes, prev, hop, rnd,
                                            seed, base, n, inv_q)
    _, owned, at = _owned(cur[lanes], row_lo, indptr.shape[0], n)
    draw = owned & ~is_bt
    j = torch.minimum((u1 * d.to(torch.float32)).to(torch.int32), d - 1)
    e = (indptr[at].long() + j.clamp_min(0).long()).clamp(
        0, max(cols.shape[0] - 1, 0))
    zero = torch.zeros_like(d)
    return torch.stack([torch.where(draw, cols[e], zero),
                        torch.where(draw, _bits(vals[e]), zero)])


def walk2_member(t: ShardedWalkTables, stats, lanes, prop, prev, hop: int,
                 rnd: int, tries: int, seed: int, base: int, inv_q: float,
                 out: torch.Tensor) -> torch.Tensor:
    """K18's membership stage, this rank's share: for each pending lane
    that tests its proposal (not the first hop, not the backtrack edge,
    not the forced last round, ``x ≠ prev``) and whose previous row the
    rank owns, 1 when the summed proposal ``x`` (``prop``) is a neighbour
    of ``prev``, into ``out`` ((len(lanes),) int32); 0 elsewhere.  On CUDA
    this launches K18; on the CPU it runs :func:`walk2_member_plain`."""
    if prop.is_cuda:
        return kernels.walk2_member(t.indptr, t.cols, t.deg, stats, lanes,
                                    prop, prev, hop, rnd, tries, seed, base,
                                    t.n, t.row_lo, inv_q, out)
    out.copy_(walk2_member_plain(t.indptr, t.cols, t.deg, stats, lanes, prop,
                                 prev, hop, rnd, tries, seed, base, t.n,
                                 t.row_lo, inv_q))
    return out


def walk2_member_plain(indptr, cols, deg, stats, lanes, prop, prev, hop: int,
                       rnd: int, tries: int, seed: int, base: int, n: int,
                       row_lo: int, inv_q: float) -> torch.Tensor:
    """Plain PyTorch version of K18's membership stage."""
    _, _, _, first, is_bt, _, p = _round_terms(stats, lanes, prev, hop, rnd,
                                               seed, base, n, inv_q)
    x = prop[0]
    _, owned, at = _owned(p, row_lo, indptr.shape[0], n)
    test = owned & ~first & ~is_bt & (x != p) & (rnd < tries - 1)
    found, _ = _row_search(indptr, cols, deg, at, x.long())
    return (test & found).to(torch.int32)


def walk2_decide(stats, lanes, prop, member, prev, hop: int, rnd: int,
                 tries: int, seed: int, base: int, n: int, inv_q: float,
                 nxt: torch.Tensor) -> torch.Tensor:
    """K18's decision stage, the same on every rank: each pending lane
    takes ``prev`` (backtrack), its proposal (first hop, last round, or
    accepted with ``(w·α) / cap``, α = 0 for ``x == prev``, 1 for a common
    neighbour, ``inv_q`` otherwise) or rejects, in K12's order.  Writes the
    taken nodes into ``nxt`` and returns the lanes still pending.  On CUDA
    the decision is K18's; on the CPU :func:`walk2_decide_plain`'s."""
    if stats.is_cuda:
        still = kernels.walk2_decide(stats, lanes, prop, member, prev, hop,
                                     rnd, tries, seed, base, n, inv_q, nxt)
    else:
        still = walk2_decide_plain(stats, lanes, prop, member, prev, hop,
                                   rnd, tries, seed, base, n, inv_q, nxt)
    return lanes[still]


def walk2_decide_plain(stats, lanes, prop, member, prev, hop: int, rnd: int,
                       tries: int, seed: int, base: int, n: int,
                       inv_q: float, nxt: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K18's decision stage: writes ``nxt`` and
    returns the bool mask of the lanes still pending."""
    f32 = torch.float32
    _, u2, _, first, is_bt, cap, p = _round_terms(stats, lanes, prev, hop,
                                                  rnd, seed, base, n, inv_q)
    x, w = prop[0], _floats(prop[1])
    zero, one, inv_q_t = torch.tensor([0.0, 1.0, inv_q], dtype=f32,
                                      device=stats.device)
    alpha = torch.where(x == p, zero, torch.where(member != 0, one, inv_q_t))
    p_acc = (w * alpha) / cap
    take_x = first | (rnd == tries - 1) | (u2 < p_acc)
    hit = is_bt | take_x
    nxt[lanes[hit]] = torch.where(is_bt, p, x)[hit]
    return ~hit


def walk_p_q_sharded(slices, starts: torch.Tensor, walk_length: int,
                     inv_p: float, inv_q: float, tries: int, seed: int,
                     base: int, group=None) -> torch.Tensor:
    """(B, walk_length) int32 second-order walks over row-sharded weighted
    tables, bitwise :func:`walk_p_q`'s at any batch size.  ``slices`` and
    ``group`` as for :func:`walk_uniform_sharded`.

    Per hop the owner of each lane's current row supplies its degree,
    ``wmax``, ``wsum`` and backtrack weight (one collective); per rejection
    round the owner of ``cur`` draws the proposal and the owner of ``prev``
    answers the common-neighbour test (two collectives), and every rank
    takes the same decision.  Deadlock hazard: every rank must run the same
    collectives.  The pending lanes are derived only from summed values,
    so every rank holds the same set, and the host check that ends the
    round loop (no lane pending, or ``tries`` rounds) takes the same
    branch everywhere."""
    dev = starts.device
    b = starts.shape[0]
    n = slices[0].n
    walks = torch.empty((walk_length, b), dtype=torch.int32, device=dev)
    walks[0] = starts
    prev = torch.full_like(walks[0], n)
    stats = torch.empty((4, b), dtype=torch.int32, device=dev)
    for hop in range(walk_length - 1):
        cur, nxt = walks[hop], walks[hop + 1]
        nxt.fill_(n)
        _summed(slices, group,
                lambda t, out: walk2_stats(t, cur, prev, inv_p, out), stats)
        lanes = walk2_pending(stats, inv_q)
        for rnd in range(tries):
            if lanes.numel() == 0:
                break
            prop = _summed(
                slices, group,
                lambda t, out: walk2_propose(t, stats, lanes, cur, prev, hop,
                                             rnd, seed, base, inv_q, out),
                torch.empty((2, lanes.numel()), dtype=torch.int32,
                            device=dev))
            member = _summed(
                slices, group,
                lambda t, out: walk2_member(t, stats, lanes, prop, prev, hop,
                                            rnd, tries, seed, base, inv_q,
                                            out),
                torch.empty((lanes.numel(),), dtype=torch.int32, device=dev))
            lanes = walk2_decide(stats, lanes, prop, member, prev, hop, rnd,
                                 tries, seed, base, n, inv_q, nxt)
        prev = cur
    return walks.T.contiguous()


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
