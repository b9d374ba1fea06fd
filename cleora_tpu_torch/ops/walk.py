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
        if n and (np.any(deg < 0) or np.any(indptr < 0) or np.any(
                indptr.astype(np.int64) + deg > cols.shape[0])):
            raise ValueError("malformed walk CSR: row outside cols")
        if cols.size and (cols.min() < 0 or cols.max() >= n):
            raise ValueError("malformed walk CSR: column index out of range")
        self.n = n
        self.indptr = torch.from_numpy(indptr).to(device)
        self.cols = torch.from_numpy(cols).to(device)
        self.deg = torch.from_numpy(deg).to(device)

    @property
    def device(self) -> torch.device:
        return self.indptr.device


def device_walks(tables: WalkTables, starts: np.ndarray, num_walks: int,
                 walk_length: int, seed: int, batch: int = WALK_BATCH,
                 resident: bool = False) -> Iterator:
    """Walks from every node of ``starts`` (int32, the nodes of degree > 0),
    ``num_walks`` rounds in the JAX package's order
    (``tile(starts, num_walks)``), in batches of at most ``batch`` walks.

    Yields int32 (B, walk_length) host arrays, or with ``resident=True``
    ``(walks, pad)`` with the walks left on the device.  PyTorch has no
    static shapes to keep, so a short last batch is not padded and ``pad``
    is always 0; consumers still honour the JAX contract's pad lanes."""
    t = tables
    yield from _walk_batches(
        t.device, starts, num_walks, batch, resident,
        lambda chunk, lo: walk_uniform(t.indptr, t.cols, t.deg, chunk,
                                       walk_length, seed, lo, t.n))


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
        self.vals = torch.from_numpy(vals).to(device)
        self.wmax = torch.from_numpy(wmax).to(device)
        self.wsum = torch.from_numpy(wsum).to(device)


def device_walks2(tables: WalkTables2, starts: np.ndarray, num_walks: int,
                  walk_length: int, p: float, q: float, tries: int, seed: int,
                  batch: int, resident: bool = False) -> Iterator:
    """Second-order walks from every node of ``starts`` in the JAX
    package's order (``tile(starts, num_walks)``), in batches of at most
    ``batch`` walks; yields as :func:`device_walks` does.  ``1/p`` and
    ``1/q`` are rounded to float32 once, as the JAX package passes them."""
    inv_p, inv_q = float(np.float32(1.0 / p)), float(np.float32(1.0 / q))
    t = tables
    yield from _walk_batches(
        t.device, starts, num_walks, batch, resident,
        lambda chunk, lo: walk_p_q(t.indptr, t.cols, t.vals, t.deg, t.wmax,
                                   t.wsum, chunk, walk_length, inv_p, inv_q,
                                   tries, seed, lo, t.n))
