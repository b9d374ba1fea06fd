"""First-order uniform random walks on the device.

Counterpart of the JAX package's walk engine (cleora_tpu/algorithms.py
``_device_walk_jit``, :1122-1155, and the batch driver ``_device_walks``,
:1318-1373).  Each hop of a walk moves to a uniformly drawn out-neighbour
of the current node in the self-loop-free walk CSR,
``cols[indptr[cur] + min(int(u·float(deg)), deg-1)]``; a walk that reaches a
node of degree 0 emits the sentinel ``n`` from then on, and a lane that
starts at ``n`` (a pad lane) stays there.

The uniforms come from Philox4x32-10 (Salmon et al., SC'11), a
counter-based generator keyed by the seed with the counter (global walk
index, hop), so the walks depend on neither the batch size nor the device.
On CUDA :func:`walk_uniform` launches kernel K8
(``kernels/walk_uniform.cu``); on the CPU :func:`walk_uniform_plain`
reproduces it bit for bit, emulating the 32×32→64-bit products on int64
words as ``ops/init.py`` does.  ``jax.random`` streams cannot be reproduced,
so the JAX package's walks are matched in distribution only.
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


def hop_uniform(walk_index: torch.Tensor, hop: int, seed: int) -> torch.Tensor:
    """The float32 uniform in [0, 1) of hop ``hop`` of the walks with global
    indices ``walk_index`` (int64): ``(x0 >> 8)·2⁻²⁴`` of Philox4x32-10 at
    counter (index low word, index high word, hop, 0)."""
    k0, k1 = _key(seed)
    zero = torch.zeros_like(walk_index)
    x0 = philox4x32(walk_index & _M32, walk_index >> 32, zero + hop, zero,
                    k0, k1)[0]
    return (x0 >> 8).to(torch.float32) * (2.0 ** -24)


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
    all_starts = np.tile(np.asarray(starts, dtype=np.int32), num_walks)
    for lo in range(0, all_starts.shape[0], batch):
        chunk = torch.from_numpy(all_starts[lo:lo + batch]).to(tables.device)
        out = walk_uniform(tables.indptr, tables.cols, tables.deg, chunk,
                           walk_length, seed, lo, tables.n)
        if resident:
            yield out, 0
        else:
            yield out.cpu().numpy()
