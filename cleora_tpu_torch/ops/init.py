"""The deterministic hash init, built on the device.

Reference semantics: ``init_value`` (src/lib.rs:478-488), which the host's
``graph/hashing.py:init_embeddings`` and the JAX package's
``cleora_tpu/ops/init.py:device_init_rows`` compute bit for bit:

    value[i, c] = ((h_i + c + seed) · FX_K  mod 2⁶⁴, as int64) rem 2²³ / 2²³

with a truncated (C-style) remainder.  On CUDA :func:`device_init` launches
kernel K3 (``kernels/hash_init.cu``), which has native 64-bit integers; on
the CPU it runs :func:`device_init_plain`.

Hashes are carried as an int64 *view* of their uint64 bits
(``np.uint64 → view(np.int64)``): torch has no full uint64 arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..graph.hashing import FX_K, INIT_MAX_HASH

_M32 = 0xFFFFFFFF
_K_LO = int(FX_K) & _M32
_K_HI = int(FX_K) >> 32


def hashes_as_int64(entity_hashes: np.ndarray) -> torch.Tensor:
    """uint64 entity hashes → int64 tensor of the same bits (no copy)."""
    return torch.from_numpy(
        np.ascontiguousarray(entity_hashes, dtype=np.uint64).view(np.int64))


def device_init(hashes: torch.Tensor, feature_dim: int,
                seed: int = 0) -> torch.Tensor:
    """(N, feature_dim) float32 init on ``hashes``' device: K3 on CUDA,
    :func:`device_init_plain` on the CPU."""
    if hashes.is_cuda:
        return kernels.hash_init(hashes, feature_dim, seed)
    return device_init_plain(hashes, feature_dim, seed)


def _mul32(a: torch.Tensor, k: int):
    """(low, high) 32-bit words of ``a · k`` for ``a`` in [0, 2³²) held in
    int64 and a constant ``k`` < 2³², through 16-bit halves of ``k`` so that
    no intermediate exceeds 2⁴⁹."""
    p0 = a * (k & 0xFFFF)
    p1 = a * (k >> 16)
    t = p0 + ((p1 & 0xFFFF) << 16)
    return t & _M32, (t >> 32) + (p1 >> 16)


def device_init_plain(hashes: torch.Tensor, feature_dim: int,
                      seed: int = 0) -> torch.Tensor:
    """Plain PyTorch version of K3.  The 64-bit wrapping add and multiply
    run on 32-bit words held in int64, as the JAX version runs them on
    uint32 lanes, so nothing relies on signed overflow."""
    dev = hashes.device
    h = hashes.reshape(-1, 1)
    h_lo = h & _M32
    h_hi = (h >> 32) & _M32
    # column offsets c + seed (an int64, as for the host init), wrapped to
    # 64 bits on the host
    off = (np.arange(int(feature_dim), dtype=np.uint64)
           + np.int64(seed).view(np.uint64))
    c_lo = torch.from_numpy((off & np.uint64(_M32)).astype(np.int64)).to(dev)
    c_hi = torch.from_numpy((off >> np.uint64(32)).astype(np.int64)).to(dev)
    # s = h + (c + seed) mod 2⁶⁴
    s_lo = h_lo + c_lo
    s_hi = (h_hi + c_hi + (s_lo >> 32)) & _M32
    s_lo = s_lo & _M32
    # low 64 bits of s · FX_K
    m_lo, carry = _mul32(s_lo, _K_LO)
    m_hi = (carry + _mul32(s_lo, _K_HI)[0] + _mul32(s_hi, _K_LO)[0]) & _M32
    # truncated remainder of the int64 m by 2²³: the sign is bit 63
    mask23 = INIT_MAX_HASH - 1
    neg = m_hi >= (1 << 31)
    rem = torch.where(neg, -((-m_lo) & mask23), m_lo & mask23)
    return rem.to(torch.float32) / float(INIT_MAX_HASH)
