"""The GCN's device pieces: its SpMM with a transposed backward, and the
hidden layers' ReLU with inverted dropout.

Counterpart of ``_gcn_forward`` under ``jax.grad`` in the JAX package
(cleora_tpu/classify.py:122-170).  Each layer there is ``H ← Â·H``, then
``Z = H·W``, then for a hidden layer ``relu(Z)`` and inverted dropout
``where(keep, H/(1−p), 0)``.

- :class:`CsrSpmm` is ``Â·H`` as a ``torch.autograd.Function``.  Its
  backward is ``Âᵀ·dOut``, and Â = D^-½(A+I)D^-½ over a left-Markov A is
  not symmetric, so it carries the CSR of Âᵀ as well.  Both directions are
  kernel K1 (``kernels/spmm_csr.cu``) on CUDA and :func:`spmm_plain` on
  the CPU.
- :class:`ReluDropout` is the hidden-layer epilogue.  Its forward and
  backward are kernel K15 (``kernels/relu_dropout.cu``) on CUDA and
  :func:`relu_dropout_plain` / :func:`relu_dropout_backward_plain` on the
  CPU.  They agree bit for bit.

The keep mask is ``u ≥ p``.  The uniform u of element ``e`` of the
row-major (n, width) Z comes from Philox4x32-10 keyed by ``seed``, at
counter (``e // 4`` low word, ``e // 4`` high word, epoch, layer): it is word
``e % 4`` as ``(x >> 8)·2⁻²⁴``.  The mask is therefore a function of
(seed, epoch, layer) alone, on every device.  It is not JAX's stream
(``jax.random.bernoulli`` under split keys), which torch cannot replay, so
dropout runs agree with the JAX package in distribution only.  The
forward also writes ``keep and z > 0`` packed 32 bits a word
(:func:`pack_bits`), which the backward reads instead of ``z``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .spmm import CsrMatrix, spmm
from .walk import _key, _unit_float, philox4x32


def dropout_uniforms(numel: int, epoch: int, layer: int, seed: int,
                     device) -> torch.Tensor:
    """The float32 uniforms in [0, 1) of the first ``numel`` elements at
    (``epoch``, ``layer``), as a flat tensor on ``device``."""
    k0, k1 = _key(seed)
    groups = torch.arange((numel + 3) // 4, dtype=torch.int64, device=device)
    zero = torch.zeros_like(groups)
    words = philox4x32(groups & 0xFFFFFFFF, groups >> 32, zero + int(epoch),
                       zero + int(layer), k0, k1)
    return _unit_float(torch.stack(words, dim=1).reshape(-1)[:numel])


def _keep_scale(p: float) -> float:
    """``1 − p`` rounded to float32, the divisor of the kept values, as
    ``H / (1 - dropout)`` rounds the Python float in the JAX program."""
    return float(np.float32(1.0 - float(p)))


def _bits(z: torch.Tensor, p: float, seed: int, epoch: int,
          layer: int) -> torch.Tensor:
    """The flat bool bits of ``z``: the keep mask ``u ≥ p`` and ReLU's
    positive part ``z > 0`` together.  p = 0 draws nothing."""
    positive = z.reshape(-1) > 0
    if float(p) == 0.0:
        return positive
    u = dropout_uniforms(z.numel(), epoch, layer, seed, z.device)
    return positive & (u >= float(np.float32(p)))


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Flat bool bits as K15's mask: bit e % 32 of int32 word e // 32 (the
    last word padded with 0 bits)."""
    words = (bits.shape[0] + 31) // 32
    padded = torch.zeros(words * 32, dtype=torch.int64, device=bits.device)
    padded[:bits.shape[0]] = bits
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    word = (padded.reshape(words, 32) << shifts).sum(1)
    # bit 31 set: the int32 of the same bits
    return torch.where(word >= 1 << 31, word - (1 << 32), word).to(
        torch.int32)


def unpack_bits(mask: torch.Tensor, numel: int) -> torch.Tensor:
    """K15's mask as ``numel`` flat bool bits."""
    shifts = torch.arange(32, dtype=torch.int64, device=mask.device)
    bits = (mask.long()[:, None] >> shifts) & 1
    return bits.reshape(-1)[:numel].bool()


def _scaled(t: torch.Tensor, p: float) -> torch.Tensor:
    # a true division by a tensor: PyTorch's CUDA division by a Python
    # scalar multiplies by its reciprocal, which K15 does not
    return t / torch.full_like(t, _keep_scale(p))


def relu_dropout_plain(z: torch.Tensor, p: float, seed: int, epoch: int,
                       layer: int):
    """Plain PyTorch version of K15's forward: ``h = keep ? relu(z)/(1−p) :
    0`` (float32) and the packed bits ``keep and z > 0``
    (:func:`pack_bits`)."""
    bits = _bits(z, p, seed, epoch, layer)
    h = torch.where(bits.reshape(z.shape), _scaled(z, p), 0.0)
    return h, pack_bits(bits)


def relu_dropout_backward_plain(mask: torch.Tensor, dh: torch.Tensor,
                                p: float) -> torch.Tensor:
    """Plain PyTorch version of K15's backward: ``bit ? dh/(1−p) : 0`` with
    the forward's packed bits (ReLU's gradient at 0 is 0, as in JAX)."""
    bits = unpack_bits(mask, dh.numel()).reshape(dh.shape)
    return torch.where(bits, _scaled(dh, p), 0.0)


def relu_dropout(z: torch.Tensor, p: float, seed: int, epoch: int,
                 layer: int):
    """K15's forward on CUDA, :func:`relu_dropout_plain` on the CPU:
    ``(h, mask)``."""
    if z.is_cuda:
        return kernels.relu_dropout(z, p, seed, epoch, layer)
    return relu_dropout_plain(z, p, seed, epoch, layer)


def relu_dropout_backward(mask: torch.Tensor, dh: torch.Tensor,
                          p: float) -> torch.Tensor:
    """K15's backward on CUDA, :func:`relu_dropout_backward_plain` on the
    CPU."""
    if dh.is_cuda:
        return kernels.relu_dropout_backward(mask, dh, p)
    return relu_dropout_backward_plain(mask, dh, p)


class CsrSpmm(torch.autograd.Function):
    """``a @ h`` with the gradient ``at @ dOut``; ``at`` is the CSR of aᵀ."""

    @staticmethod
    def forward(ctx, h: torch.Tensor, a: CsrMatrix,
                at: CsrMatrix) -> torch.Tensor:
        ctx.at = at
        return spmm(a, h)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return spmm(ctx.at, grad.contiguous()), None, None


class ReluDropout(torch.autograd.Function):
    """``keep ? relu(z)/(1−p) : 0`` with the mask of (seed, epoch, layer);
    it keeps the packed bits for its backward (1 bit an element), not
    ``z``."""

    @staticmethod
    def forward(ctx, z: torch.Tensor, p: float, seed: int, epoch: int,
                layer: int) -> torch.Tensor:
        h, mask = relu_dropout(z.contiguous(), p, seed, epoch, layer)
        ctx.save_for_backward(mask)
        ctx.p = p
        return h

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (mask,) = ctx.saved_tensors
        dz = relu_dropout_backward(mask, grad.contiguous(), ctx.p)
        return dz, None, None, None, None
