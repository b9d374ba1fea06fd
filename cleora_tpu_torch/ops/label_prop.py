"""One step of label propagation on the device.

Counterpart of the loop body of the JAX package's ``_label_prop_jit``
(cleora_tpu/classify.py:88-105)::

    F ← where(mask, Y, α·(S·F) + (1−α)·Y)

with S = D⁻¹A in CSR, F and Y float32 (n, C) and ``mask`` the labelled rows.
On CUDA :func:`label_prop_step` launches kernel K14
(``kernels/label_prop.cu``); on the CPU it runs
:func:`label_prop_step_plain`.  Both round each product and sum of the tail
to float32 in the same order, so clamped rows are Y exactly and the other
rows differ only by the order of the row sum.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from .spmm import CsrMatrix, spmm_plain


def label_prop_step(csr: CsrMatrix, f: torch.Tensor, y: torch.Tensor,
                    mask: torch.Tensor, alpha: float, beta: float,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``where(mask, y, alpha·(csr @ f) + beta·y)`` as float32 (n, C), into
    ``out`` when given (it must not share memory with ``f``: other rows
    gather it).  ``alpha`` and ``beta`` are rounded to float32: the caller
    passes ``beta = float32(1) − float32(alpha)``, as the JAX program's
    traced ``1 - alpha`` is."""
    if f.is_cuda:
        return kernels.label_prop(csr.indptr, csr.indices, csr.vals, f, y,
                                  mask, alpha, beta, out)
    step = label_prop_step_plain(csr, f, y, mask, alpha, beta)
    if out is None:
        return step
    return out.copy_(step)


def label_prop_step_plain(csr: CsrMatrix, f: torch.Tensor, y: torch.Tensor,
                          mask: torch.Tensor, alpha: float,
                          beta: float) -> torch.Tensor:
    """Plain PyTorch version of K14: :func:`spmm_plain`, then α·s and β·y
    each rounded to float32 and added, then the clamp."""
    s = spmm_plain(csr, f)
    s.mul_(float(alpha))
    s += float(beta) * y
    return torch.where(mask[:, None], y, s)
