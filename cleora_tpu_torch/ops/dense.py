"""Dense building blocks of the log-factorisations (NetMF, GraRep) and the
randomized SVDs.

Counterpart of cleora_tpu/algorithms.py:376-404: the dense transition
matrix scattered from the sparse one (kernel K6), the scaled log-clip
(kernel K7) and the randomized ``U_k·√S_k``; and of the walk pipeline's
unfused randomized SVD of the sparse PPMI matrix (``_rsvd_step_jits``,
cleora_tpu/algorithms.py:2142-2226), whose products are kernels K1 and K5.
The large float32 products, QR and SVD are library calls (``torch.matmul``,
``torch.linalg``), as the JAX package hands them to XLA's libraries; they
run in full float32.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from .. import kernels
from .._util import full_float32_matmul
from .spmm import CsrMatrix, spmm, spmm_axpy


def dense_markov(csr: CsrMatrix):
    """``(P, deg, vol)`` of a square CSR matrix A: ``P = A / deg[:, None]``
    as dense float32 (n, n) with duplicate entries summed, ``deg =
    max(row sums, 1e-10)`` float32 (n,), and ``vol = ΣA`` as a float64 (1,)
    tensor.  On CUDA this launches K6; on the CPU it runs
    :func:`dense_markov_plain`."""
    if csr.vals.is_cuda:
        return kernels.dense_markov(csr.indptr, csr.indices, csr.vals)
    return dense_markov_plain(csr)


def dense_markov_plain(csr: CsrMatrix):
    """Plain PyTorch version of K6: scatter-add, row sums, divide."""
    n = csr.n_rows
    rows, cols = csr.plain_index()
    a = torch.zeros((n, n), dtype=torch.float32, device=csr.device)
    a.index_put_((rows, cols), csr.vals, accumulate=True)
    sums = a.sum(dim=1)
    deg = sums.clamp_min(1e-10)
    vol = sums.double().sum().reshape(1)
    return a.div_(deg[:, None]), deg, vol


def log_clip(x: torch.Tensor, row_scale: Optional[torch.Tensor],
             col_scale: Optional[torch.Tensor], floor: float,
             offset: float) -> torch.Tensor:
    """``log(max(x·row_scale[:, None]·col_scale[None, :], floor)) − offset``
    written into ``x`` (float32 (n, m)), which is returned; a scale that is
    None is left out.  On CUDA this launches K7; on the CPU it runs
    :func:`log_clip_plain`."""
    if x.is_cuda:
        return kernels.log_clip_(x, row_scale, col_scale, floor, offset)
    return log_clip_plain(x, row_scale, col_scale, floor, offset)


def log_clip_plain(x: torch.Tensor, row_scale: Optional[torch.Tensor],
                   col_scale: Optional[torch.Tensor], floor: float,
                   offset: float) -> torch.Tensor:
    """Plain PyTorch version of K7, in place like the kernel."""
    if row_scale is not None:
        x.mul_(row_scale[:, None])
    if col_scale is not None:
        x.mul_(col_scale[None, :])
    return x.clamp_min_(float(floor)).log_().sub_(float(offset))


@full_float32_matmul()
def rsvd_u_sqrt(M: torch.Tensor, omega: torch.Tensor, k: int,
                power_iters: int) -> torch.Tensor:
    """``U_k·√S_k`` of a dense matrix by randomized subspace iteration
    (exact when omega has ≥ n columns); counterpart of ``_rsvd_u_sqrt``,
    cleora_tpu/algorithms.py:376-394."""
    Y = torch.matmul(M, omega)
    for _ in range(power_iters):
        Q, _ = torch.linalg.qr(Y)
        Y = torch.matmul(M, torch.matmul(M.T, Q))
    Q, _ = torch.linalg.qr(Y)
    C = torch.matmul(M.T, Q)  # (n, r);  Cᵀ = Qᵀ·M
    # M ≈ Q·Qᵀ·M = (Q·Ub)·S·Vt, so the left singular vectors lift through Q
    Ub, s, _ = torch.linalg.svd(C.T, full_matrices=False)
    su = torch.sqrt(torch.clamp_min(s[:k], 0.0))
    return torch.matmul(Q, Ub[:, :k]) * su


def _apply_pieces(pieces: List[CsrMatrix], x: torch.Tensor) -> torch.Tensor:
    """``M·x`` for M given as row-disjoint CSR pieces (every row of M lives
    in one piece): the first piece by K1, each further one added by K5's
    ``acc`` (the JAX program's ``apply`` and ``apply_add``).  Exact: each
    row gets its one piece's value plus zeros."""
    x = x.contiguous()  # a CUDA QR's Q is column-major: copy once, not per piece
    y = spmm(pieces[0], x)
    for piece in pieces[1:]:
        spmm_axpy(piece, x, 1.0, acc=y, d=1.0)
    return y


def rsvd_sparse(pieces: List[CsrMatrix], k: int, omega: torch.Tensor,
                power_iters: int) -> torch.Tensor:
    """``U_k·√S_k`` of a symmetric sparse matrix M given as row-disjoint
    CSR pieces, by randomized subspace iteration over the sketch ``omega``
    (n, r): the steps of ``_rsvd_flat`` (cleora_tpu/algorithms.py:
    2211-2225) in its order."""
    return rsvd_apply(lambda x: _apply_pieces(pieces, x), k, omega,
                      power_iters)


@full_float32_matmul()
def rsvd_apply(apply, k: int, omega: torch.Tensor,
               power_iters: int) -> torch.Tensor:
    """:func:`rsvd_sparse` with the product ``M·x`` given as ``apply(x)``
    (the sharded factorization sums each rank's pieces there)."""
    y = apply(omega)
    for _ in range(power_iters):  # M symmetric
        y = apply(apply(torch.linalg.qr(y)[0]))
    q = torch.linalg.qr(y)[0]
    del y
    c = apply(q)
    ub, s, _ = torch.linalg.svd(c.T, full_matrices=False)
    su = torch.sqrt(torch.clamp_min(s[:k], 0.0))
    return torch.matmul(q, ub[:, :k]) * su
