"""Sparse matrix × dense embedding propagation (SpMM) on a CSR matrix.

``out[i] = Σ_{edges (i→j)} value · x[j]`` (reference semantics:
``spmm_kernel``, src/embedding.rs:52-86).  The matrix stays in CSR in its
original row order: kernel K1 (``kernels/spmm_csr.cu``) keeps each row's
sum in registers, so none of the JAX package's ELL, banded or edge-cut
layouts and none of their row relabelling is needed here.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import kernels

# elements of the plain version's (chunk, D) gather intermediate: 4 GiB in
# float32, which is 1 << 22 edges per chunk at D = 256
_PLAIN_CHUNK_ELEMENTS = 1 << 30


class CsrMatrix:
    """A square CSR matrix on one device: ``indptr`` int64 (N+1),
    ``indices`` int32 (nnz), ``vals`` float32 (nnz)."""

    def __init__(self, indptr: torch.Tensor, indices: torch.Tensor,
                 vals: torch.Tensor):
        self.indptr = indptr
        self.indices = indices
        self.vals = vals
        self._plain_index: Optional[tuple] = None

    @classmethod
    def from_numpy(cls, indptr: np.ndarray, indices: np.ndarray,
                   vals: np.ndarray, device) -> "CsrMatrix":
        """Validate the host CSR once (the kernel trusts its indices), then
        copy it to ``device``."""
        indptr = np.ascontiguousarray(indptr, dtype=np.int64)
        indices = np.ascontiguousarray(indices, dtype=np.int32)
        vals = np.ascontiguousarray(vals, dtype=np.float32)
        n = indptr.shape[0] - 1
        if (n < 0 or indptr[0] != 0 or indptr[-1] != indices.shape[0]
                or indices.shape != vals.shape
                or (n > 0 and np.any(np.diff(indptr) < 0))):
            raise ValueError("malformed CSR: indptr/indices/vals disagree")
        if indices.size and (indices.min() < 0 or indices.max() >= n):
            raise ValueError("malformed CSR: column index out of range")
        return cls(torch.from_numpy(indptr).to(device),
                   torch.from_numpy(indices).to(device),
                   torch.from_numpy(vals).to(device))

    @classmethod
    def from_coo(cls, rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                 n: int, device) -> "CsrMatrix":
        """An (n, n) CSR from a caller-supplied COO whose rows are sorted
        (duplicates are kept and summed by the SpMM, as a COO product
        sums them).  Validated like :meth:`from_numpy`."""
        rows = np.asarray(rows)
        n = int(n)
        if (n < 0 or rows.ndim != 1 or np.shape(cols) != rows.shape
                or np.shape(vals) != rows.shape):
            raise ValueError("malformed COO: rows/cols/vals disagree")
        if rows.size and (rows.min() < 0 or rows.max() >= n):
            raise ValueError("malformed COO: row index out of range")
        if rows.size > 1 and np.any(np.diff(rows) < 0):
            raise ValueError("malformed COO: rows must be sorted")
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(rows.astype(np.int64), minlength=n),
                  out=indptr[1:])
        return cls.from_numpy(indptr, cols, vals, device)

    @classmethod
    def transpose_from_coo(cls, rows: np.ndarray, cols: np.ndarray,
                           vals: np.ndarray, n: int, device) -> "CsrMatrix":
        """The CSR of Aᵀ for an (n, n) COO of A: the entries sorted by
        column with a stable argsort, so each row of Aᵀ keeps A's row
        order (cleora_tpu/algorithms.py:356-359)."""
        if not (np.shape(rows) == np.shape(cols) == np.shape(vals)):
            raise ValueError("malformed COO: rows/cols/vals disagree")
        order = np.argsort(cols, kind="stable")
        return cls.from_coo(np.asarray(cols)[order], np.asarray(rows)[order],
                            np.asarray(vals)[order], n, device)

    def with_vals(self, vals: torch.Tensor) -> "CsrMatrix":
        """The same sparsity pattern with other values, sharing the index
        tensors and, once built, the plain version's row index."""
        out = CsrMatrix(self.indptr, self.indices, vals)
        out._plain_index = self._plain_index
        return out

    @property
    def n_rows(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def nnz(self) -> int:
        return self.indices.shape[0]

    @property
    def device(self) -> torch.device:
        return self.indptr.device

    def plain_index(self):
        """(rows, cols) as int64, built once: ``index_select`` and
        ``index_add_`` need int64 indices."""
        if self._plain_index is None:
            counts = self.indptr[1:] - self.indptr[:-1]
            rows = torch.repeat_interleave(
                torch.arange(self.n_rows, device=self.device), counts)
            self._plain_index = (rows, self.indices.long())
        return self._plain_index


def spmm(csr: CsrMatrix, x: torch.Tensor, residual_weight: float = 0.0,
         residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``A @ x`` as float32, then ``(1-w)·y + w·r`` when w > 0, with
    ``r = residual`` (default ``x``; the sharded loop gathers from a table
    that is not the shard's state).  On CUDA this launches K1; on the CPU
    it runs :func:`spmm_plain`."""
    if x.is_cuda:
        return kernels.spmm_csr(
            csr.indptr, csr.indices, csr.vals, x.contiguous(),
            residual_weight,
            None if residual is None else residual.contiguous())
    return spmm_plain(csr, x, residual_weight, residual)


def spmm_plain(csr: CsrMatrix, x: torch.Tensor, residual_weight: float = 0.0,
               residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K1: gather, scale, ``index_add_`` — in
    edge chunks so the (chunk, D) intermediate stays bounded."""
    rows, cols = csr.plain_index()
    out = torch.zeros((csr.n_rows, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    chunk = max(1, _PLAIN_CHUNK_ELEMENTS // max(1, x.shape[1]))
    for s in range(0, csr.nnz, chunk):
        e = s + chunk
        scaled = x.index_select(0, cols[s:e]).float() * csr.vals[s:e, None]
        out.index_add_(0, rows[s:e], scaled)
    w = float(residual_weight)
    if w > 0.0:
        res = x if residual is None else residual
        out = (1.0 - w) * out + w * res[:csr.n_rows].float()
    return out


def spmm_axpy(csr: CsrMatrix, x: torch.Tensor, a: float, b: float = 0.0,
              z: Optional[torch.Tensor] = None, c: float = 0.0,
              acc: Optional[torch.Tensor] = None, d: float = 0.0,
              self_: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One step of the spectral recurrences: ``out = a·(A @ x) + b·s + c·z``
    as a new float32 tensor, and ``acc += d·out`` in place when ``acc`` is
    given, with ``s = self_`` (default ``x``; the sharded siblings gather
    from a table that is not the shard's own rows).  On CUDA this launches
    K5; on the CPU it runs :func:`spmm_axpy_plain`."""
    if x.is_cuda:
        return kernels.spmm_axpy(
            csr.indptr, csr.indices, csr.vals, x.contiguous(), a, b,
            None if z is None else z.contiguous(), c, acc, d,
            None if self_ is None else self_.contiguous())
    return spmm_axpy_plain(csr, x, a, b, z, c, acc, d, self_)


def spmm_axpy_plain(csr: CsrMatrix, x: torch.Tensor, a: float, b: float = 0.0,
                    z: Optional[torch.Tensor] = None, c: float = 0.0,
                    acc: Optional[torch.Tensor] = None, d: float = 0.0,
                    self_: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K5: :func:`spmm_plain`, then the terms in
    K5's order, each product and sum rounded to float32."""
    out = spmm_plain(csr, x).mul_(float(a))
    if float(b) != 0.0:
        out += float(b) * (x if self_ is None else self_)
    if z is not None:
        out += float(c) * z
    if acc is not None:
        acc += float(d) * out
    return out


def spmm_acc(acc: torch.Tensor, row_ids: torch.Tensor, indptr: torch.Tensor,
             cols: torch.Tensor, vals: torch.Tensor,
             table: torch.Tensor) -> torch.Tensor:
    """One round of the overlapped halo exchange
    (cleora_tpu/parallel/embed.py:_overlap_propagate, ``seg`` at :49-54):
    ``acc[row_ids[i]] += Σ_e vals[e]·table[cols[e]]`` over the edges of
    compact row ``i`` (``indptr``), in place on the float32 accumulator.
    On CUDA this launches K19 (``kernels/spmm_acc.cu``); on the CPU it
    runs :func:`spmm_acc_plain`.  Returns ``acc``."""
    if acc.is_cuda:
        return kernels.spmm_acc_(acc, row_ids, indptr, cols, vals,
                                 table.contiguous())
    return spmm_acc_plain(acc, row_ids, indptr, cols, vals, table)


def spmm_acc_plain(acc: torch.Tensor, row_ids: torch.Tensor,
                   indptr: torch.Tensor, cols: torch.Tensor,
                   vals: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K19: the round's per-row sums by gather,
    scale and ``index_add_`` (in edge chunks, as :func:`spmm_plain`), then
    one ``index_add_`` of them into ``acc``."""
    n = row_ids.shape[0]
    seg = torch.repeat_interleave(
        torch.arange(n, device=acc.device), indptr[1:] - indptr[:-1])
    sums = torch.zeros((n, acc.shape[1]), dtype=torch.float32,
                       device=acc.device)
    cols = cols.long()
    chunk = max(1, _PLAIN_CHUNK_ELEMENTS // max(1, acc.shape[1]))
    for s in range(0, cols.shape[0], chunk):
        e = s + chunk
        scaled = table.index_select(0, cols[s:e]).float() * vals[s:e, None]
        sums.index_add_(0, seg[s:e], scaled)
    return acc.index_add_(0, row_ids.long(), sums)
