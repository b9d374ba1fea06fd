"""Sparse matrix × dense embedding propagation (SpMM) on a CSR matrix.

``out[i] = Σ_{edges (i→j)} value · x[j]`` (reference semantics:
``spmm_kernel``, src/embedding.rs:52-86).  The matrix stays in CSR in its
original row order: kernel K1 (``kernels/spmm_csr.cu``) keeps each row's
sum in registers, so none of the JAX package's ELL, banded or edge-cut
layouts and none of their row relabelling is needed here.  K1 also
normalises each row in its epilogue (``normalization="l2"``/``"l1"``),
and cuts the rows of more than ``kernels.LONG_SLICE`` entries into slices
(the matrix's :meth:`CsrMatrix.hub_plan`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import kernels
from .normalize import normalize, normalize_plain

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
        self._row_plan = None
        self._hub_plan: Optional[kernels.HubPlan] = None

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
        out._row_plan = self._row_plan
        out._hub_plan = self._hub_plan
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

    def row_plan(self) -> Optional[kernels.RowPlan]:
        """The :class:`kernels.RowPlan` of this matrix (its non-empty rows,
        and their slices for K5's long-row kernel), built once, or None when
        some row's column indices do not ascend: K5 then touches only these
        rows (:func:`spmm_accumulate_`)."""
        if self._row_plan is None:
            plan = kernels.row_plan(self.indptr, self.indices,
                                    self.hub_plan())
            self._row_plan = False if plan is None else plan
        return self._row_plan if self._row_plan is not False else None

    def hub_plan(self) -> kernels.HubPlan:
        """The :class:`kernels.HubPlan` of this matrix (the slices of its
        rows of more than ``kernels.LONG_SLICE`` entries), built once on
        its device; every row's cut depends on its own length alone."""
        if self._hub_plan is None:
            self._hub_plan = kernels.hub_plan(self.indptr)
        return self._hub_plan

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
         residual: Optional[torch.Tensor] = None,
         normalization: str = "none") -> torch.Tensor:
    """``A @ x`` as float32, then ``(1-w)·y + w·r`` when w > 0, with
    ``r = residual`` (default ``x``; the sharded loop gathers from a table
    that is not the shard's state), then each row divided by max(its
    ``"l2"`` or ``"l1"`` norm, 1e-10) for those ``normalization`` modes
    (``"none"`` leaves it).  On CUDA this launches K1, with the
    normalisation in its epilogue up to ``kernels.FUSED_NORM_MAX_WIDTH``
    columns and by K2 after it for wider rows; on the CPU it runs
    :func:`spmm_plain` and then the plain normalisation."""
    if normalization not in ("none", "l2", "l1"):
        raise ValueError(f"spmm: unknown normalization {normalization}")
    if x.is_cuda:
        fused = x.shape[1] <= kernels.FUSED_NORM_MAX_WIDTH
        y = kernels.spmm_csr(
            csr.indptr, csr.indices, csr.vals, x.contiguous(),
            residual_weight,
            None if residual is None else residual.contiguous(),
            normalization if fused else "none", csr.hub_plan())
        return y if fused else normalize(y, normalization)
    return normalize_plain(spmm_plain(csr, x, residual_weight, residual),
                           normalization)


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


def spmm_accumulate_(csr: CsrMatrix, x: torch.Tensor,
                     acc: torch.Tensor) -> torch.Tensor:
    """``acc += A @ x`` in place (float32), touching only A's non-empty
    rows where :meth:`CsrMatrix.row_plan` lists them: K5 with ``acc`` and
    no ``out`` on CUDA (``a = d = 1``); on the CPU
    :func:`spmm_axpy_plain`.  Returns ``acc``."""
    if x.is_cuda:
        rows = csr.row_plan()
        kernels.spmm_axpy(csr.indptr, csr.indices, csr.vals, x.contiguous(),
                          1.0, acc=acc, d=1.0, rows=rows)
    else:
        spmm_axpy_plain(csr, x, 1.0, acc=acc, d=1.0)
    return acc


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


def spmm_acc(acc: torch.Tensor, row_ids: Optional[torch.Tensor],
             indptr: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
             table: torch.Tensor, write: bool = False,
             residual_weight: float = 0.0,
             residual: Optional[torch.Tensor] = None,
             normalization: str = "none",
             hubs: Optional[kernels.HubPlan] = None) -> torch.Tensor:
    """One round of the overlapped halo exchange
    (cleora_tpu/parallel/embed.py:_overlap_propagate, ``seg`` at :49-54),
    in place on the float32 accumulator: the round's sum of
    ``vals[e]·table[cols[e]]`` over the edges of the view's row ``i``
    (``indptr``) written into (``write``) or added to row ``row_ids[i]``
    of ``acc`` (row ``i`` when ``row_ids`` is None: a view of every row),
    then, for the last round, ``(1-w)·acc + w·residual`` when w > 0 and
    each row divided by max(its ``"l2"`` or ``"l1"`` norm, 1e-10).  On
    CUDA this launches K19 (``kernels/spmm_acc.cu``; ``hubs``, the view's
    :class:`kernels.HubPlan`, cuts its hub rows into slices), with the
    normalisation in its epilogue up to ``kernels.FUSED_NORM_MAX_WIDTH``
    columns and by K2 after it for wider rows; on the CPU it runs
    :func:`spmm_acc_plain`.  Returns ``acc``."""
    if normalization not in ("none", "l2", "l1"):
        raise ValueError(f"spmm_acc: unknown normalization {normalization}")
    if acc.is_cuda:
        fused = acc.shape[1] <= kernels.FUSED_NORM_MAX_WIDTH
        kernels.spmm_acc_(
            acc, row_ids, indptr, cols, vals, table.contiguous(), write,
            residual_weight,
            None if residual is None else residual.contiguous(),
            normalization if fused else "none", hubs)
        return acc if fused else normalize(acc, normalization)
    return spmm_acc_plain(acc, row_ids, indptr, cols, vals, table, write,
                          residual_weight, residual, normalization)


def spmm_acc_plain(acc: torch.Tensor, row_ids: Optional[torch.Tensor],
                   indptr: torch.Tensor, cols: torch.Tensor,
                   vals: torch.Tensor, table: torch.Tensor,
                   write: bool = False, residual_weight: float = 0.0,
                   residual: Optional[torch.Tensor] = None,
                   normalization: str = "none") -> torch.Tensor:
    """Plain PyTorch version of K19 in the order of the chain it replaced
    (a zero accumulator, the rounds' sums, the residual mix, the row
    normalisation): the round's per-row sums by gather, scale and
    ``index_add_`` (in edge chunks, as :func:`spmm_plain`), written into
    or added to ``acc``, then mixed and normalised in place."""
    n = indptr.shape[0] - 1
    if row_ids is None and n != acc.shape[0]:
        raise ValueError("spmm_acc: a view without row_ids must list every "
                         "row of acc")
    w = float(residual_weight)
    if row_ids is not None and (write or w > 0.0
                                or normalization != "none"):
        raise ValueError("spmm_acc: write, the residual and the "
                         "normalisation need a view of every row "
                         "(row_ids=None)")
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
    if row_ids is not None:
        acc.index_add_(0, row_ids.long(), sums)
    elif write:
        acc.copy_(sums)
    else:
        acc.add_(sums)
    if w > 0.0:
        acc.copy_((1.0 - w) * acc + w * residual.float())
    normalize_plain(acc, normalization)
    return acc
