"""One iteration of ``embed_with_attention``.

Reference semantics: the ``attention_step`` closure of the JAX package's
``embed_with_attention`` (cleora_tpu/__init__.py:501-534), itself the
reference's pycleora/__init__.py:206-276.  Per iteration: the edge
weights (cosine score of each edge over T, a row softmax over the edges
whose Markov value is not 0, reweighting by the Markov value and row
renormalisation), the SpMM of ``x`` with those weights as the values,
normalisation and optional whitening.

On CUDA, up to ``kernels.FUSED_NORM_MAX_WIDTH`` columns, one pass
computes all of it but the whitening (:func:`attention_spmm`, the fused
kernel in ``kernels/edge_attention.cu``, with l2/l1 normalisation in its
epilogue).  Wider rows take the weights kernel K4, which reads ``x``
itself and normalises its rows in registers, then K1 with those weights,
then K2.  On the CPU the plain versions run.
"""

from __future__ import annotations

import torch

from .. import kernels
from .normalize import l2_normalize_plain, normalize, normalize_plain
from .spmm import CsrMatrix, spmm, spmm_plain
from .whiten import whiten

EPS = 1e-10
# edges per chunk of the plain version's (chunk, D) score intermediates
_PLAIN_CHUNK_EDGES = 1 << 21


def edge_attention_weights(csr: CsrMatrix, x: torch.Tensor,
                           temperature: float) -> torch.Tensor:
    """The (nnz,) float32 attention weights of the state ``x`` (its rows
    l2-normalised: the scores are cosines): K4 on CUDA,
    :func:`edge_attention_weights_plain` on the CPU."""
    if x.is_cuda:
        return kernels.edge_attention(csr.indptr, csr.indices, csr.vals,
                                      x.contiguous(), temperature,
                                      csr.hub_plan())
    return edge_attention_weights_plain(csr, x, temperature)


def edge_attention_weights_plain(csr: CsrMatrix, x: torch.Tensor,
                                 temperature: float) -> torch.Tensor:
    """Plain PyTorch version of K4: ``x`` l2-normalised on a float32 copy,
    then the JAX version's segment ops: scores in edge chunks, then
    ``scatter_reduce("amax")`` and ``index_add_`` per row."""
    xn = l2_normalize_plain(x.to(torch.float32, copy=True))
    rows, cols = csr.plain_index()
    n = csr.n_rows
    t = torch.tensor(temperature, dtype=torch.float32)
    scores = torch.empty(csr.nnz, dtype=torch.float32, device=xn.device)
    for s in range(0, csr.nnz, _PLAIN_CHUNK_EDGES):
        e = s + _PLAIN_CHUNK_EDGES
        scores[s:e] = torch.sum(xn.index_select(0, rows[s:e])
                                * xn.index_select(0, cols[s:e]), dim=1) / t
    valid = csr.vals != 0.0
    masked = torch.where(valid, scores, float("-inf"))
    row_max = torch.full((n,), float("-inf"), device=xn.device).scatter_reduce(
        0, rows, masked, "amax")
    row_max = torch.where(torch.isfinite(row_max), row_max, 0.0)
    exp_scores = torch.where(valid, torch.exp(masked - row_max[rows]), 0.0)
    denom = torch.zeros(n, device=xn.device).index_add_(0, rows, exp_scores)
    weighted = exp_scores / torch.clamp_min(denom, EPS)[rows] * csr.vals
    wsum = torch.zeros(n, device=xn.device).index_add_(0, rows, weighted)
    return weighted / torch.clamp_min(wsum, EPS)[rows]


def attention_spmm(csr: CsrMatrix, x: torch.Tensor, temperature: float,
                   normalization: str = "none") -> torch.Tensor:
    """The attention-weighted propagate of one iteration, each row then
    divided by max(its ``"l2"`` or ``"l1"`` norm, 1e-10) for those
    ``normalization`` modes: the fused kernel on CUDA (float32 ``x`` of
    at most ``kernels.FUSED_NORM_MAX_WIDTH`` columns),
    :func:`attention_spmm_plain` on the CPU."""
    if x.is_cuda:
        return kernels.attention_spmm(csr.indptr, csr.indices, csr.vals,
                                      x.contiguous(), temperature,
                                      normalization, csr.hub_plan())
    return attention_spmm_plain(csr, x, temperature, normalization)


def attention_spmm_plain(csr: CsrMatrix, x: torch.Tensor, temperature: float,
                         normalization: str = "none") -> torch.Tensor:
    """Plain PyTorch version of the fused pass: the weights
    (:func:`edge_attention_weights_plain`, on an l2-normalised copy of
    ``x``), :func:`~.spmm.spmm_plain` with them, then the
    normalisation."""
    weights = edge_attention_weights_plain(csr, x, temperature)
    return normalize_plain(spmm_plain(csr.with_vals(weights), x),
                           normalization)


def attention_step(csr: CsrMatrix, x: torch.Tensor, temperature: float,
                   normalization: str = "l2",
                   do_whiten: bool = False) -> torch.Tensor:
    """One attention iteration on the float32 state ``x``."""
    fused = normalization if normalization in ("l2", "l1") else "none"
    if x.is_cuda and x.shape[1] <= kernels.FUSED_NORM_MAX_WIDTH:
        y = attention_spmm(csr, x, temperature, fused)
    else:
        weights = edge_attention_weights(csr, x, temperature)
        y = spmm(csr.with_vals(weights), x, normalization=fused)
    if fused == "none":
        y = normalize(y, normalization)
    if do_whiten:
        y = whiten(y)
    return y
