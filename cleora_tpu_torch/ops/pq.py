"""Product-quantisation asymmetric-distance (ADC) scores on the device.

Counterpart of the gather-sum in the JAX package's batched PQ search
(cleora_tpu/compress.py:149-159): ``scores[q, i] = Σ_m tables[q, m,
codes[i, m]]``, the M gathers added in ``m`` order in float32.  On CUDA
:func:`pq_adc` launches kernel K13 (``kernels/pq_adc.cu``); on the CPU it
runs :func:`pq_adc_plain`, which adds in the same order, so the two agree
bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels


def device_codes(codes: np.ndarray, num_centroids: int,
                 device) -> torch.Tensor:
    """(N, M) PQ ``codes`` on ``device`` for :func:`pq_adc`: uint8 and
    uint16 as they are, anything else as int32.  Checked here, once, to
    lie in [0, num_centroids): K13 gathers ``tables[q, m, code]`` from
    shared memory and trusts every code."""
    codes = np.asarray(codes)
    if codes.size and (codes.min() < 0 or codes.max() >= num_centroids):
        raise ValueError(
            f"pq_adc: every code must lie in [0, {num_centroids})")
    if codes.dtype not in (np.uint8, np.uint16):
        codes = codes.astype(np.int32)
    return torch.from_numpy(np.ascontiguousarray(codes)).to(device)


def pq_adc(tables: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """float32 (Q, N) scores of float32 (Q, M, C) ``tables`` over (N, M)
    ``codes`` (uint8, uint16 or int32): K13 on CUDA, the plain version on
    the CPU."""
    if tables.is_cuda:
        return kernels.pq_adc(tables, codes)
    return pq_adc_plain(tables, codes)


def pq_topk(tables: torch.Tensor, codes: torch.Tensor, k: int):
    """``torch.topk`` of each query's scores (``k`` at most N): on CUDA
    over K13's whole padded rows (``kernels.pq_adc_rows``: contiguous, and
    -inf past N, so a padding column is never among the top k), on the CPU
    over the plain version's."""
    if tables.is_cuda:
        return torch.topk(kernels.pq_adc_rows(tables, codes), k, dim=1)
    return torch.topk(pq_adc_plain(tables, codes), k, dim=1)


def pq_adc_plain(tables: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K13: one (Q, N) gather per subspace, added
    in ``m`` order starting from the first gather."""
    idx = codes.to(torch.int64)
    scores = tables[:, 0, :][:, idx[:, 0]]
    for m in range(1, codes.shape[1]):
        scores = scores + tables[:, m, :][:, idx[:, m]]
    return scores
