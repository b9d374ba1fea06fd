"""Embedding iteration loops.

Reference semantics: ``embed_full`` / ``embed_full_with_convergence``
(src/embedding.rs:106-188) — per iteration: SpMM propagate → optional
residual mix ((1-w)·y + w·x) → row-normalize → optional PCA whitening.  The
convergence variant checks RMSE(new, old) = sqrt(Σδ²/(N·D)) < threshold
after the first iteration.

PyTorch runs eagerly, so the loop is a plain Python loop over iterations;
each step is K1 (residual and, for l2/l1 up to 1,024 columns, the row
normalisation fused) → whiten on CUDA.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .normalize import normalize
from .spmm import CsrMatrix, spmm
from .whiten import whiten


def effective_residual_weight(w: float, rust_fast_semantics: bool) -> float:
    """The reference has TWO residual behaviors: its Rust fast path applies
    the mix only for 0 < w < 1 (src/embedding.rs:121-129), while its Python
    slow path — taken whenever whitening / a callback / non-l2 normalization
    / initial embeddings are in play (pycleora/__init__.py:70-96) — applies
    it for ANY w > 0.  Callers pass the semantics their entry point mirrors;
    the loop then applies any non-zero weight it receives."""
    w = float(w)
    if w <= 0.0 or (rust_fast_semantics and w >= 1.0):
        return 0.0
    return w


def embed_step(csr: CsrMatrix, x: torch.Tensor, residual_weight: float = 0.0,
               normalization: str = "l2", do_whiten: bool = False) -> torch.Tensor:
    """One iteration.  bf16 storage: propagate, normalize and whiten
    compute in float32, then the state is stored back at x's dtype."""
    fused = normalization if normalization in ("l2", "l1") else "none"
    y = spmm(csr, x, residual_weight, normalization=fused)
    if fused == "none":
        y = normalize(y, normalization)
    if do_whiten:
        y = whiten(y)
    return y.to(x.dtype)


def embed_loop(csr: CsrMatrix, x0: torch.Tensor, num_iterations: int,
               residual_weight: float = 0.0, normalization: str = "l2",
               do_whiten: bool = False) -> torch.Tensor:
    """num_iterations × [SpMM → residual → normalize → (whiten)]."""
    x = x0
    for _ in range(int(num_iterations)):
        x = embed_step(csr, x, residual_weight, normalization, do_whiten)
    return x


def rmse(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """sqrt(Σδ²/(N·D)) as a 0-d tensor in the storage dtype, as the JAX
    loop computes it (cleora_tpu/ops/loop.py:125-126): under bf16 storage
    the difference, the sum and the root are all bf16, and the caller
    compares the result with the threshold in bf16 too."""
    diff = y - x
    # float32 accumulation, then each step rounds to the storage dtype (N·D
    # too), which is how XLA evaluates the JAX loop's bf16 expression
    total = torch.sum(diff * diff, dtype=torch.float32).to(diff.dtype)
    count = torch.tensor(diff.numel(), dtype=diff.dtype, device=diff.device)
    return torch.sqrt(total / count)


def embed_loop_convergence(csr: CsrMatrix, x0: torch.Tensor,
                           max_iterations: int, residual_weight: float = 0.0,
                           convergence_threshold: float = 0.0,
                           normalization: str = "l2",
                           do_whiten: bool = False) -> Tuple[torch.Tensor, int]:
    """Iterate until RMSE(x_new, x_old) < threshold (checked from iter 1 on).

    Returns (embeddings, actual_iterations).  Mirrors
    embed_full_with_convergence (src/embedding.rs:138-188): the check runs
    only when iter > 0, and on early stop actual_iterations = iter + 1.
    """
    x = x0
    for i in range(int(max_iterations)):
        y = embed_step(csr, x, residual_weight, normalization, do_whiten)
        done = i > 0 and bool(rmse(y, x) < convergence_threshold)
        x = y
        if done:
            return x, i + 1
    return x, int(max_iterations)
