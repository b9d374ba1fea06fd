"""Embedding-space alignment (reference: pycleora/align.py).

Rows must correspond to the same entities in both matrices; entity alignment
between graphs is the caller's responsibility.

A copy of cleora_tpu/align.py (numpy only), held equal to it by
tests/test_torch_host_modules.py.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def procrustes(
    emb_source: np.ndarray,
    emb_target: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Orthogonal Procrustes: R minimizing ‖source·R − target‖_F
    (reference align.py:5-38).  Returns (source @ R, R)."""
    if emb_source.shape != emb_target.shape:
        raise ValueError(
            f"emb_source shape {emb_source.shape} does not match "
            f"emb_target shape {emb_target.shape}"
        )
    if emb_source.ndim != 2:
        raise ValueError("Embeddings must be 2-dimensional arrays")

    U, _, Vt = np.linalg.svd(emb_source.T @ emb_target)
    R = U @ Vt
    return (emb_source @ R).astype(np.float32), R.astype(np.float32)


def cca_align(
    emb_a: np.ndarray,
    emb_b: np.ndarray,
    n_components: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Canonical correlation projection into a shared space
    (reference align.py:40-109; regularized covariance, eigh inverse sqrt)."""
    if emb_a.shape[0] != emb_b.shape[0]:
        raise ValueError(
            f"emb_a has {emb_a.shape[0]} rows but emb_b has {emb_b.shape[0]} rows"
        )
    if emb_a.ndim != 2 or emb_b.ndim != 2:
        raise ValueError("Embeddings must be 2-dimensional arrays")

    n, d_a = emb_a.shape
    d_b = emb_b.shape[1]
    if n < 2:
        raise ValueError("CCA requires at least 2 samples (rows)")
    if n_components is None:
        n_components = min(d_a, d_b)
    if not isinstance(n_components, int) or n_components < 1:
        raise ValueError(
            f"n_components must be a positive integer, got {n_components}"
        )
    if n_components > min(d_a, d_b):
        raise ValueError(
            f"n_components ({n_components}) cannot exceed min(d_a, d_b) = "
            f"{min(d_a, d_b)}"
        )

    a_c = emb_a - emb_a.mean(axis=0)
    b_c = emb_b - emb_b.mean(axis=0)
    reg = 1e-8
    C_aa = (a_c.T @ a_c) / (n - 1) + reg * np.eye(d_a)
    C_bb = (b_c.T @ b_c) / (n - 1) + reg * np.eye(d_b)
    C_ab = (a_c.T @ b_c) / (n - 1)

    Wa_inv = _inv_sqrt(C_aa)
    Wb_inv = _inv_sqrt(C_bb)
    U, _, Vt = np.linalg.svd(Wa_inv @ C_ab @ Wb_inv, full_matrices=False)

    W_a = Wa_inv @ U[:, :n_components]
    W_b = Wb_inv @ Vt[:n_components, :].T
    return (a_c @ W_a).astype(np.float32), (b_c @ W_b).astype(np.float32)


def alignment_score(emb_a: np.ndarray, emb_b: np.ndarray) -> float:
    """Mean per-row cosine similarity after Procrustes alignment
    (reference align.py:112-136)."""
    aligned_a, _ = procrustes(emb_a, emb_b)
    na = np.maximum(np.linalg.norm(aligned_a, axis=1, keepdims=True), 1e-10)
    nb = np.maximum(np.linalg.norm(emb_b, axis=1, keepdims=True), 1e-10)
    return float(np.mean(np.sum((aligned_a / na) * (emb_b / nb), axis=1)))


def _inv_sqrt(M: np.ndarray) -> np.ndarray:
    w, v = np.linalg.eigh(M)
    w = np.maximum(w, 1e-10)
    return v @ np.diag(1.0 / np.sqrt(w)) @ v.T
