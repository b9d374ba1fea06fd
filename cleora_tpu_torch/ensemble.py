"""Embedding combination (reference: pycleora/ensemble.py).

Rows must correspond to the same entities across all input matrices; entity
alignment between graphs is the caller's responsibility.

A copy of cleora_tpu/ensemble.py (numpy only), held equal to it by
tests/test_torch_host_modules.py.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def combine(
    embeddings_list: List[np.ndarray],
    method: str = "concat",
    weights: Optional[List[float]] = None,
    target_dim: Optional[int] = None,
) -> np.ndarray:
    """concat / mean / weighted / svd combination of embedding matrices
    (reference ensemble.py:5-92)."""
    if not embeddings_list:
        raise ValueError("embeddings_list must be non-empty")

    n_rows = embeddings_list[0].shape[0]
    for i, emb in enumerate(embeddings_list):
        if emb.ndim != 2:
            raise ValueError(f"Embedding at index {i} is not 2-dimensional")
        if emb.shape[0] != n_rows:
            raise ValueError(
                f"Embedding at index {i} has {emb.shape[0]} rows, expected {n_rows}"
            )

    if method == "concat":
        return np.concatenate(embeddings_list, axis=1).astype(np.float32)

    if method == "mean":
        _require_same_dims(embeddings_list)
        return np.stack(embeddings_list).mean(axis=0).astype(np.float32)

    if method == "weighted":
        _require_same_dims(embeddings_list)
        if weights is None:
            raise ValueError("weights parameter is required for method='weighted'")
        if len(weights) != len(embeddings_list):
            raise ValueError(
                f"weights has {len(weights)} elements but embeddings_list has "
                f"{len(embeddings_list)} elements"
            )
        w_sum = sum(weights)
        if w_sum <= 0:
            raise ValueError("weights must sum to a positive value")
        out = np.zeros_like(embeddings_list[0], dtype=np.float64)
        for w, emb in zip(weights, embeddings_list):
            out += (w / w_sum) * emb
        return out.astype(np.float32)

    if method == "svd":
        if target_dim is None:
            raise ValueError("target_dim parameter is required for method='svd'")
        if not isinstance(target_dim, int) or target_dim < 1:
            raise ValueError(
                f"target_dim must be a positive integer, got {target_dim}"
            )
        X = np.concatenate(embeddings_list, axis=1).astype(np.float64)
        centered = X - X.mean(axis=0)
        U, S, _ = np.linalg.svd(centered, full_matrices=False)
        k = min(target_dim, U.shape[1])
        reduced = U[:, :k] * S[:k]
        if k < target_dim:
            reduced = np.concatenate(
                [reduced, np.zeros((n_rows, target_dim - k))], axis=1
            )
        return reduced.astype(np.float32)

    raise ValueError(
        f"Unknown method '{method}'. Supported methods: 'concat', 'mean', "
        f"'weighted', 'svd'"
    )


def _require_same_dims(embeddings_list: List[np.ndarray]) -> None:
    dims = embeddings_list[0].shape[1]
    for i, emb in enumerate(embeddings_list):
        if emb.shape[1] != dims:
            raise ValueError(
                f"Embedding at index {i} has {emb.shape[1]} columns, expected "
                f"{dims}. All embeddings must have the same dimensions for "
                f"this method."
            )
