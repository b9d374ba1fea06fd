"""Embedding compression: PCA, Gaussian random projection, and product
quantization with ADC search (reference: pycleora/compress.py).

Counterpart of cleora_tpu/compress.py, with the same names and host code.
``PQIndex.search_batch(backend="device")`` runs on the card (``device=None``
means CUDA; ``device="cpu"`` runs the plain PyTorch path; without a card and
without ``device="cpu"`` it raises): the (Q, M, C) inner-product tables are
a full-float32 ``torch.einsum``, the scores are kernel K13
(``kernels/pq_adc.cu``) and the top-k is ``torch.topk`` over them
(:func:`ops.pq.pq_topk`).  ``backend="host"`` is the JAX package's
vectorized numpy path, a path the caller chooses.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ._util import full_float32_matmul, resolve_device
from .ops.pq import device_codes, pq_topk


def pca_compress(embeddings: np.ndarray, target_dim: int) -> np.ndarray:
    """Centered SVD projection U_k·S_k (reference compress.py:5-15)."""
    if target_dim <= 0:
        raise ValueError(f"target_dim must be positive, got {target_dim}")
    if target_dim > embeddings.shape[1]:
        raise ValueError(
            f"target_dim ({target_dim}) cannot exceed embedding dimension "
            f"({embeddings.shape[1]})"
        )
    centered = embeddings - embeddings.mean(axis=0)
    u, s, _ = np.linalg.svd(centered, full_matrices=False)
    return u[:, :target_dim] * s[:target_dim]


def random_projection(
    embeddings: np.ndarray,
    target_dim: int,
    seed: Optional[int] = None,
) -> np.ndarray:
    """Gaussian projection scaled by 1/sqrt(k), legacy RandomState(seed)
    (reference compress.py:18-29)."""
    if target_dim <= 0:
        raise ValueError(f"target_dim must be positive, got {target_dim}")
    rng = np.random.RandomState(seed)
    P = rng.randn(embeddings.shape[1], target_dim) / np.sqrt(target_dim)
    return embeddings @ P


class PQIndex:
    """Product-quantized codes + per-subspace codebooks with asymmetric
    distance search (reference compress.py:32-98).  ``device`` is where
    ``search_batch(backend="device")`` runs."""

    def __init__(self, codes, codebooks, num_subspaces, subspace_dim,
                 original_shape, device=None):
        self._codes = codes
        self._codebooks = codebooks
        self._num_subspaces = num_subspaces
        self._subspace_dim = subspace_dim
        self._original_shape = original_shape
        self._device = device
        # (device, codes, normalized codebooks) uploaded at the first
        # device search
        self._adc_state = None

    def reconstruct(self, indices: Optional[np.ndarray] = None) -> np.ndarray:
        codes = self._codes if indices is None else self._codes[indices]
        parts = [
            self._codebooks[m, codes[:, m]] for m in range(self._num_subspaces)
        ]
        return np.concatenate(parts, axis=1).astype(np.float32)

    def search(self, query: np.ndarray, top_k: int = 10) -> Dict:
        if top_k <= 0:
            raise ValueError(f"top_k must be positive, got {top_k}")
        qn = np.linalg.norm(query)
        q = query / qn if qn > 1e-10 else query

        d = self._subspace_dim
        tables = np.empty(
            (self._num_subspaces, self._codebooks.shape[1]), dtype=np.float32
        )
        for m in range(self._num_subspaces):
            cb = self._codebooks[m]
            cb_n = cb / np.maximum(np.linalg.norm(cb, axis=1, keepdims=True), 1e-10)
            tables[m] = cb_n @ q[m * d:(m + 1) * d]

        n = self._codes.shape[0]
        scores = np.zeros(n, dtype=np.float32)
        for m in range(self._num_subspaces):
            scores += tables[m, self._codes[:, m]]

        k = min(top_k, n)
        top = np.argpartition(scores, -k)[-k:]
        top = top[np.argsort(scores[top])[::-1]]
        return {"indices": top, "scores": scores[top]}

    # --- batched ADC on the card (serving path; beyond reference) ---

    def _normalized_codebooks(self) -> np.ndarray:
        cb = self._codebooks
        return cb / np.maximum(
            np.linalg.norm(cb, axis=2, keepdims=True), 1e-10
        )

    def _device_state(self):
        """The codes (range-checked by ``device_codes``) and the normalized
        float32 codebooks on the resolved device, uploaded once per
        device."""
        dev = resolve_device(self._device)
        if self._adc_state is None or self._adc_state[0] != dev:
            self._adc_state = (
                dev,
                device_codes(self._codes, self._codebooks.shape[1], dev),
                torch.from_numpy(np.ascontiguousarray(
                    self._normalized_codebooks(), dtype=np.float32)).to(dev),
            )
        return self._adc_state

    def search_batch(self, queries: np.ndarray, top_k: int = 10,
                     backend: str = "device") -> Dict:
        """Batched asymmetric-distance search: same scoring as ``search``
        (normalized query vs normalized codebook entries, summed per
        subspace), for a (Q, dim) block of queries at once.

        ``backend="device"`` builds the tables with a full-float32
        ``torch.einsum``, scores with kernel K13 and takes ``torch.topk``,
        all on the index's device; ``"host"`` is a vectorized numpy
        equivalent.  Returns {"indices": (Q, k), "scores": (Q, k)} sorted
        descending per row.
        """
        if top_k <= 0:
            raise ValueError(f"top_k must be positive, got {top_k}")
        queries = np.asarray(queries, dtype=np.float32)
        if queries.ndim != 2:
            raise ValueError("queries must be a (Q, dim) 2D array")
        m, d = self._num_subspaces, self._subspace_dim
        if queries.shape[1] != m * d:
            raise ValueError(
                f"query dimension ({queries.shape[1]}) does not match index "
                f"dimension ({m * d})"
            )
        norms = np.linalg.norm(queries, axis=1, keepdims=True)
        qn = np.where(norms > 1e-10, queries / np.maximum(norms, 1e-10),
                      queries)
        qsub = qn.reshape(-1, m, d)
        k = min(top_k, self._codes.shape[0])

        if backend == "host":
            tables = np.einsum(
                "qmd,mcd->qmc", qsub, self._normalized_codebooks()
            ).astype(np.float32)
            scores = np.zeros((queries.shape[0], self._codes.shape[0]),
                              dtype=np.float32)
            for i in range(m):
                scores += tables[:, i, self._codes[:, i]]
            top = np.argpartition(scores, -k, axis=1)[:, -k:]
            row_scores = np.take_along_axis(scores, top, axis=1)
            order = np.argsort(row_scores, axis=1)[:, ::-1]
            return {
                "indices": np.take_along_axis(top, order, axis=1),
                "scores": np.take_along_axis(row_scores, order, axis=1),
            }
        if backend != "device":
            raise ValueError(
                f"Unknown backend: '{backend}'. Use 'device' or 'host'."
            )

        dev, codes_dev, cb_dev = self._device_state()
        q_dev = torch.from_numpy(np.ascontiguousarray(qsub)).to(dev)
        with full_float32_matmul():
            tables = torch.einsum("qmd,mcd->qmc", q_dev, cb_dev).contiguous()
        scores, idx = pq_topk(tables, codes_dev, k)
        return {"indices": idx.to(torch.int32).cpu().numpy(),
                "scores": scores.cpu().numpy()}


def product_quantize(
    embeddings: np.ndarray,
    num_subspaces: int = 8,
    num_centroids: int = 256,
    max_iter: int = 20,
    seed: Optional[int] = None,
    device=None,
) -> PQIndex:
    """Per-subspace k-means codebooks (reference compress.py:101-181);
    legacy RandomState(seed), codes uint8 when ≤256 centroids.  The
    k-means runs on the host, as in the JAX package; ``device`` is the
    returned index's search device."""
    if embeddings.ndim != 2 or embeddings.shape[0] == 0:
        raise ValueError("embeddings must be a non-empty 2D array")
    if num_subspaces <= 0:
        raise ValueError(f"num_subspaces must be positive, got {num_subspaces}")
    if num_centroids <= 0:
        raise ValueError(f"num_centroids must be positive, got {num_centroids}")
    if max_iter <= 0:
        raise ValueError(f"max_iter must be positive, got {max_iter}")

    n, dim = embeddings.shape
    if dim % num_subspaces != 0:
        raise ValueError(
            f"Embedding dimension ({dim}) must be divisible by num_subspaces "
            f"({num_subspaces})"
        )
    subspace_dim = dim // num_subspaces
    rng = np.random.RandomState(seed)

    codebooks = np.empty((num_subspaces, num_centroids, subspace_dim),
                         dtype=np.float32)
    codes = np.empty(
        (n, num_subspaces),
        dtype=np.uint8 if num_centroids <= 256 else np.uint16,
    )

    for m in range(num_subspaces):
        sub = embeddings[:, m * subspace_dim:(m + 1) * subspace_dim].astype(
            np.float32
        )
        init = rng.choice(n, size=min(num_centroids, n), replace=False)
        centroids = sub[init].copy()
        if num_centroids > n:
            extra = num_centroids - n
            centroids = np.vstack([
                centroids,
                sub[rng.choice(n, size=extra, replace=True)]
                + rng.randn(extra, subspace_dim).astype(np.float32) * 0.01,
            ])

        def assign(c):
            d2 = (
                np.sum(sub**2, axis=1, keepdims=True)
                - 2 * sub @ c.T
                + np.sum(c**2, axis=1)
            )
            return np.argmin(d2, axis=1)

        for _ in range(max_iter):
            a = assign(centroids)
            new_centroids = centroids.copy()
            for c in range(num_centroids):
                mask = a == c
                if mask.any():
                    new_centroids[c] = sub[mask].mean(axis=0)
            if np.allclose(centroids, new_centroids, atol=1e-6):
                centroids = new_centroids
                break
            centroids = new_centroids

        codes[:, m] = assign(centroids)
        codebooks[m] = centroids

    return PQIndex(codes, codebooks, num_subspaces, subspace_dim,
                   embeddings.shape, device=device)
