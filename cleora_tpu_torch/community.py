"""Community detection (reference: pycleora/community.py).

Counterpart of cleora_tpu/community.py, with the same names and host code.
kmeans/spectral cosine k-means keep the reference's rng(seed) centroid init
and assignment rule; above ``n·d > 2¹⁸`` the similarity product and its
argmax run on the card (``device=None`` means CUDA; ``device="cpu"`` runs
the same PyTorch calls on the CPU; without a card and without
``device="cpu"`` it raises), in full float32.  Louvain is the reference's
single-level modularity pass (inherently sequential — host).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ._util import full_float32_matmul, resolve_device


def _cosine_kmeans(normed: np.ndarray, k: int, max_iterations: int, seed: int,
                   device=None):
    """Cosine k-means with first-improvement argmax assignment; centroid init
    = rng(seed).choice like the reference (community.py:22-45)."""
    n = normed.shape[0]
    rng = np.random.default_rng(seed)
    centroids = normed[rng.choice(n, size=k, replace=False)].copy()

    use_device = n * normed.shape[1] > 1 << 18
    if use_device:
        x = torch.from_numpy(np.ascontiguousarray(
            normed, dtype=np.float32)).to(resolve_device(device))

        def assign(c: np.ndarray) -> np.ndarray:
            # full float32 product: TF32 keeps ten mantissa bits, which can
            # flip the argmax for near-tied centroids and make the device
            # path diverge from the numpy path / the reference
            c = torch.from_numpy(np.ascontiguousarray(
                c, dtype=np.float32)).to(x.device)
            with full_float32_matmul():
                return torch.argmax(x @ c.T, dim=1).cpu().numpy()
    labels = np.zeros(n, dtype=np.int32)
    for _ in range(max_iterations):
        if use_device:
            new_labels = assign(centroids)
        else:
            new_labels = np.argmax(normed @ centroids.T, axis=1)
        if np.all(new_labels == labels):
            break
        labels = new_labels
        for i in range(k):
            mask = labels == i
            if mask.any():
                c = normed[mask].mean(axis=0)
                cn = np.linalg.norm(c)
                if cn > 1e-10:
                    centroids[i] = c / cn
    return labels


def _row_normalize(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-10)


def detect_communities_kmeans(
    graph,
    embeddings: np.ndarray,
    k: int,
    max_iterations: int = 100,
    seed: int = 42,
    device=None,
) -> Dict[str, int]:
    """k-means on L2-normalized embeddings (reference community.py:5-48)."""
    n = embeddings.shape[0]
    if k < 2:
        raise ValueError("k must be at least 2")
    if k > n:
        raise ValueError(f"k ({k}) cannot be larger than number of entities ({n})")
    labels = _cosine_kmeans(_row_normalize(embeddings), k, max_iterations, seed,
                            device)
    return {eid: int(labels[i]) for i, eid in enumerate(graph.entity_ids)}


def detect_communities_spectral(
    graph,
    embeddings: np.ndarray,
    k: int,
    seed: int = 42,
    device=None,
) -> Dict[str, int]:
    """SVD spectral features + cosine k-means (reference community.py:51-92)."""
    normed = _row_normalize(embeddings)
    u, s, _ = np.linalg.svd(normed, full_matrices=False)
    spectral = _row_normalize(u[:, :k] * s[:k])
    labels = _cosine_kmeans(spectral, k, 100, seed, device)
    return {eid: int(labels[i]) for i, eid in enumerate(graph.entity_ids)}


def detect_communities_louvain(
    graph,
    resolution: float = 1.0,
) -> Dict[str, int]:
    """Single-level Louvain modularity optimization, max 50 passes, unit edge
    weights, self-loops skipped (reference community.py:95-178)."""
    rows, cols, _, n, _ = graph.to_sparse_csr()
    rows = rows.astype(np.int64)
    cols = cols.astype(np.int64)
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]

    # neighbor dicts with unit weights merged per (node, neighbor); the
    # accumulation is order-independent, so no edge sort is needed
    adj: Dict[int, Dict[int, float]] = {}
    for r, c in zip(rows, cols):
        adj.setdefault(int(r), {})
        adj[int(r)][int(c)] = adj[int(r)].get(int(c), 0.0) + 1.0

    degrees = np.zeros(n, dtype=np.float64)
    for r, nbrs in adj.items():
        degrees[r] = sum(nbrs.values())
    total_weight = degrees.sum()
    if total_weight < 1e-10:
        return {eid: 0 for eid in graph.entity_ids}

    m = total_weight / 2.0
    community = list(range(n))
    sigma_tot = {i: degrees[i] for i in range(n)}

    for _ in range(50):
        improved = False
        for node in range(n):
            current = community[node]
            ki = degrees[node]
            ki_in: Dict[int, float] = {}
            for nb, w in adj.get(node, {}).items():
                c = community[nb]
                ki_in[c] = ki_in.get(c, 0.0) + w

            sigma_tot[current] -= ki
            delta_remove = (
                ki_in.get(current, 0.0) / m
                - resolution * ki * sigma_tot.get(current, 0.0) / (2.0 * m * m)
            )
            best_comm, best_delta = current, 0.0
            for comm, kic in ki_in.items():
                if comm == current:
                    continue
                delta = (
                    kic / m
                    - resolution * ki * sigma_tot.get(comm, 0.0) / (2.0 * m * m)
                ) - delta_remove
                if delta > best_delta:
                    best_delta, best_comm = delta, comm

            if best_comm != current:
                community[node] = best_comm
                sigma_tot[best_comm] = sigma_tot.get(best_comm, 0.0) + ki
                improved = True
            else:
                sigma_tot[current] += ki
        if not improved:
            break

    relabel: Dict[int, int] = {}
    out = {}
    for i, eid in enumerate(graph.entity_ids):
        c = community[i]
        if c not in relabel:
            relabel[c] = len(relabel)
        out[eid] = relabel[c]
    return out


def modularity(graph, communities: Dict[str, int]) -> float:
    """Q = (1/2m) Σ_{ij in same community} (A_ij − k_i k_j / 2m) with unit
    weights over directed entries (reference community.py:181-210)."""
    rows, cols, _, n, _ = graph.to_sparse_csr()
    rows = rows.astype(np.int64)
    cols = cols.astype(np.int64)
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]

    degrees = np.bincount(rows, minlength=n).astype(np.float64)
    total_weight = float(rows.shape[0])
    if total_weight < 1e-10:
        return 0.0

    index_map = {eid: i for i, eid in enumerate(graph.entity_ids)}
    comm = np.zeros(n, dtype=np.int64)
    for eid, c in communities.items():
        i = index_map.get(eid)
        if i is not None:
            comm[i] = c

    same = comm[rows] == comm[cols]
    Q = np.sum(same * (1.0 - degrees[rows] * degrees[cols] / total_weight))
    return float(Q / total_weight)
