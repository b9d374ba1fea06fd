"""Graph statistics (reference: pycleora/stats.py).

Same outputs, vectorized: BFS runs as whole-frontier sparse matvecs instead
of per-node Python loops; betweenness is Brandes over CSR index arrays.

A copy of cleora_tpu/stats.py (numpy and scipy only), held equal to it by
tests/test_torch_host_modules.py.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def _sym_bool_csr(graph):
    """Symmetrized boolean adjacency, self-loops removed
    (reference stats.py:15-19)."""
    from scipy.sparse import csr_matrix

    rows, cols, vals, n, _ = graph.to_sparse_csr()
    A = csr_matrix(
        (vals.astype(np.float64), (rows.astype(np.int64), cols.astype(np.int64))),
        shape=(n, n),
    )
    S = ((A + A.T) > 0).astype(np.float64)
    S.setdiag(0)
    S.eliminate_zeros()
    return S


def degree_distribution(graph) -> List[int]:
    """hist[i] = count of nodes with (symmetrized) degree i
    (reference stats.py:22-30)."""
    S = _sym_bool_csr(graph)
    degrees = np.asarray(S.sum(axis=1)).ravel().astype(int)
    if len(degrees) == 0:
        return [0]
    return np.bincount(degrees, minlength=int(degrees.max()) + 1).tolist()


def clustering_coefficient(graph) -> float:
    """Average local clustering coefficient (reference stats.py:33-54)."""
    S = _sym_bool_csr(graph)
    n = S.shape[0]
    if n == 0:
        return 0.0
    triangles = np.asarray(S.multiply(S @ S).sum(axis=1)).ravel()
    degrees = np.asarray(S.sum(axis=1)).ravel()
    mask = degrees >= 2
    if not mask.any():
        return 0.0
    cc = triangles[mask] / (degrees[mask] * (degrees[mask] - 1))
    return float(cc.sum() / mask.sum())


def connected_components(graph) -> List[List[int]]:
    """Components as lists of node indices, discovered in BFS order from the
    lowest unvisited index (reference stats.py:57-82); frontier BFS via
    sparse matvec."""
    S = _sym_bool_csr(graph)
    n = S.shape[0]
    visited = np.zeros(n, dtype=bool)
    components = []
    indptr, indices = S.indptr, S.indices
    for start in range(n):
        if visited[start]:
            continue
        frontier = [start]
        visited[start] = True
        component = [start]
        while frontier:
            nxt = []
            for v in frontier:
                for nb in indices[indptr[v]:indptr[v + 1]]:
                    if not visited[nb]:
                        visited[nb] = True
                        nxt.append(int(nb))
            component.extend(nxt)
            frontier = nxt
        components.append(component)
    return components


def _bfs_dists(indptr, indices, start, node_mask, n):
    dist = np.full(n, -1, dtype=np.int64)
    dist[start] = 0
    frontier = np.array([start])
    d = 0
    while frontier.size:
        d += 1
        nxt = np.unique(
            np.concatenate(
                [indices[indptr[v]:indptr[v + 1]] for v in frontier]
            )
        )
        nxt = nxt[(dist[nxt] == -1) & node_mask[nxt]]
        dist[nxt] = d
        frontier = nxt
    return dist


def diameter(graph) -> int:
    """Diameter of the largest connected component (reference stats.py:85-114)."""
    S = _sym_bool_csr(graph)
    comps = connected_components(graph)
    if not comps:
        return 0
    largest = max(comps, key=len)
    if len(largest) <= 1:
        return 0
    n = S.shape[0]
    node_mask = np.zeros(n, dtype=bool)
    node_mask[largest] = True
    indptr, indices = S.indptr, S.indices
    return int(
        max(
            _bfs_dists(indptr, indices, v, node_mask, n).max()
            for v in largest
        )
    )


def betweenness_centrality(graph, top_k: int = 10) -> Dict[str, float]:
    """Brandes betweenness over the symmetrized graph, halved, top-K
    (reference stats.py:117-159)."""
    S = _sym_bool_csr(graph)
    n = S.shape[0]
    if n == 0:
        return {}
    indptr, indices = S.indptr, S.indices
    centrality = np.zeros(n, dtype=np.float64)

    for s in range(n):
        stack = []
        preds: List[List[int]] = [[] for _ in range(n)]
        sigma = np.zeros(n, dtype=np.float64)
        sigma[s] = 1.0
        dist = np.full(n, -1, dtype=np.int64)
        dist[s] = 0
        queue = [s]
        qi = 0
        while qi < len(queue):
            v = queue[qi]
            qi += 1
            stack.append(v)
            for w in indices[indptr[v]:indptr[v + 1]]:
                if dist[w] == -1:
                    dist[w] = dist[v] + 1
                    queue.append(int(w))
                if dist[w] == dist[v] + 1:
                    sigma[w] += sigma[v]
                    preds[w].append(v)

        delta = np.zeros(n, dtype=np.float64)
        for w in reversed(stack):
            for v in preds[w]:
                delta[v] += (sigma[v] / sigma[w]) * (1.0 + delta[w])
            if w != s:
                centrality[w] += delta[w]

    centrality /= 2.0
    top = np.argsort(centrality)[::-1][:top_k]
    ids = graph.entity_ids
    return {ids[i]: float(centrality[i]) for i in top}


def pagerank(
    graph,
    top_k: int = 10,
    damping: float = 0.85,
    max_iter: int = 100,
    tol: float = 1e-6,
) -> Dict[str, float]:
    """Power iteration with dangling-mass redistribution
    (reference stats.py:162-190)."""
    from scipy.sparse import diags

    S = _sym_bool_csr(graph)
    n = S.shape[0]
    if n == 0:
        return {}
    out_degree = np.asarray(S.sum(axis=1)).ravel()
    dangling = out_degree == 0
    safe = np.where(dangling, 1.0, out_degree)
    M = (diags(1.0 / safe) @ S).T

    pr = np.full(n, 1.0 / n)
    for _ in range(max_iter):
        new_pr = (1 - damping + damping * pr[dangling].sum()) / n + damping * (M @ pr)
        if np.linalg.norm(new_pr - pr, ord=1) < tol:
            pr = new_pr
            break
        pr = new_pr

    top = np.argsort(pr)[::-1][:top_k]
    ids = graph.entity_ids
    return {ids[i]: float(pr[i]) for i in top}


def graph_summary(graph, top_k: int = 10) -> Dict:
    """All-in-one stats dict (reference stats.py:193-218)."""
    S = _sym_bool_csr(graph)
    n = S.shape[0]
    degrees = np.asarray(S.sum(axis=1)).ravel()
    components = connected_components(graph)
    return {
        "num_nodes": n,
        "num_edges": int(S.nnz / 2),
        "density": float(S.nnz) / (n * (n - 1)) if n > 1 else 0.0,
        "avg_degree": float(degrees.mean()) if n > 0 else 0.0,
        "degree_distribution": degree_distribution(graph),
        "clustering_coefficient": clustering_coefficient(graph),
        "num_connected_components": len(components),
        "diameter": diameter(graph),
        "betweenness_centrality": betweenness_centrality(graph, top_k=top_k),
        "pagerank": pagerank(graph, top_k=top_k),
    }
