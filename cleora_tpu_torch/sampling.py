"""Graph sampling (reference: pycleora/sampling.py).

Same six methods and RNG seeds; set-building vectorized where the reference
loops (unique undirected edge extraction, subgraph edge induction).

A copy of cleora_tpu/sampling.py (numpy only), held equal to it by
tests/test_torch_host_modules.py.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def _adj_lists(graph):
    """Out-neighbor lists without self-loops (reference sampling.py:5-12)."""
    rows, cols, _, n, _ = graph.to_sparse_csr()
    adj = [[] for _ in range(n)]
    for r, c in zip(rows, cols):
        if r != c:
            adj[r].append(int(c))
    return adj, n


def _unique_undirected(graph, drop_self_loops=True):
    """Unique (lo, hi) pairs in first-seen order over the CSR scan."""
    rows, cols, _, n, _ = graph.to_sparse_csr()
    lo = np.minimum(rows, cols).astype(np.int64)
    hi = np.maximum(rows, cols).astype(np.int64)
    if drop_self_loops:
        keep = lo != hi
        lo, hi = lo[keep], hi[keep]
    key = lo * n + hi
    _, first = np.unique(key, return_index=True)
    first.sort()
    return list(zip(lo[first].tolist(), hi[first].tolist())), n


def _induced_edges(graph, sampled, adj):
    ids = graph.entity_ids
    return [
        f"{ids[node]} {ids[nb]}"
        for node in sampled
        for nb in adj[node]
        if nb in sampled
    ]


def sample_nodes(graph, num_nodes: int, seed: int = 42) -> List[str]:
    """Uniform node sample without replacement (reference sampling.py:15-24)."""
    rng = np.random.default_rng(seed)
    n = graph.num_entities
    indices = rng.choice(n, size=min(num_nodes, n), replace=False)
    return [graph.entity_ids[i] for i in indices]


def sample_edges(graph, num_edges: int, seed: int = 42) -> List[Tuple[str, str]]:
    """Uniform undirected-edge sample; self-loops excluded
    (reference sampling.py:27-47)."""
    edge_list, _ = _unique_undirected(graph)
    rng = np.random.default_rng(seed)
    k = min(num_edges, len(edge_list))
    indices = rng.choice(len(edge_list), size=k, replace=False)
    ids = graph.entity_ids
    return [(ids[edge_list[i][0]], ids[edge_list[i][1]]) for i in indices]


def sample_neighborhood(
    graph,
    seed_nodes: List[str],
    num_hops: int = 2,
    max_neighbors_per_hop: Optional[int] = None,
    seed: int = 42,
) -> Dict:
    """k-hop expansion with optional per-node fanout cap
    (reference sampling.py:50-92)."""
    adj, _ = _adj_lists(graph)
    index_map = {eid: i for i, eid in enumerate(graph.entity_ids)}
    rng = np.random.default_rng(seed)

    sampled = {index_map[eid] for eid in seed_nodes if eid in index_map}
    frontier = set(sampled)
    for _ in range(num_hops):
        nxt = set()
        for node in frontier:
            neighbors = adj[node]
            if max_neighbors_per_hop and len(neighbors) > max_neighbors_per_hop:
                neighbors = rng.choice(
                    neighbors, size=max_neighbors_per_hop, replace=False
                ).tolist()
            for nb in neighbors:
                if nb not in sampled:
                    nxt.add(nb)
                    sampled.add(nb)
        frontier = nxt
        if not frontier:
            break

    edges = _induced_edges(graph, sampled, adj)
    return {
        "nodes": [graph.entity_ids[i] for i in sorted(sampled)],
        "edges": edges,
        "num_nodes": len(sampled),
        "num_edges": len(edges),
    }


def sample_subgraph(
    graph,
    num_nodes: int,
    method: str = "random_walk",
    walk_length: int = 100,
    seed: int = 42,
) -> Dict:
    """random_walk / random_node / bfs subgraph induction
    (reference sampling.py:96-152)."""
    adj, n = _adj_lists(graph)
    rng = np.random.default_rng(seed)

    if method == "random_walk":
        sampled = set()
        curr = int(rng.integers(0, n))
        for _ in range(walk_length * 10):
            sampled.add(curr)
            if len(sampled) >= num_nodes:
                break
            neighbors = adj[curr]
            if not neighbors:
                curr = int(rng.integers(0, n))
            else:
                curr = neighbors[int(rng.integers(len(neighbors)))]
    elif method == "random_node":
        sampled = set(rng.choice(n, size=min(num_nodes, n), replace=False).tolist())
    elif method == "bfs":
        start = int(rng.integers(0, n))
        sampled = {start}
        queue = [start]
        qi = 0
        while qi < len(queue) and len(sampled) < num_nodes:
            curr = queue[qi]
            qi += 1
            for nb in adj[curr]:
                if nb not in sampled:
                    sampled.add(nb)
                    queue.append(nb)
                    if len(sampled) >= num_nodes:
                        break
    else:
        raise ValueError(
            f"Unknown method '{method}'. Use 'random_walk', 'random_node', or 'bfs'."
        )

    edges = _induced_edges(graph, sampled, adj)
    return {
        "nodes": [graph.entity_ids[i] for i in sorted(sampled)],
        "edges": edges,
        "num_nodes": len(sampled),
        "num_edges": len(edges),
    }


def graphsaint_sample(
    graph,
    batch_size: int = 512,
    walk_length: int = 4,
    num_batches: int = 5,
    seed: int = 42,
) -> List[Dict]:
    """GraphSAINT random-walk batches (reference sampling.py:154-192)."""
    adj, n = _adj_lists(graph)
    rng = np.random.default_rng(seed)
    batches = []
    for b in range(num_batches):
        sampled = set()
        for _ in range(batch_size):
            curr = int(rng.integers(0, n))
            for _ in range(walk_length):
                sampled.add(curr)
                neighbors = adj[curr]
                if not neighbors:
                    break
                curr = neighbors[int(rng.integers(len(neighbors)))]
        edges = _induced_edges(graph, sampled, adj)
        batches.append({
            "batch_id": b,
            "nodes": [graph.entity_ids[i] for i in sorted(sampled)],
            "edges": edges,
            "num_nodes": len(sampled),
            "num_edges": len(edges),
        })
    return batches


def negative_sampling(
    graph,
    num_negatives: int = 1000,
    seed: int = 42,
) -> List[Tuple[str, str]]:
    """Rejection-sample non-edges, ≤20 attempts per negative
    (reference sampling.py:195-219)."""
    rows, cols, _, n, _ = graph.to_sparse_csr()
    lo = np.minimum(rows, cols).astype(np.int64)
    hi = np.maximum(rows, cols).astype(np.int64)
    existing = set(zip(lo.tolist(), hi.tolist()))

    rng = np.random.default_rng(seed)
    negatives = []
    ids = graph.entity_ids
    attempts = 0
    max_attempts = num_negatives * 20
    while len(negatives) < num_negatives and attempts < max_attempts:
        i = int(rng.integers(0, n))
        j = int(rng.integers(0, n))
        key = (min(i, j), max(i, j))
        if i != j and key not in existing:
            negatives.append((ids[i], ids[j]))
            existing.add(key)
        attempts += 1
    return negatives


def train_test_split_edges(graph, test_ratio: float = 0.2, seed: int = 42) -> Dict:
    """Permutation split of unique undirected edges
    (reference sampling.py:222-251)."""
    edge_list, _ = _unique_undirected(graph)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(edge_list))
    split = int(len(edge_list) * (1 - test_ratio))
    ids = graph.entity_ids
    train = [(ids[edge_list[i][0]], ids[edge_list[i][1]]) for i in perm[:split]]
    test = [(ids[edge_list[i][0]], ids[edge_list[i][1]]) for i in perm[split:]]
    return {
        "train_edges": train,
        "test_edges": test,
        "train_edge_strings": [f"{a} {b}" for a, b in train],
        "num_train": len(train),
        "num_test": len(test),
    }
