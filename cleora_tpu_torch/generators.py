"""Synthetic graph generators (reference: pycleora/generators.py).

RNG draw order matches the reference for every model, so the generated graphs
are bit-identical for a given seed; the Bernoulli models (Erdős–Rényi, SBM)
draw their uniform variates in one batched call covering the same sequence.

A copy of cleora_tpu/generators.py (numpy only), held equal to it by
tests/test_torch_host_modules.py.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def erdos_renyi(
    num_nodes: int,
    p: float = 0.1,
    seed: int = 42,
    directed: bool = False,
) -> Dict:
    """G(n, p) (reference generators.py:5-36)."""
    rng = np.random.default_rng(seed)
    edges = []
    if directed:
        # reference order: for i, for j≠i — (n-1) draws per source node
        draws = rng.random((num_nodes, max(num_nodes - 1, 0)))
        for i in range(num_nodes):
            k = 0
            for j in range(num_nodes):
                if i == j:
                    continue
                if draws[i, k] < p:
                    edges.append(f"n{i} n{j}")
                k += 1
    else:
        total = num_nodes * (num_nodes - 1) // 2
        draws = rng.random(total)
        k = 0
        for i in range(num_nodes):
            hit = np.flatnonzero(draws[k:k + num_nodes - 1 - i] < p) + i + 1
            edges.extend(f"n{i} n{j}" for j in hit)
            k += num_nodes - 1 - i

    return {
        "name": f"Erdos-Renyi(n={num_nodes}, p={p})",
        "edges": edges,
        "labels": {f"n{i}": 0 for i in range(num_nodes)},
        "num_nodes": num_nodes,
        "num_edges": len(edges),
        "num_classes": 1,
        "columns": "complex::reflexive::node",
        "model": "erdos_renyi",
    }


def barabasi_albert(num_nodes: int, m: int = 3, seed: int = 42) -> Dict:
    """Preferential attachment (reference generators.py:39-97): initial clique
    of max(m+1, 2) nodes, each new node attaches to m degree-weighted targets."""
    if num_nodes < 2:
        raise ValueError(f"num_nodes must be >= 2, got {num_nodes}")
    if m < 1 or m >= num_nodes:
        raise ValueError(f"m must be >= 1 and < num_nodes ({num_nodes}), got {m}")

    rng = np.random.default_rng(seed)
    initial = min(max(m + 1, 2), num_nodes)

    # BA never produces a duplicate edge (every attachment target precedes
    # the arriving node), so the graph IS its edge list: the seed clique's
    # upper-triangle pairs plus one (target, new_node) pair per attachment.
    # Only the degree vector needs maintaining between attachment steps —
    # the rng.choice call sequence (one draw per arriving node, weighted by
    # current degrees) is the part pinned by RNG-stream parity.
    degrees = np.zeros(num_nodes, dtype=np.float64)
    degrees[:initial] = initial - 1
    lo, hi = np.triu_indices(initial, k=1)
    pair_blocks = [np.stack([lo, hi], axis=1)]

    for new_node in range(initial, num_nodes):
        k = min(m, new_node)
        deg_sum = degrees[:new_node].sum()
        if deg_sum < 1e-10:
            targets = rng.choice(new_node, size=k, replace=False)
        else:
            targets = rng.choice(new_node, size=k, replace=False,
                                 p=degrees[:new_node] / deg_sum)
        degrees[targets] += 1.0
        degrees[new_node] = float(k)
        pair_blocks.append(np.stack(
            [targets, np.full(k, new_node, dtype=targets.dtype)], axis=1
        ))

    pairs = np.concatenate(pair_blocks)  # column 0 < column 1 throughout
    edges = [f"n{a} n{b}" for a, b in pairs]

    return {
        "name": f"Barabasi-Albert(n={num_nodes}, m={m})",
        "edges": edges,
        "labels": {f"n{i}": 0 for i in range(num_nodes)},
        "num_nodes": num_nodes,
        "num_edges": len(edges),
        "num_classes": 1,
        "columns": "complex::reflexive::node",
        "model": "barabasi_albert",
    }


def stochastic_block_model(
    block_sizes: List[int],
    p_within: float = 0.3,
    p_between: float = 0.01,
    seed: int = 42,
) -> Dict:
    """SBM over upper-triangle Bernoulli draws (reference generators.py:101-137)."""
    rng = np.random.default_rng(seed)
    num_nodes = sum(block_sizes)
    block = np.repeat(np.arange(len(block_sizes)), block_sizes)

    edges = []
    total = num_nodes * (num_nodes - 1) // 2
    draws = rng.random(total)
    k = 0
    for i in range(num_nodes):
        row = draws[k:k + num_nodes - 1 - i]
        js = np.arange(i + 1, num_nodes)
        probs = np.where(block[js] == block[i], p_within, p_between)
        edges.extend(f"n{i} n{j}" for j in js[row < probs])
        k += num_nodes - 1 - i

    return {
        "name": f"SBM(blocks={block_sizes})",
        "edges": edges,
        "labels": {f"n{i}": int(block[i]) for i in range(num_nodes)},
        "num_nodes": num_nodes,
        "num_edges": len(edges),
        "num_classes": len(block_sizes),
        "columns": "complex::reflexive::node",
        "model": "stochastic_block_model",
        "block_sizes": block_sizes,
    }


def planted_partition(
    num_communities: int = 4,
    community_size: int = 25,
    p_in: float = 0.3,
    p_out: float = 0.01,
    seed: int = 42,
) -> Dict:
    """SBM with equal blocks (reference generators.py:140-152)."""
    return stochastic_block_model(
        block_sizes=[community_size] * num_communities,
        p_within=p_in,
        p_between=p_out,
        seed=seed,
    )


def watts_strogatz(
    num_nodes: int,
    k: int = 6,
    beta: float = 0.3,
    seed: int = 42,
) -> Dict:
    """Ring lattice + β-rewiring (reference generators.py:155-196).

    The k//2 ring offsets per node are built vectorized; the rewiring pass
    walks the same (source, offset) sequence because its coin and
    replacement-target draws are interleaved on one RNG stream and each
    redraw depends on the evolving edge set — that draw order is the
    bit-exactness contract, the loop shape around it is not.
    """
    rng = np.random.default_rng(seed)
    half = k // 2
    src = np.repeat(np.arange(num_nodes), half)
    dst = (src + np.tile(np.arange(1, half + 1), num_nodes)) % num_nodes
    lattice = np.stack([np.minimum(src, dst), np.maximum(src, dst)], axis=1)
    edges_set = set(map(tuple, lattice.tolist()))

    rewired = set()
    for (i, _), key in zip(zip(src.tolist(), dst.tolist()),
                           map(tuple, lattice.tolist())):
        if rng.random() >= beta or key in rewired:
            continue
        edges_set.discard(key)
        new_key = None
        while new_key is None:
            t = int(rng.integers(0, num_nodes))
            cand = (i, t) if i < t else (t, i)
            if t != i and cand not in edges_set:
                new_key = cand
        edges_set.add(new_key)
        rewired.add(new_key)

    edges = [f"n{i} n{j}" for i, j in edges_set]
    return {
        "name": f"Watts-Strogatz(n={num_nodes}, k={k}, beta={beta})",
        "edges": edges,
        "labels": {f"n{i}": i % 4 for i in range(num_nodes)},
        "num_nodes": num_nodes,
        "num_edges": len(edges),
        "num_classes": 4,
        "columns": "complex::reflexive::node",
        "model": "watts_strogatz",
    }
