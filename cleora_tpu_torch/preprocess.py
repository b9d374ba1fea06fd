"""Edge-list / graph preprocessing (reference: pycleora/preprocess.py).

A copy of cleora_tpu/preprocess.py over the port's SparseMatrix and
stats, held equal to it by tests/test_torch_host_modules.py.
"""

from __future__ import annotations

from collections import Counter
from typing import List, Optional

import numpy as np

from .stats import _sym_bool_csr, connected_components


def clean_graph(
    edges: List[str],
    remove_self_loops: bool = True,
    deduplicate: bool = True,
    min_degree: Optional[int] = None,
    max_degree: Optional[int] = None,
) -> List[str]:
    """Self-loop removal, order-insensitive dedup, degree filter
    (reference preprocess.py:22-46)."""
    result = []
    for edge in edges:
        parts = edge.strip().split()
        if remove_self_loops and len(parts) == 2 and parts[0] == parts[1]:
            continue
        result.append(edge.strip())

    if deduplicate:
        seen = set()
        deduped = []
        for edge in result:
            key = tuple(sorted(edge.split()))
            if key not in seen:
                seen.add(key)
                deduped.append(edge)
        result = deduped

    if min_degree is not None or max_degree is not None:
        result = filter_by_degree_edges(result, min_degree, max_degree)
    return result


def filter_by_degree_edges(
    edges: List[str],
    min_degree: Optional[int] = None,
    max_degree: Optional[int] = None,
) -> List[str]:
    """Keep only edges where every endpoint's token count is in range
    (reference preprocess.py:49-70)."""
    degree = Counter()
    for edge in edges:
        degree.update(edge.strip().split())

    valid = {
        node
        for node, deg in degree.items()
        if (min_degree is None or deg >= min_degree)
        and (max_degree is None or deg <= max_degree)
    }
    return [e.strip() for e in edges if all(p in valid for p in e.strip().split())]


def _unique_sym_edges(graph, node_filter=None) -> List[str]:
    """'src dst' strings for r<c entries of the symmetrized adjacency."""
    S = _sym_bool_csr(graph)
    r, c = S.nonzero()
    keep = r < c
    r, c = r[keep], c[keep]
    ids = graph.entity_ids
    out = []
    for ri, ci in zip(r, c):
        if node_filter is None or (ri in node_filter and ci in node_filter):
            out.append(f"{ids[ri]} {ids[ci]}")
    return out


def filter_by_degree(
    graph,
    min_degree: Optional[int] = None,
    max_degree: Optional[int] = None,
) -> List[str]:
    """Edges of the symmetrized graph whose endpoints pass the degree filter
    (reference preprocess.py:73-101)."""
    S = _sym_bool_csr(graph)
    degrees = np.asarray(S.sum(axis=1)).ravel().astype(int)
    valid = {
        i
        for i, deg in enumerate(degrees)
        if (min_degree is None or deg >= min_degree)
        and (max_degree is None or deg <= max_degree)
    }
    return _unique_sym_edges(graph, valid)


def largest_connected_component(
    graph,
    columns: str = "complex::reflexive::node",
    hyperedge_trim_n: int = 16,
    num_workers=None,
):
    """Largest component rebuilt as a new SparseMatrix
    (reference preprocess.py:104-160)."""
    from .sparse import SparseMatrix

    comps = connected_components(graph)
    if not comps:
        raise ValueError("Graph has no nodes")
    best = max(comps, key=len)
    comp_set = set(best)
    edges = _unique_sym_edges(graph, comp_set)
    if not edges:
        eid = graph.entity_ids[best[0]]
        edges = [f"{eid} {eid}"]
    return SparseMatrix.from_iterator(iter(edges), columns, hyperedge_trim_n,
                                      num_workers)
