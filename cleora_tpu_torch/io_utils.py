"""Interop + persistence (reference: pycleora/io_utils.py):
networkx / PyG / DGL export, npz/csv/tsv/parquet save-load, and graph
construction from pandas / scipy / tuples / numpy.

A copy of cleora_tpu/io_utils.py over the port's SparseMatrix; networkx,
pandas, pyarrow, PyG and DGL stay lazy imports.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def _sparse_matrix_cls():
    from .sparse import SparseMatrix

    return SparseMatrix


def _undirected_unique(graph):
    """Yield (r, c, v) once per undirected edge, CSR scan order."""
    rows, cols, vals, _, _ = graph.to_sparse_csr()
    seen = set()
    for r, c, v in zip(rows, cols, vals):
        r, c = int(r), int(c)
        key = (min(r, c), max(r, c))
        if key not in seen:
            seen.add(key)
            yield r, c, float(v)


def to_networkx(graph, embeddings: Optional[np.ndarray] = None):
    """Undirected nx.Graph with index (+embedding) node attrs and weight edge
    attrs (reference io_utils.py:5-31)."""
    try:
        import networkx as nx
    except ImportError:
        raise ImportError(
            "networkx is required for graph export. Install with: pip install networkx"
        )

    G = nx.Graph()
    for i, eid in enumerate(graph.entity_ids):
        attrs = {"index": i}
        if embeddings is not None:
            attrs["embedding"] = embeddings[i].tolist()
        G.add_node(eid, **attrs)
    ids = graph.entity_ids
    for r, c, v in _undirected_unique(graph):
        G.add_edge(ids[r], ids[c], weight=v)
    return G


def from_networkx(G, columns: str = "complex::reflexive::node",
                  hyperedge_trim_n: int = 16, num_workers=None):
    """Build from nx edges (reference io_utils.py:34-41)."""
    edges = [f"{u} {v}" for u, v in G.edges()]
    return _sparse_matrix_cls().from_iterator(
        iter(edges), columns, hyperedge_trim_n, num_workers
    )


def to_pyg_data(graph, embeddings: np.ndarray):
    """torch_geometric.data.Data with edge_index/edge_attr/x
    (reference io_utils.py:44-60)."""
    try:
        import torch
        from torch_geometric.data import Data
    except ImportError:
        raise ImportError(
            "PyTorch Geometric is required. Install with: pip install torch "
            "torch-geometric"
        )

    rows, cols, vals, _, _ = graph.to_sparse_csr()
    return Data(
        x=torch.tensor(embeddings, dtype=torch.float),
        edge_index=torch.tensor(
            np.stack([rows.astype(np.int64), cols.astype(np.int64)]),
            dtype=torch.long,
        ),
        edge_attr=torch.tensor(vals, dtype=torch.float),
    )


def to_dgl_graph(graph, embeddings: np.ndarray):
    """dgl.graph with feat/weight data (reference io_utils.py:63-76)."""
    try:
        import dgl
        import torch
    except ImportError:
        raise ImportError("DGL is required. Install with: pip install dgl")

    rows, cols, vals, _, _ = graph.to_sparse_csr()
    g = dgl.graph((
        torch.tensor(rows.astype(np.int64), dtype=torch.long),
        torch.tensor(cols.astype(np.int64), dtype=torch.long),
    ))
    g.ndata["feat"] = torch.tensor(embeddings, dtype=torch.float)
    g.edata["weight"] = torch.tensor(vals, dtype=torch.float)
    return g


def save_embeddings(graph, embeddings: np.ndarray, filepath: str,
                    format: str = "npz"):
    """npz / csv / tsv / parquet export (reference io_utils.py:79-115)."""
    if format == "npz":
        np.savez(filepath, embeddings=embeddings,
                 entity_ids=np.array(graph.entity_ids))
    elif format == "csv":
        import csv

        with open(filepath, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(
                ["entity_id"] + [f"dim_{i}" for i in range(embeddings.shape[1])]
            )
            for i, eid in enumerate(graph.entity_ids):
                writer.writerow([eid] + embeddings[i].tolist())
    elif format == "tsv":
        with open(filepath, "w") as f:
            f.write(
                "entity_id\t"
                + "\t".join(f"dim_{i}" for i in range(embeddings.shape[1]))
                + "\n"
            )
            for i, eid in enumerate(graph.entity_ids):
                f.write(
                    eid + "\t" + "\t".join(f"{v:.6f}" for v in embeddings[i]) + "\n"
                )
    elif format == "parquet":
        try:
            import pyarrow as pa
            import pyarrow.parquet as pq
        except ImportError:
            raise ImportError(
                "pyarrow is required for parquet export. Install with: "
                "pip install pyarrow"
            )
        arrays = {"entity_id": graph.entity_ids}
        for i in range(embeddings.shape[1]):
            arrays[f"dim_{i}"] = embeddings[:, i].tolist()
        pq.write_table(pa.table(arrays), filepath)
    else:
        raise ValueError(
            f"Unknown format: {format}. Use 'npz', 'csv', 'tsv', or 'parquet'."
        )


def load_embeddings(filepath: str, format: str = "npz") -> Tuple[np.ndarray, List[str]]:
    """Inverse of save_embeddings for npz/csv/tsv (reference io_utils.py:118-144)."""
    if format == "npz":
        data = np.load(filepath, allow_pickle=True)
        return data["embeddings"], data["entity_ids"].tolist()
    if format == "csv":
        import csv

        with open(filepath, "r") as f:
            reader = csv.reader(f)
            next(reader)
            entity_ids, rows = [], []
            for row in reader:
                entity_ids.append(row[0])
                rows.append([float(v) for v in row[1:]])
        return np.array(rows, dtype=np.float32), entity_ids
    if format == "tsv":
        entity_ids, rows = [], []
        with open(filepath, "r") as f:
            next(f)
            for line in f:
                parts = line.strip().split("\t")
                entity_ids.append(parts[0])
                rows.append([float(v) for v in parts[1:]])
        return np.array(rows, dtype=np.float32), entity_ids
    raise ValueError(f"Unknown format: {format}. Use 'npz', 'csv', or 'tsv'.")


def from_pandas(df, source_col: str, target_col: str,
                weight_col: Optional[str] = None,
                columns: str = "complex::reflexive::node",
                hyperedge_trim_n: int = 16, num_workers=None):
    """DataFrame rows → edges; NaN/zero-weight rows dropped
    (reference io_utils.py:145-184).  Weight values are not encoded —
    use embed_weighted for weighted embedding."""
    try:
        import pandas as pd
    except ImportError:
        raise ImportError(
            "pandas is required for DataFrame import. Install with: pip install pandas"
        )

    for name, col in [("source_col", source_col), ("target_col", target_col)]:
        if col not in df.columns:
            raise ValueError(
                f"{name} '{col}' not found in DataFrame columns: {list(df.columns)}"
            )
    if weight_col is not None and weight_col not in df.columns:
        raise ValueError(
            f"weight_col '{weight_col}' not found in DataFrame columns: "
            f"{list(df.columns)}"
        )

    edges = []
    for _, row in df.iterrows():
        src, tgt = row[source_col], row[target_col]
        if pd.isna(src) or pd.isna(tgt):
            continue
        if weight_col is not None:
            w = row[weight_col]
            if pd.isna(w) or float(w) == 0:
                continue
        edges.append(f"{src} {tgt}")
    if not edges:
        raise ValueError(
            "No valid edges found in DataFrame (all rows may have NaN values)"
        )
    return _sparse_matrix_cls().from_iterator(
        iter(edges), columns, hyperedge_trim_n, num_workers
    )


def from_scipy_sparse(matrix, entity_ids: Optional[List[str]] = None,
                      columns: str = "complex::reflexive::node",
                      hyperedge_trim_n: int = 16, num_workers=None):
    """Undirected-deduped edges from a scipy sparse adjacency
    (reference io_utils.py:187-229)."""
    import scipy.sparse

    if not scipy.sparse.issparse(matrix):
        raise ValueError("matrix must be a scipy sparse matrix")
    if matrix.shape[0] != matrix.shape[1]:
        raise ValueError(f"matrix must be square, got shape {matrix.shape}")

    n = matrix.shape[0]
    ids = _entity_id_strs(entity_ids, n)
    coo = matrix.tocoo()
    seen = set()
    edges = []
    for r, c in zip(coo.row, coo.col):
        key = (min(r, c), max(r, c))
        if key not in seen:
            seen.add(key)
            edges.append(f"{ids[r]} {ids[c]}")
    if not edges:
        raise ValueError("No edges found in the sparse matrix")
    return _sparse_matrix_cls().from_iterator(
        iter(edges), columns, hyperedge_trim_n, num_workers
    )


def from_edge_list(edges: List, columns: str = "complex::reflexive::node",
                   hyperedge_trim_n: int = 16, num_workers=None):
    """(src, dst[, weight]) tuples → graph; weights accepted but not encoded
    (reference io_utils.py:232-255)."""
    if not edges:
        raise ValueError("edges list must not be empty")
    edge_strs = []
    for edge in edges:
        if len(edge) in (2, 3):
            edge_strs.append(f"{edge[0]} {edge[1]}")
        else:
            raise ValueError(
                "Each edge must be a (source, target) or (source, target, weight) "
                f"tuple, got length {len(edge)}"
            )
    return _sparse_matrix_cls().from_iterator(
        iter(edge_strs), columns, hyperedge_trim_n, num_workers
    )


def from_numpy(adjacency_matrix, entity_ids: Optional[List[str]] = None,
               columns: str = "complex::reflexive::node",
               hyperedge_trim_n: int = 16, num_workers=None):
    """Dense adjacency → undirected edges where (i,j) or (j,i) ≠ 0
    (reference io_utils.py:258-295)."""
    if not isinstance(adjacency_matrix, np.ndarray):
        raise ValueError("adjacency_matrix must be a numpy ndarray")
    if adjacency_matrix.ndim != 2:
        raise ValueError(
            f"adjacency_matrix must be 2-dimensional, got "
            f"{adjacency_matrix.ndim} dimensions"
        )
    if adjacency_matrix.shape[0] != adjacency_matrix.shape[1]:
        raise ValueError(
            f"adjacency_matrix must be square, got shape {adjacency_matrix.shape}"
        )

    n = adjacency_matrix.shape[0]
    ids = _entity_id_strs(entity_ids, n)
    nz = (adjacency_matrix != 0) | (adjacency_matrix.T != 0)
    iu, ju = np.nonzero(np.triu(nz))
    edges = [f"{ids[i]} {ids[j]}" for i, j in zip(iu, ju)]
    if not edges:
        raise ValueError("No edges found in the adjacency matrix")
    return _sparse_matrix_cls().from_iterator(
        iter(edges), columns, hyperedge_trim_n, num_workers
    )


def to_edge_list(graph) -> List[Tuple[str, str, float]]:
    """Unique undirected (src, dst, value) tuples (reference io_utils.py:298-308)."""
    ids = graph.entity_ids
    return [(ids[r], ids[c], v) for r, c, v in _undirected_unique(graph)]


def _entity_id_strs(entity_ids: Optional[List[str]], n: int) -> List[str]:
    if entity_ids is None:
        return [str(i) for i in range(n)]
    if len(entity_ids) != n:
        raise ValueError(
            f"entity_ids has {len(entity_ids)} elements but matrix has {n} rows"
        )
    return [str(eid) for eid in entity_ids]
