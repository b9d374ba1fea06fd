"""Heterogeneous (typed) graphs (reference: pycleora/hetero.py).

``HeteroGraph`` holds typed node/edge sets; homogeneous export prefixes
entities as ``{type}_{id}`` (only when more than one node type is declared);
``embed_per_relation`` embeds each edge type separately and combines over the
union of entities; ``embed_metapath`` composes adjacencies along a metapath
and embeds the result.

Counterpart of cleora_tpu/hetero.py over the port's SparseMatrix and
``embed``: the same code, plus a ``device`` argument (``None`` means CUDA,
``"cpu"`` the plain PyTorch path) that each embedding call receives.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .sparse import SparseMatrix


class HeteroGraph:
    def __init__(self):
        self._node_types: Dict[str, Dict] = {}
        self._edge_types: Dict[str, Dict] = {}
        self._node_features: Dict[str, Dict[str, np.ndarray]] = {}

    def add_node_type(self, name: str,
                      features: Optional[Dict[str, np.ndarray]] = None):
        self._node_types[name] = {"features": features or {}}
        if features:
            self._node_features[name] = features

    def add_edge_type(
        self,
        name: str,
        source_type: str,
        target_type: str,
        edges: List[Tuple[str, str]],
        weights: Optional[List[float]] = None,
    ):
        self._edge_types[name] = {
            "source_type": source_type,
            "target_type": target_type,
            "edges": edges,
            "weights": weights,
        }

    @property
    def node_types(self) -> List[str]:
        return list(self._node_types.keys())

    @property
    def edge_types(self) -> List[str]:
        return list(self._edge_types.keys())

    def num_nodes(self, node_type: Optional[str] = None) -> int:
        """Distinct node count, per type or total over prefixed ids
        (reference hetero.py:44-66)."""
        if node_type:
            features = self._node_types.get(node_type, {}).get("features", {})
            if features:
                return len(features)
            nodes = set()
            for info in self._edge_types.values():
                if info["source_type"] == node_type:
                    nodes.update(e[0] for e in info["edges"])
                if info["target_type"] == node_type:
                    nodes.update(e[1] for e in info["edges"])
            return len(nodes)
        total = set()
        for nt, spec in self._node_types.items():
            total.update(f"{nt}_{k}" for k in spec.get("features", {}))
        for info in self._edge_types.values():
            total.update(f"{info['source_type']}_{e[0]}" for e in info["edges"])
            total.update(f"{info['target_type']}_{e[1]}" for e in info["edges"])
        return len(total)

    def num_edges(self, edge_type: Optional[str] = None) -> int:
        if edge_type:
            return len(self._edge_types.get(edge_type, {}).get("edges", []))
        return sum(len(info["edges"]) for info in self._edge_types.values())

    def get_edges(self, edge_type: str) -> List[Tuple[str, str]]:
        if edge_type not in self._edge_types:
            raise ValueError(f"Unknown edge type: '{edge_type}'")
        return self._edge_types[edge_type]["edges"]

    def to_homogeneous_edges(self) -> List[str]:
        """'{type}_{id}'-prefixed edge strings; prefixes only when >1 node type
        is declared (reference hetero.py:78-87)."""
        prefix = len(self._node_types) > 1
        out = []
        for info in self._edge_types.values():
            st, tt = info["source_type"], info["target_type"]
            for src, tgt in info["edges"]:
                s = f"{st}_{src}" if prefix else src
                t = f"{tt}_{tgt}" if prefix else tgt
                out.append(f"{s} {t}")
        return out

    def _union_index(self, graphs):
        all_entities = sorted(set().union(*(g.entity_ids for g in graphs.values())))
        return all_entities, {e: i for i, e in enumerate(all_entities)}

    def embed_per_relation(
        self,
        feature_dim: int = 256,
        num_iterations: int = 40,
        propagation: str = "left",
        normalization: str = "l2",
        combine: str = "concat",
        seed: int = 0,
        whiten: bool = True,
        device=None,
    ) -> Tuple[Dict[str, SparseMatrix], Dict[str, np.ndarray], Optional[np.ndarray]]:
        """Embed each edge type as its own (always-prefixed) graph; combine
        concat/mean over the entity union (reference hetero.py:89-173)."""
        from . import embed

        graphs: Dict[str, SparseMatrix] = {}
        embeddings: Dict[str, np.ndarray] = {}
        for et_name, info in self._edge_types.items():
            st, tt = info["source_type"], info["target_type"]
            edge_strs = [f"{st}_{s} {tt}_{t}" for s, t in info["edges"]]
            graph = SparseMatrix.from_iterator(
                iter(edge_strs), "complex::reflexive::node"
            )
            graphs[et_name] = graph
            embeddings[et_name] = embed(
                graph, feature_dim=feature_dim, num_iterations=num_iterations,
                propagation=propagation, normalization=normalization, seed=seed,
                whiten=whiten, device=device,
            )

        combined = None
        if len(embeddings) > 1 and combine in ("concat", "mean"):
            all_entities, entity_to_idx = self._union_index(graphs)
            n = len(all_entities)
            if combine == "concat":
                parts = []
                for et_name in self._edge_types:
                    g, emb = graphs[et_name], embeddings[et_name]
                    part = np.zeros((n, emb.shape[1]), dtype=np.float32)
                    rows = [entity_to_idx[e] for e in g.entity_ids]
                    part[rows] = emb
                    parts.append(part)
                combined = np.concatenate(parts, axis=1)
            else:
                combined64 = np.zeros((n, feature_dim), dtype=np.float64)
                counts = np.zeros(n, dtype=np.float64)
                for et_name in self._edge_types:
                    g, emb = graphs[et_name], embeddings[et_name]
                    rows = np.array([entity_to_idx[e] for e in g.entity_ids])
                    combined64[rows] += emb.astype(np.float64)
                    counts[rows] += 1
                combined = (combined64 / np.maximum(counts, 1)[:, None]).astype(
                    np.float32
                )
            norms = np.maximum(
                np.linalg.norm(combined, axis=1, keepdims=True), 1e-10
            )
            combined = combined / norms

        return graphs, embeddings, combined

    def embed_metapath(
        self,
        metapath: List[str],
        feature_dim: int = 256,
        num_iterations: int = 40,
        normalization: str = "l2",
        seed: int = 0,
        whiten: bool = True,
        device=None,
    ) -> Tuple[SparseMatrix, np.ndarray]:
        """Compose prefixed adjacencies along the metapath, drop self-pairs,
        embed the composition (reference hetero.py:175-239)."""
        from . import embed

        if len(metapath) < 2:
            raise ValueError("Metapath must have at least 2 edge types")
        for et in metapath:
            if et not in self._edge_types:
                raise ValueError(f"Unknown edge type in metapath: '{et}'")

        composed: Optional[Dict[str, set]] = None
        for et_name in reversed(metapath):
            info = self._edge_types[et_name]
            st, tt = info["source_type"], info["target_type"]
            adj: Dict[str, set] = {}
            for src, tgt in info["edges"]:
                adj.setdefault(f"{st}_{src}", set()).add(f"{tt}_{tgt}")
            if composed is None:
                composed = adj
            else:
                nxt: Dict[str, set] = {}
                for src, mids in adj.items():
                    targets = set()
                    for mid in mids:
                        targets.update(composed.get(mid, ()))
                    if targets:
                        nxt[src] = targets
                composed = nxt

        edge_strs = [
            f"{src} {tgt}"
            for src, targets in composed.items()
            for tgt in targets
            if src != tgt
        ]
        if not edge_strs:
            raise ValueError("Metapath produced no edges")

        graph = SparseMatrix.from_iterator(
            iter(edge_strs), "complex::reflexive::node"
        )
        emb = embed(
            graph, feature_dim=feature_dim, num_iterations=num_iterations,
            normalization=normalization, seed=seed, whiten=whiten,
            device=device,
        )
        return graph, emb

    def summary(self) -> str:
        lines = ["HeteroGraph:", f"  Node types: {len(self._node_types)}"]
        for nt in self._node_types:
            lines.append(f"    - {nt}: {self.num_nodes(nt)} nodes")
        lines.append(f"  Edge types: {len(self._edge_types)}")
        for et_name, info in self._edge_types.items():
            lines.append(
                f"    - {et_name} ({info['source_type']} -> "
                f"{info['target_type']}): {len(info['edges'])} edges"
            )
        lines.append(f"  Total nodes: {self.num_nodes()}")
        lines.append(f"  Total edges: {self.num_edges()}")
        return "\n".join(lines)

    def __repr__(self):
        return (
            f"HeteroGraph(node_types={len(self._node_types)}, "
            f"edge_types={len(self._edge_types)}, "
            f"nodes={self.num_nodes()}, edges={self.num_edges()})"
        )
