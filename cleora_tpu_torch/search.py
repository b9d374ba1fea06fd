"""Approximate nearest-neighbor search (reference: pycleora/search.py).

Counterpart of cleora_tpu/search.py, with the same names and host code.
``ANNIndex`` prefers hnswlib when installed (cosine, M=16,
ef_construction=200, ef=50), else falls back to a cosine ball tree, else
brute force.  Query results are [{entity_id, index, similarity}] sorted by
similarity.

``ANNIndex(method="device")`` and ``ShardedDeviceIndex`` keep the
L2-normalized table on the card (``device=None`` means CUDA;
``device="cpu"`` runs the same PyTorch calls on the CPU; without a card and
without ``device="cpu"`` they raise): a query is a full-float32 product
with the table and ``torch.topk``.  ``ShardedDeviceIndex(mesh=)`` cuts the
table by rows over the ranks of a shard group (``parallel.ShardGroup``),
one block per rank's card.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ._util import full_float32_matmul, resolve_device

# table rows normalized and uploaded, or upcast from bfloat16 for one
# product, at a time
_ROW_BLOCK = 1 << 18


def _unit(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v)
    return v / n if n > 1e-10 else v


def _similarities(q: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """float32 (Q, N) products of float32 queries with the table's rows in
    full float32; a bfloat16 table is upcast in row blocks, which gives the
    exact bfloat16 products summed in float32."""
    q = q.float()
    with full_float32_matmul():
        if table.dtype == torch.float32:
            return q @ table.T
        out = torch.empty((q.shape[0], table.shape[0]), dtype=torch.float32,
                          device=table.device)
        for lo in range(0, table.shape[0], _ROW_BLOCK):
            out[:, lo:lo + _ROW_BLOCK] = q @ table[lo:lo + _ROW_BLOCK].float().T
        return out


class _BallTree:
    """Cosine-similarity ball tree with branch-and-bound pruning
    (reference search.py:5-99); leaf size 32."""

    _LEAF = 32

    def __init__(self, data: np.ndarray):
        self._normalized = data / np.maximum(
            np.linalg.norm(data, axis=1, keepdims=True), 1e-10
        )
        self._tree = self._build(np.arange(data.shape[0]))

    def _build(self, indices: np.ndarray):
        if len(indices) <= self._LEAF:
            return {"indices": indices, "leaf": True}
        points = self._normalized[indices]
        center = _unit(points.mean(axis=0))
        radius = float(np.max(np.linalg.norm(points - center, axis=1)))

        axis = int(np.argmax(np.var(points, axis=0)))
        left_mask = points[:, axis] <= np.median(points[:, axis])
        if left_mask.all() or not left_mask.any():
            left_mask[:] = False
            left_mask[: len(indices) // 2] = True
        return {
            "leaf": False,
            "center": center,
            "radius": radius,
            "left": self._build(indices[left_mask]),
            "right": self._build(indices[~left_mask]),
        }

    def query(self, query_vec: np.ndarray, top_k: int):
        q = _unit(query_vec)
        candidates: List = []
        self._search(self._tree, q, top_k, candidates)
        candidates.sort(key=lambda x: -x[1])
        candidates = candidates[:top_k]
        return (
            np.array([c[0] for c in candidates], dtype=np.int64),
            np.array([c[1] for c in candidates], dtype=np.float64),
        )

    def _search(self, node, q, top_k, candidates):
        if node["leaf"]:
            sims = self._normalized[node["indices"]] @ q
            for idx, sim in zip(node["indices"], sims):
                self._insert(candidates, int(idx), float(sim), top_k)
            return
        worst = candidates[-1][1] if len(candidates) >= top_k else -2.0
        if len(candidates) >= top_k and np.dot(node["center"], q) + node["radius"] < worst:
            return
        left, right = node["left"], node["right"]
        lc, rc = left.get("center"), right.get("center")
        if lc is not None and rc is not None and np.dot(lc, q) < np.dot(rc, q):
            left, right = right, left
        self._search(left, q, top_k, candidates)
        self._search(right, q, top_k, candidates)

    @staticmethod
    def _insert(candidates, idx, sim, top_k):
        if len(candidates) < top_k:
            candidates.append((idx, sim))
            if len(candidates) == top_k:
                candidates.sort(key=lambda x: -x[1])
        elif sim > candidates[-1][1]:
            candidates[-1] = (idx, sim)
            candidates.sort(key=lambda x: -x[1])


class ANNIndex:
    """hnswlib → ball tree → brute-force cosine index
    (reference search.py:101-210); ``method="device"`` is exact cosine
    top-k on ``device``."""

    def __init__(self, graph, embeddings: np.ndarray, method: str = "hnsw",
                 device=None):
        if method not in ("hnsw", "brute", "device"):
            raise ValueError(
                f"Unknown method: '{method}'. Use 'hnsw', 'brute', or 'device'."
            )
        self._graph = graph
        self._embeddings = embeddings
        self._method = method
        self._n, self._dim = embeddings.shape
        self._normalized = embeddings / np.maximum(
            np.linalg.norm(embeddings, axis=1, keepdims=True), 1e-10
        )
        self._hnsw_index = None
        self._ball_tree = None
        self._device_table = None
        if method == "device":
            # exact cosine top-k on the card: one product + torch.topk
            self._device_table = torch.from_numpy(np.ascontiguousarray(
                self._normalized, dtype=np.float32)).to(resolve_device(device))
        if method == "hnsw":
            try:
                import hnswlib

                self._hnsw_index = hnswlib.Index(space="cosine", dim=self._dim)
                self._hnsw_index.init_index(
                    max_elements=self._n, ef_construction=200, M=16
                )
                self._hnsw_index.add_items(self._normalized, np.arange(self._n))
                self._hnsw_index.set_ef(50)
            except ImportError:
                self._ball_tree = _BallTree(self._embeddings)

    def query(self, entity_id: str, top_k: int = 10,
              exclude_self: bool = True) -> List[Dict]:
        if top_k <= 0:
            raise ValueError(f"top_k must be positive, got {top_k}")
        idx = self._graph.get_entity_index(entity_id)
        fetch_k = top_k + 1 if exclude_self else top_k
        results = self._query_internal(self._embeddings[idx], fetch_k)
        if exclude_self:
            results = [r for r in results if r["entity_id"] != entity_id]
        return results[:top_k]

    def query_vector(self, vector: np.ndarray, top_k: int = 10) -> List[Dict]:
        if top_k <= 0:
            raise ValueError(f"top_k must be positive, got {top_k}")
        return self._query_internal(vector, top_k)

    def query_batch(self, vectors: np.ndarray, top_k: int = 10) -> List[List[Dict]]:
        """Top-k for a (Q, dim) block of query vectors at once (serving path).

        The "device" method runs one full-float32 (Q, D)·(D, N) product and
        ``torch.topk`` on the card; "brute" is vectorized numpy; "hnsw"
        uses the library's native batch knn.  Returns one result list per
        query row.
        """
        if top_k <= 0:
            raise ValueError(f"top_k must be positive, got {top_k}")
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self._dim:
            raise ValueError(
                f"vectors must have shape (Q, {self._dim}), got {vectors.shape}"
            )
        k = min(top_k, self._n)
        qn = vectors / np.maximum(
            np.linalg.norm(vectors, axis=1, keepdims=True), 1e-10
        )
        if self._method == "device":
            q = torch.from_numpy(np.ascontiguousarray(qn)).to(
                self._device_table.device)
            sims, idx = torch.topk(_similarities(q, self._device_table), k,
                                   dim=1)
            sims, idx = sims.cpu().numpy(), idx.cpu().numpy()
            return [self._results(idx[i], sims[i]) for i in range(len(qn))]
        if self._method == "brute":
            sims = qn @ self._normalized.T  # (Q, N)
            top = np.argpartition(sims, -k, axis=1)[:, -k:]
            rs = np.take_along_axis(sims, top, axis=1)
            order = np.argsort(rs, axis=1)[:, ::-1]
            top = np.take_along_axis(top, order, axis=1)
            rs = np.take_along_axis(rs, order, axis=1)
            return [self._results(top[i], rs[i]) for i in range(len(qn))]
        if self._hnsw_index is not None:
            if k > 50:  # hnswlib raises when k > ef (pinned at 50 on build)
                self._hnsw_index.set_ef(k)
            labels, distances = self._hnsw_index.knn_query(qn, k=k)
            return [
                self._results(labels[i], 1.0 - distances[i])
                for i in range(len(qn))
            ]
        return [
            self._results(*self._ball_tree.query(v, k)) for v in vectors
        ]

    def _query_internal(self, query_vec: np.ndarray, top_k: int) -> List[Dict]:
        k = min(top_k, self._n)
        if self._method == "device":
            q = torch.from_numpy(np.asarray(_unit(query_vec),
                                            dtype=np.float32)).to(
                self._device_table.device)
            sims, idx = torch.topk(
                _similarities(q[None, :], self._device_table)[0], k)
            return self._results(idx.cpu().numpy(), sims.cpu().numpy())
        if self._method == "brute":
            sims = self._normalized @ _unit(query_vec)
            top = np.argpartition(sims, -k)[-k:]
            top = top[np.argsort(sims[top])[::-1]]
            return self._results(top, sims[top])
        if self._hnsw_index is not None:
            if k > 50:  # hnswlib raises when k > ef (pinned at 50 on build)
                self._hnsw_index.set_ef(k)
            labels, distances = self._hnsw_index.knn_query(
                _unit(query_vec).reshape(1, -1), k=k
            )
            return self._results(labels[0], 1.0 - distances[0])
        indices, sims = self._ball_tree.query(query_vec, k)
        return self._results(indices, sims)

    def _results(self, indices, sims) -> List[Dict]:
        ids = self._graph.entity_ids
        return [
            {"entity_id": ids[int(i)], "index": int(i), "similarity": float(s)}
            for i, s in zip(indices, sims)
        ]


class ShardedDeviceIndex:
    """Exact cosine top-k over a device-RESIDENT table, the serving path
    for large embedding tables (cleora_tpu/search.py:229-401).

    The L2-normalized (N, D) table is placed ONCE (optionally bfloat16 for
    double capacity) and stays resident: on one card without ``mesh``, or
    with ``mesh`` (a ``parallel.ShardGroup``) cut by rows, rank r holding
    rows ``[r·rps, (r + 1)·rps)`` of the table padded to
    ``rps = ⌈max(N, P) / P⌉`` rows a rank.  Each query batch is one
    full-float32 product with the rank's rows (bfloat16 rows upcast,
    products summed in float32) and ``torch.topk`` of ``min(k, rps)`` with
    the padded rows masked to −inf; under a group an all-gather of every
    rank's (Q, k) candidates and their global ids and a final top-k follow.
    Every rank then holds the same answer, so every rank of the group must
    make the same calls.  No part of the table returns to the host except
    the rows ``query`` fetches (from their owner)."""

    def __init__(self, graph, embeddings: np.ndarray, mesh=None,
                 dtype: str = "float32", device=None):
        if dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"Unknown dtype '{dtype}'. Use 'float32' or 'bfloat16'."
            )
        if mesh is not None:
            from .parallel.algorithms import _mesh_for

            mesh = _mesh_for(mesh, None, device)
            dev, world, rank = mesh.device, mesh.world_size, mesh.rank
        else:
            dev, world, rank = resolve_device(device), 1, 0
        self._graph = graph
        self._mesh = mesh
        emb = np.asarray(embeddings)
        self._n, self._dim = emb.shape
        # row norms once (N floats); the rank's rows are normalized, cast
        # and uploaded in row blocks, so the host never holds a second copy
        norms = np.maximum(
            np.sqrt(np.einsum("ij,ij->i", emb, emb,
                              dtype=np.float32)), 1e-10
        ).astype(np.float32)[:, None]
        self._n_padded = -(-max(self._n, world) // world) * world
        self._rps = self._n_padded // world
        self._base = rank * self._rps
        tdtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        self._table = torch.zeros((self._rps, self._dim), dtype=tdtype,
                                  device=dev)
        hi = min(self._base + self._rps, self._n)
        for lo in range(self._base, hi, _ROW_BLOCK):
            top = min(lo + _ROW_BLOCK, hi)
            block = emb[lo:top].astype(np.float32) / norms[lo:top]
            self._table[lo - self._base:top - self._base] = torch.from_numpy(
                block).to(dev).to(tdtype)

    def query_batch(self, vectors: np.ndarray,
                    top_k: int = 10) -> List[List[Dict]]:
        """Global top-k for a (Q, dim) block: the product on the rank's
        rows, and under a group the merge of every rank's candidates."""
        if top_k <= 0:
            raise ValueError(f"top_k must be positive, got {top_k}")
        vectors = np.asarray(vectors, dtype=np.float32)
        if vectors.ndim != 2 or vectors.shape[1] != self._dim:
            raise ValueError(
                f"vectors must have shape (Q, {self._dim}), got {vectors.shape}"
            )
        k = min(top_k, self._n)
        qn = vectors / np.maximum(
            np.linalg.norm(vectors, axis=1, keepdims=True), 1e-10
        )
        q = torch.from_numpy(np.ascontiguousarray(qn)).to(
            self._table.device).to(self._table.dtype)
        sims = _similarities(q, self._table)
        # mask padded rows (zero vectors would outrank negative cosines)
        sims[:, max(self._n - self._base, 0):] = -torch.inf
        # a rank may hold fewer than k rows; the P·k_local candidates still
        # cover the global top-k (k ≤ n ≤ P·rps)
        sims, idx = torch.topk(sims, min(k, self._rps), dim=1)
        if self._mesh is not None:
            nq = q.shape[0]
            idx = idx + self._base
            s_all = self._mesh.all_gather(sims).reshape(-1, nq, sims.shape[1])
            i_all = self._mesh.all_gather(idx).reshape(-1, nq, idx.shape[1])
            s_all = s_all.permute(1, 0, 2).reshape(nq, -1)
            i_all = i_all.permute(1, 0, 2).reshape(nq, -1)
            sims, pick = torch.topk(s_all, k, dim=1)
            idx = torch.gather(i_all, 1, pick)
        sims, idx = sims.cpu().numpy(), idx.cpu().numpy()
        return [self._results(idx[i], sims[i]) for i in range(len(qn))]

    def query_vector(self, vector: np.ndarray, top_k: int = 10) -> List[Dict]:
        return self.query_batch(
            np.asarray(vector, dtype=np.float32).reshape(1, -1), top_k
        )[0]

    def query(self, entity_id: str, top_k: int = 10,
              exclude_self: bool = True) -> List[Dict]:
        if top_k <= 0:
            raise ValueError(f"top_k must be positive, got {top_k}")
        idx = self._graph.get_entity_index(entity_id)
        fetch_k = top_k + 1 if exclude_self else top_k
        table_row = np.asarray(self._row(idx), dtype=np.float32)
        results = self.query_batch(table_row.reshape(1, -1), fetch_k)[0]
        if exclude_self:
            results = [r for r in results if r["entity_id"] != entity_id]
        return results[:top_k]

    def _row(self, idx: int) -> np.ndarray:
        """One table row as float32, fetched from the card of the rank that
        holds it (a broadcast under a group)."""
        owner, local = divmod(int(idx), self._rps)
        if self._mesh is None:
            return self._table[local].float().cpu().numpy()
        row = (self._table[local].float() if owner == self._mesh.rank else
               torch.empty((self._dim,), device=self._table.device))
        return self._mesh.broadcast_(row, owner).cpu().numpy()

    def _results(self, indices, sims) -> List[Dict]:
        ids = self._graph.entity_ids
        return [
            {"entity_id": ids[int(i)], "index": int(i), "similarity": float(s)}
            for i, s in zip(indices, sims)
        ]
