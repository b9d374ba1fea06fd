"""cleora_tpu_torch — the Cleora hypergraph embedder in PyTorch for one
NVIDIA H100.

The main path is ``embed(graph)``: the host builds the hypergraph into a
row-normalised Markov CSR, the card builds the hash init (kernel K3) and
runs ``num_iterations`` × [SpMM propagate (kernel K1) → row normalise
(kernel K2) → PCA whiten (float32 matmul + eigh)].  ``embed_with_attention``
adds the edge-attention weights of kernel K4 before each SpMM.  The kernels
are hand-written CUDA (``kernels/``), built from source at first use.

Every entry point that reaches the device runs on CUDA unless the caller
passes ``device="cpu"``, which runs the kernels' plain PyTorch versions.
Without a card and without ``device="cpu"`` a call raises.  The functions
that the JAX package computes on the host with numpy (``whiten_embeddings``,
``supervised_refine``, ``predict_links``, ``find_most_similar``,
``cosine_similarity``, ``_normalize``) are numpy here too.
"""

from __future__ import annotations

import os
import warnings
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ._util import resolve_device, to_host
from .ops.attention import attention_step
from .ops.loop import (
    effective_residual_weight,
    embed_loop,
    embed_loop_convergence,
    embed_step,
)
from .ops.memory import check_device_fit
from .ops.spmm import CsrMatrix
from .sparse import SparseMatrix

DEFAULT_FEATURE_DIM = 256
DEFAULT_NUM_ITERATIONS = 40

__version__ = "0.1.0"

__all__ = [
    "DEFAULT_FEATURE_DIM", "DEFAULT_NUM_ITERATIONS", "SparseMatrix",
    "CleoraEmbedder", "cosine_similarity", "embed", "embed_dim_sharded",
    "embed_directed", "embed_edge_features", "embed_inductive",
    "embed_multiscale", "embed_streaming", "embed_using_baseline_cleora",
    "embed_weighted", "embed_with_attention", "embed_with_node_features",
    "find_most_similar", "predict_links", "propagate_gpu", "propagate_tpu",
    "remove_edges", "supervised_refine", "update_graph", "whiten_embeddings",
]

def embed_using_baseline_cleora(graph, feature_dim: int, iter: int,
                                device=None):
    """Parity helper (pycleora/__init__.py:16-21): explicit per-iter loop,
    propagating on ``device`` and post-processing on the host."""
    embeddings = graph.initialize_deterministically(feature_dim)
    for _ in range(iter):
        embeddings = graph.left_markov_propagate(embeddings, device=device)
        embeddings = _postprocess_iteration(embeddings, "l2", True)
    return embeddings


def _validate_propagation(propagation: str):
    if propagation not in ("left", "symmetric"):
        raise ValueError(
            f"Unknown propagation type: '{propagation}'. Use 'left' or 'symmetric'."
        )


def _compute_rmse(current: np.ndarray, previous: np.ndarray) -> float:
    diff = current.astype(np.float64, copy=False) - previous.astype(np.float64, copy=False)
    return float(np.sqrt(np.mean(diff * diff)))


def embed(
    graph: SparseMatrix,
    feature_dim: int = DEFAULT_FEATURE_DIM,
    num_iterations: Union[int, str] = DEFAULT_NUM_ITERATIONS,
    propagation: str = "left",
    normalization: str = "l2",
    seed: int = 0,
    initial_embeddings: Optional[np.ndarray] = None,
    num_workers: Optional[int] = None,
    callback: Optional[Callable[[int, np.ndarray], None]] = None,
    residual_weight: float = 0.0,
    convergence_threshold: float = 0.0,
    whiten: bool = True,
    dtype: str = "float32",
    canonical_shapes: Optional[bool] = None,
    device=None,
) -> np.ndarray:
    """Cleora embedding: num_iterations × [propagate → normalize → whiten].

    Semantics parity with the reference embed() (pycleora/__init__.py:51-127)
    and with ``cleora_tpu.embed``: normalization l2/l1/spectral/none, both
    residual behaviours, RMSE convergence checked from the second iteration,
    a per-iteration ``callback(i, embeddings)``, initial embeddings and
    whitening.

    ``dtype="bfloat16"`` stores the embedding state in bf16 while the SpMM,
    normalization and whitening compute in float32.  The returned array is
    always a writable float32 numpy array.

    ``canonical_shapes`` exists for the TPU's compile cache and is accepted
    and ignored.  ``num_workers`` is ignored on the device.  ``device=None``
    means CUDA; pass ``device="cpu"`` for the plain PyTorch path.

    A streamed build (:class:`~.graph.stream.DiskGraph`) goes through the
    sharded loop (:func:`~.parallel.embed_sharded`), which reads the
    memmapped CSR one shard's rows at a time: one shard on one card, or
    one per rank of an initialized process group.
    """
    if dtype not in ("float32", "bfloat16"):
        raise ValueError(
            f"Unknown dtype '{dtype}'. Use 'float32' or 'bfloat16'."
        )
    if isinstance(num_iterations, str):
        if num_iterations == "auto":
            num_iterations = DEFAULT_NUM_ITERATIONS
        else:
            raise ValueError(
                f"num_iterations must be an int or 'auto', got '{num_iterations}'"
            )
    if not hasattr(graph, "data"):
        # streamed build: warn only on an EXPLICIT canonical request, as
        # the JAX package does (its default path does not warn)
        if canonical_shapes or (
            canonical_shapes is None
            and os.environ.get("CLEORA_TPU_CANON") == "1"
        ):
            warnings.warn(
                "canonical_shapes is not supported for streamed-build "
                "(DiskGraph) inputs; the sharded loop uses its exact-shape "
                "layout, so a new graph shape pays the full cold compile.",
                stacklevel=2,
            )
        from .parallel.embed import embed_sharded

        return embed_sharded(
            graph, feature_dim=feature_dim, num_iterations=num_iterations,
            propagation=propagation, normalization=normalization, seed=seed,
            whiten=whiten, residual_weight=residual_weight,
            convergence_threshold=convergence_threshold,
            initial_embeddings=initial_embeddings, dtype=dtype,
            callback=callback, device=device,
        )
    _validate_propagation(propagation)
    if normalization not in ("l2", "l1", "spectral", "none"):
        raise ValueError(
            f"Unknown normalization method: {normalization}. "
            "Use 'l2', 'l1', 'spectral', or 'none'."
        )

    # which reference path would this configuration have taken?  (Their
    # residual semantics differ — see effective_residual_weight.)
    residual_weight = effective_residual_weight(
        residual_weight,
        rust_fast_semantics=(initial_embeddings is None and callback is None
                             and normalization == "l2" and not whiten),
    )

    if initial_embeddings is not None:
        x0 = np.asarray(initial_embeddings, dtype=np.float32)
        if x0.shape[0] != graph.num_entities:
            raise ValueError(
                f"initial_embeddings has {x0.shape[0]} rows but graph has "
                f"{graph.num_entities} entities"
            )
        feature_dim = x0.shape[1]

    dev = resolve_device(device)
    check_device_fit(graph.num_entities, int(feature_dim), graph.num_edges,
                     dtype, dev)
    csr = graph._device_csr(propagation, dev)
    if initial_embeddings is None:
        # kernel K3 builds the hash init on the card (the host's on the CPU)
        x = graph._initial_state(int(feature_dim), seed, dev)
    else:
        x = torch.from_numpy(np.ascontiguousarray(x0)).to(dev)
    if dtype == "bfloat16":
        x = x.to(torch.bfloat16)
    w = float(residual_weight)

    if callback is None and convergence_threshold <= 0:
        return to_host(embed_loop(csr, x, int(num_iterations), w,
                                  normalization, bool(whiten)))

    if callback is None:
        out, _ = embed_loop_convergence(
            csr, x, int(num_iterations), w, float(convergence_threshold),
            normalization, bool(whiten),
        )
        return to_host(out)

    # callback path: the host sees every iteration; convergence is checked
    # on the host copies, as the reference's Python loop does
    host = to_host(x)
    for i in range(int(num_iterations)):
        x = embed_step(csr, x, w, normalization, bool(whiten))
        prev, host = host, to_host(x)
        callback(i, host.copy())
        if convergence_threshold > 0 and i > 0:
            if _compute_rmse(host, prev) < convergence_threshold:
                break
    return host


def embed_dim_sharded(
    graph: SparseMatrix,
    feature_dim: int = DEFAULT_FEATURE_DIM,
    slice_dim: int = 64,
    num_iterations: Union[int, str] = DEFAULT_NUM_ITERATIONS,
    propagation: str = "left",
    normalization: str = "l2",
    seed: int = 0,
    whiten: bool = False,
    slice_callback: Optional[Callable[[int, np.ndarray], None]] = None,
    device=None,
    **embed_kwargs,
) -> np.ndarray:
    """The reference FAQ's embeddings-don't-fit workflow (README.md:359-361):
    run the loop per dimension slice, concatenate, and L2-renormalize the
    concatenation.

    Slice k seeds its deterministic init with ``seed + k·slice_dim``, which
    makes the concatenated init exactly equal the full-dim hash init.  With
    whiten=False (the default here — whitening mixes dimensions and is
    per-slice if enabled) the only difference from a full-dim run is
    per-slice instead of full-vector normalization.  ``slice_callback(k,
    slice_embeddings)`` supports persist-to-disk flows.  ``device`` and
    ``embed_kwargs`` go to :func:`embed`.
    """
    if feature_dim % slice_dim != 0:
        raise ValueError(
            f"feature_dim ({feature_dim}) must be a multiple of slice_dim "
            f"({slice_dim})"
        )
    if "initial_embeddings" in embed_kwargs:
        raise ValueError(
            "embed_dim_sharded derives each slice's init from the "
            "deterministic hash (seed + k*slice_dim); initial_embeddings "
            "is not supported — slice it yourself and call embed() per "
            "slice instead"
        )
    slices = []
    for k in range(feature_dim // slice_dim):
        # a DiskGraph's slices go through the sharded loop, via embed()
        part = embed(
            graph,
            feature_dim=slice_dim,
            num_iterations=num_iterations,
            propagation=propagation,
            normalization=normalization,
            seed=seed + k * slice_dim,
            whiten=whiten,
            device=device,
            **embed_kwargs,
        )
        if slice_callback is not None:
            slice_callback(k, part)
        slices.append(part)
    return _normalize(np.concatenate(slices, axis=1), "l2")


def whiten_embeddings(
    embeddings: np.ndarray, n_components: Optional[int] = None
) -> np.ndarray:
    """PCA whitening, numerically matching the reference host implementation
    (pycleora/__init__.py:130-164): float64 mean/covariance/eigh, float32
    projection.  For the on-device float32 variant see ops.whiten.
    """
    embeddings = np.asarray(embeddings)
    n, d = embeddings.shape
    if n <= 1:
        return embeddings.copy()

    mean = embeddings.mean(axis=0, dtype=np.float64)
    centered = embeddings.astype(np.float64) - mean
    cov = (centered.T @ centered) / (n - 1)

    eigenvalues, eigenvectors = np.linalg.eigh(cov)
    idx = np.argsort(eigenvalues)[::-1]
    eigenvalues = eigenvalues[idx]
    eigenvectors = eigenvectors[:, idx]

    if n_components is not None:
        eigenvalues = eigenvalues[:n_components]
        eigenvectors = eigenvectors[:, :n_components]

    scale = 1.0 / np.sqrt(np.maximum(eigenvalues, 1e-10))
    transform = (eigenvectors * scale).astype(np.float32)
    mean_f32 = mean.astype(np.float32)
    return ((embeddings.astype(np.float32) - mean_f32) @ transform).astype(np.float32)


def embed_with_node_features(
    graph: SparseMatrix,
    node_features: Dict[str, np.ndarray],
    num_iterations: int = DEFAULT_NUM_ITERATIONS,
    propagation: str = "left",
    normalization: str = "l2",
    feature_weight: float = 0.5,
    num_workers: Optional[int] = None,
    device=None,
) -> np.ndarray:
    """Warm-start the embed from a convex mix of the deterministic hash
    init and user-supplied feature vectors: nodes named in
    ``node_features`` start at ``(1−w)·hash_init + w·feature``, everything
    else at the plain hash init; names absent from the graph are ignored
    (parity: pycleora/__init__.py:167-203).  The blend runs on the host,
    as in the JAX package."""
    if not node_features:
        raise ValueError(
            "node_features must be a non-empty dict of entity_id -> feature_vector"
        )

    names = list(node_features)
    feat_dim = len(node_features[names[0]])
    stacked = np.empty((len(names), feat_dim), dtype=np.float32)
    for i, name in enumerate(names):
        vec = np.asarray(node_features[name], dtype=np.float32)
        if vec.shape != (feat_dim,):
            raise ValueError(
                f"Feature for '{name}' has dimension "
                f"{vec.shape[-1] if vec.ndim else 0}, expected {feat_dim}"
            )
        stacked[i] = vec

    x0 = graph.initialize_deterministically(feat_dim)
    index_map = graph._index_map  # cached; names absent from the graph → -1
    idx = np.fromiter((index_map.get(n, -1) for n in names),
                      dtype=np.int64, count=len(names))
    known = idx >= 0
    rows = idx[known]
    x0[rows] = (1.0 - feature_weight) * x0[rows] + feature_weight * stacked[known]
    return embed(
        graph,
        feature_dim=feat_dim,
        num_iterations=num_iterations,
        propagation=propagation,
        normalization=normalization,
        initial_embeddings=x0,
        num_workers=num_workers,
        device=device,
    )


def embed_with_attention(
    graph: SparseMatrix,
    feature_dim: int = DEFAULT_FEATURE_DIM,
    num_iterations: int = DEFAULT_NUM_ITERATIONS,
    propagation: str = "left",
    normalization: str = "l2",
    attention_temperature: float = 1.0,
    seed: int = 0,
    num_workers: Optional[int] = None,
    callback: Optional[Callable[[int, np.ndarray], None]] = None,
    whiten: bool = True,
    device=None,
) -> np.ndarray:
    """Per-iteration softmax dot-product attention over edges
    (parity: pycleora/__init__.py:206-276).

    The first iteration is a plain propagate step; each later one
    reweights the Markov matrix by softmax_row(cos(e_i, e_j)/T) over its
    edges, row-renormalizes it and propagates with it
    (:func:`~.ops.attention.attention_step`: the fused attention pass up
    to 1,024 columns; wider, K4 on the state itself, K1, K2).  The hash
    init is built on the card (K3).
    """
    _validate_propagation(propagation)
    if attention_temperature <= 0:
        raise ValueError(
            f"attention_temperature must be positive, got {attention_temperature}"
        )
    if num_iterations <= 0:
        raise ValueError(f"num_iterations must be positive, got {num_iterations}")

    dev = resolve_device(device)
    check_device_fit(graph.num_entities, int(feature_dim), graph.num_edges,
                     device=dev)
    csr = graph._device_csr(propagation, dev)
    x = graph._initial_state(int(feature_dim), seed, dev)
    x = embed_step(csr, x, 0.0, normalization, bool(whiten))
    if callback is not None:
        callback(0, to_host(x))
    for i in range(1, num_iterations):
        x = attention_step(csr, x, float(attention_temperature),
                           normalization, bool(whiten))
        if callback is not None:
            callback(i, to_host(x))
    return to_host(x)


def embed_multiscale(
    graph: SparseMatrix,
    feature_dim: int = DEFAULT_FEATURE_DIM,
    scales: Optional[List[int]] = None,
    propagation: str = "left",
    normalization: str = "l2",
    seed: int = 0,
    num_workers: Optional[int] = None,
    whiten: bool = True,
    device=None,
) -> np.ndarray:
    """Concatenate snapshots at multiple iteration scales
    (parity: pycleora/__init__.py:279-309)."""
    _validate_propagation(propagation)
    if scales is None:
        scales = [10, 20, 30, 40]
    if not scales or not all(isinstance(s, int) and s > 0 for s in scales):
        raise ValueError("scales must be a non-empty list of positive integers")

    dev = resolve_device(device)
    check_device_fit(graph.num_entities, int(feature_dim), graph.num_edges,
                     device=dev)
    csr = graph._device_csr(propagation, dev)
    x = graph._initial_state(int(feature_dim), seed, dev)

    snapshots = []
    current = 0
    for scale in sorted(scales):
        iters = scale - current
        if iters > 0:
            x = embed_loop(csr, x, iters, 0.0, normalization, bool(whiten))
            current = scale
        snapshots.append(to_host(x))
    return np.concatenate(snapshots, axis=1)


def embed_weighted(
    edges_with_weights: List[Tuple[str, float]],
    columns: str,
    feature_dim: int = DEFAULT_FEATURE_DIM,
    num_iterations: int = DEFAULT_NUM_ITERATIONS,
    propagation: str = "left",
    normalization: str = "l2",
    seed: int = 0,
    hyperedge_trim_n: int = 16,
    num_workers: Optional[int] = None,
    whiten: bool = True,
    device=None,
) -> Tuple[SparseMatrix, np.ndarray]:
    """Max-edge-weight diagonal reweighting + row renorm
    (parity: pycleora/__init__.py:312-359), propagated on ``device``."""
    edge_strs = [e for e, _ in edges_with_weights]
    graph = SparseMatrix.from_iterator(
        iter(edge_strs), columns, hyperedge_trim_n, num_workers
    )

    n = graph.num_entities
    weight_diag = np.ones(n, dtype=np.float64)
    index_map = graph._index_map
    for edge_str, w in edges_with_weights:
        for ent in edge_str.strip().split():
            idx = index_map.get(ent)
            if idx is not None:
                weight_diag[idx] = max(weight_diag[idx], w)

    data = graph.data
    base_vals = data.sym_vals if propagation == "symmetric" else data.left_vals
    coo_rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(data.indptr))
    vals = base_vals.astype(np.float64) * weight_diag[coo_rows]
    row_sums = np.zeros(n, dtype=np.float64)
    np.add.at(row_sums, coo_rows, vals)
    vals = vals / np.maximum(row_sums, 1e-10)[coo_rows]

    emb = _propagate_custom_coo(
        graph, coo_rows, data.indices, vals.astype(np.float32), feature_dim,
        num_iterations, normalization, whiten, seed, device=device,
    )
    return graph, emb


def _propagate_custom_coo(
    graph, coo_rows, coo_cols, coo_vals, feature_dim, num_iterations,
    normalization, whiten, seed, init=None, device=None,
):
    """Run the embed loop over a caller-supplied row-sorted COO matrix.
    Without ``init`` the loop starts from the hash init, built on the card
    by kernel K3."""
    dev = resolve_device(device)
    n = graph.num_entities
    csr = CsrMatrix.from_coo(coo_rows, coo_cols, coo_vals, n, dev)
    if init is not None:
        x0 = torch.from_numpy(
            np.ascontiguousarray(init, dtype=np.float32)).to(dev)
    else:
        x0 = graph._initial_state(int(feature_dim), seed, dev)
    return to_host(embed_loop(csr, x0, int(num_iterations), 0.0,
                              normalization, bool(whiten)))


def embed_directed(
    edges: List[str],
    columns: str,
    feature_dim: int = DEFAULT_FEATURE_DIM,
    num_iterations: int = DEFAULT_NUM_ITERATIONS,
    normalization: str = "l2",
    seed: int = 0,
    hyperedge_trim_n: int = 16,
    num_workers: Optional[int] = None,
    whiten: bool = True,
    device=None,
) -> Tuple[SparseMatrix, np.ndarray]:
    """Keep only (i, j) transition entries ordered as in the input lines
    (parity: pycleora/__init__.py:362-410)."""
    graph = SparseMatrix.from_iterator(iter(edges), columns, hyperedge_trim_n, num_workers)

    directed_pairs = set()
    for edge_str in edges:
        parts = edge_str.strip().split()
        for i in range(len(parts)):
            for j in range(i + 1, len(parts)):
                directed_pairs.add((parts[i], parts[j]))

    data = graph.data
    n = graph.num_entities
    coo_rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(data.indptr))
    eids = graph.entity_ids
    keep = np.fromiter(
        (
            (eids[int(r)], eids[int(c)]) in directed_pairs
            for r, c in zip(coo_rows, data.indices)
        ),
        dtype=bool,
        count=coo_rows.shape[0],
    )
    rows_k = coo_rows[keep]
    cols_k = data.indices[keep].astype(np.int64)
    vals_k = data.left_vals[keep].astype(np.float64)
    row_sums = np.zeros(n, dtype=np.float64)
    np.add.at(row_sums, rows_k, vals_k)
    vals_k = vals_k / np.maximum(row_sums, 1e-10)[rows_k]

    emb = _propagate_custom_coo(
        graph, rows_k, cols_k, vals_k.astype(np.float32), feature_dim,
        num_iterations, normalization, whiten, seed, device=device,
    )
    return graph, emb


def supervised_refine(
    graph: SparseMatrix,
    embeddings: np.ndarray,
    positive_pairs: List[Tuple[str, str]],
    negative_pairs: Optional[List[Tuple[str, str]]] = None,
    learning_rate: float = 0.01,
    num_epochs: int = 50,
    margin: float = 0.5,
    num_negatives_per_positive: int = 5,
    callback: Optional[Callable[[int, float], None]] = None,
) -> np.ndarray:
    """Cosine triplet-loss SGD refinement on the host
    (parity: pycleora/__init__.py:413-512, including rng(42) neg sampling)."""
    if embeddings.shape[0] != graph.num_entities:
        raise ValueError(
            f"embeddings has {embeddings.shape[0]} rows but graph has "
            f"{graph.num_entities} entities"
        )

    x = embeddings.copy().astype(np.float64)
    n = graph.num_entities
    pos_idx = _pair_indices(graph, positive_pairs)
    neg_idx = (_pair_indices(graph, negative_pairs)
               if negative_pairs is not None else [])
    rng = np.random.default_rng(42)  # parity: fixed neg-sampling stream

    for epoch in range(num_epochs):
        epoch_loss = 0.0
        for i, j in pos_idx:
            hinge = _cosine_sgd_step(x, i, j, learning_rate)
            if hinge is None:
                continue  # degenerate norms skip the negatives too
            epoch_loss += hinge
            if negative_pairs is not None:
                contrast = neg_idx
            else:
                # drawn every positive step (even converged ones) so the
                # RNG stream is position-independent of the loss values
                draw = rng.choice(
                    n, size=min(num_negatives_per_positive, n - 1),
                    replace=False,
                )
                contrast = [(i, int(c)) for c in draw if c != i]
            for ni, nj in contrast[:num_negatives_per_positive]:
                h = _cosine_sgd_step(x, ni, nj, learning_rate,
                                     push_margin=margin)
                if h is not None:
                    epoch_loss += h

        mean_loss = epoch_loss / max(len(pos_idx), 1)
        if callback is not None:
            callback(epoch, mean_loss)
        if mean_loss < 1e-6:
            break

    return _normalize(x.astype(np.float32), "l2")


def _pair_indices(graph: SparseMatrix,
                  pairs: List[Tuple[str, str]]) -> List[Tuple[int, int]]:
    """Entity-name pairs → dense-index pairs, erroring on unknown names."""
    index_map = graph._index_map
    out = []
    for a, b in pairs:
        ia = index_map.get(a)
        ib = index_map.get(b)
        if ia is None:
            raise ValueError(f"Entity '{a}' not found in graph")
        if ib is None:
            raise ValueError(f"Entity '{b}' not found in graph")
        out.append((ia, ib))
    return out


def _cosine_sgd_step(x: np.ndarray, i: int, j: int, lr: float,
                     push_margin: Optional[float] = None):
    """One in-place cosine SGD step on rows (i, j) of ``x``.

    Default mode pulls the pair together (hinge 1 − cos); with
    ``push_margin`` it pushes them apart once cos exceeds the margin
    (hinge cos − margin), applying the negated gradient.  Returns the
    hinge loss, or None when either row's norm underflows (callers use
    that to skip a degenerate pair's whole step, reference semantics).
    Both row gradients are evaluated before either row is updated."""
    u, v = x[i], x[j]
    nu, nv = np.linalg.norm(u), np.linalg.norm(v)
    if nu < 1e-10 or nv < 1e-10:
        return None
    cos = np.dot(u, v) / (nu * nv)
    push = push_margin is not None
    hinge = max(0.0, cos - push_margin) if push else max(0.0, 1.0 - cos)
    if hinge > 0:
        gi = v / (nu * nv) - u * cos / (nu * nu)
        gj = u / (nu * nv) - v * cos / (nv * nv)
        if push:
            x[i] -= lr * gi
            x[j] -= lr * gj
        else:
            x[i] += lr * gi
            x[j] += lr * gj
    return hinge


def update_graph(
    existing_edges: List[str],
    new_edges: List[str],
    columns: str,
    hyperedge_trim_n: int = 16,
    num_workers: Optional[int] = None,
) -> SparseMatrix:
    all_edges = list(existing_edges) + list(new_edges)
    return SparseMatrix.from_iterator(iter(all_edges), columns, hyperedge_trim_n, num_workers)


def remove_edges(
    existing_edges: List[str],
    edges_to_remove: List[str],
    columns: str,
    hyperedge_trim_n: int = 16,
    num_workers: Optional[int] = None,
) -> SparseMatrix:
    remove_set = set(edges_to_remove)
    remaining = [e for e in existing_edges if e not in remove_set]
    if not remaining:
        raise ValueError("Cannot remove all edges from the graph")
    return SparseMatrix.from_iterator(iter(remaining), columns, hyperedge_trim_n, num_workers)


def embed_inductive(
    trained_graph: SparseMatrix,
    trained_embeddings: np.ndarray,
    existing_edges: List[str],
    new_edges: List[str],
    columns: str,
    num_iterations: int = DEFAULT_NUM_ITERATIONS,
    propagation: str = "left",
    normalization: str = "l2",
    hyperedge_trim_n: int = 16,
    num_workers: Optional[int] = None,
    device=None,
) -> Tuple[SparseMatrix, np.ndarray]:
    """Warm-start an updated graph from trained embeddings
    (parity: pycleora/__init__.py:540-580).  New entities start from
    ``np.random.randn · 0.01``, drawn from numpy's global stream as in the
    reference."""
    if trained_embeddings.shape[0] != trained_graph.num_entities:
        raise ValueError(
            f"trained_embeddings has {trained_embeddings.shape[0]} rows but graph "
            f"has {trained_graph.num_entities} entities"
        )

    updated_graph = update_graph(existing_edges, new_edges, columns,
                                 hyperedge_trim_n, num_workers)
    old_index_map = trained_graph._index_map
    dim = trained_embeddings.shape[1]
    init = np.random.randn(updated_graph.num_entities, dim).astype(np.float32) * 0.01
    for i, eid in enumerate(updated_graph.entity_ids):
        if eid in old_index_map:
            init[i] = trained_embeddings[old_index_map[eid]]

    updated_embeddings = embed(
        updated_graph,
        feature_dim=dim,
        num_iterations=num_iterations,
        propagation=propagation,
        normalization=normalization,
        initial_embeddings=init,
        num_workers=num_workers,
        device=device,
    )
    return updated_graph, updated_embeddings


def embed_streaming(
    edge_batches,
    columns: str,
    feature_dim: int = DEFAULT_FEATURE_DIM,
    num_iterations: int = DEFAULT_NUM_ITERATIONS,
    propagation: str = "left",
    normalization: str = "l2",
    hyperedge_trim_n: int = 16,
    num_workers: Optional[int] = None,
    batch_callback: Optional[Callable[[int, SparseMatrix, np.ndarray], None]] = None,
    device=None,
) -> Tuple[SparseMatrix, np.ndarray]:
    """Cumulative-batch streaming with warm starts
    (parity: pycleora/__init__.py:583-633).  Entities new in a batch start
    from ``np.random.randn · 0.01`` (numpy's global stream)."""
    all_edges: List[str] = []
    graph = None
    embeddings = None
    prev_entity_ids: List[str] = []

    for batch_idx, batch in enumerate(edge_batches):
        all_edges.extend(batch)
        graph = SparseMatrix.from_iterator(
            iter(all_edges), columns, hyperedge_trim_n, num_workers
        )

        if embeddings is not None:
            old_index_map = {eid: i for i, eid in enumerate(prev_entity_ids)}
            init = np.random.randn(graph.num_entities, feature_dim).astype(np.float32) * 0.01
            for i, eid in enumerate(graph.entity_ids):
                if eid in old_index_map:
                    old_idx = old_index_map[eid]
                    if old_idx < embeddings.shape[0]:
                        init[i] = embeddings[old_idx]
            embeddings = embed(
                graph, feature_dim=feature_dim, num_iterations=num_iterations,
                propagation=propagation, normalization=normalization,
                initial_embeddings=init, num_workers=num_workers,
                device=device,
            )
        else:
            embeddings = embed(
                graph, feature_dim=feature_dim, num_iterations=num_iterations,
                propagation=propagation, normalization=normalization,
                num_workers=num_workers, device=device,
            )

        prev_entity_ids = list(graph.entity_ids)
        if batch_callback is not None:
            batch_callback(batch_idx, graph, embeddings)

    return graph, embeddings


def predict_links(
    graph: SparseMatrix,
    embeddings: np.ndarray,
    top_k: int = 10,
    exclude_existing: bool = True,
    source_entities: Optional[List[str]] = None,
) -> List[Dict]:
    """Cosine-similarity link prediction on the host
    (parity: pycleora/__init__.py:636-681)."""
    norms = np.linalg.norm(embeddings, axis=1, keepdims=True)
    normed = embeddings / np.maximum(norms, 1e-10)

    fwd = rev = None
    if exclude_existing:
        # existing-edge masking: out-neighbors from the CSR plus
        # in-neighbors from its transpose
        rows, cols, _, n, _ = graph.to_sparse_csr()
        rows = rows.astype(np.int64)
        cols = cols.astype(np.int64)
        from scipy.sparse import csr_matrix

        fwd = csr_matrix(
            (np.ones(len(rows), np.int8), (rows, cols)), shape=(n, n)
        )
        rev = fwd.T.tocsr()

    if source_entities is not None:
        source_indices = [graph.get_entity_index(eid) for eid in source_entities]
    else:
        source_indices = list(range(graph.num_entities))

    predictions = []
    for src_idx in source_indices:
        sims = normed @ normed[src_idx]
        sims[src_idx] = -2.0
        if exclude_existing:
            sims[fwd.indices[fwd.indptr[src_idx]:fwd.indptr[src_idx + 1]]] = -2.0
            sims[rev.indices[rev.indptr[src_idx]:rev.indptr[src_idx + 1]]] = -2.0
        top_indices = np.argsort(sims)[::-1][:top_k]
        for tgt_idx in top_indices:
            if sims[tgt_idx] <= -2.0:
                continue
            predictions.append(
                {
                    "source": graph.entity_ids[src_idx],
                    "target": graph.entity_ids[int(tgt_idx)],
                    "score": float(sims[int(tgt_idx)]),
                }
            )

    predictions.sort(key=lambda x: x["score"], reverse=True)
    return predictions[:top_k]


def propagate_gpu(
    graph: SparseMatrix,
    embeddings: np.ndarray,
    num_iterations: int = DEFAULT_NUM_ITERATIONS,
    propagation: str = "left",
    normalization: str = "l2",
    device=None,
    callback: Optional[Callable[[int, np.ndarray], None]] = None,
    whiten: bool = True,
) -> np.ndarray:
    """Accelerator propagation from caller-supplied embeddings (reference
    API, pycleora/__init__.py:684-739): the embed loop on ``device``."""
    _validate_propagation(propagation)
    if normalization not in ("l2", "l1", "none"):
        raise ValueError(
            "GPU propagation supports 'l2', 'l1', or 'none' normalization. "
            f"Got: '{normalization}'"
        )
    return embed(
        graph,
        num_iterations=num_iterations,
        propagation=propagation,
        normalization=normalization,
        initial_embeddings=np.asarray(embeddings, dtype=np.float32),
        callback=callback,
        whiten=whiten,
        device=device,
    )


propagate_tpu = propagate_gpu  # the JAX package's name, kept for API parity


def cosine_similarity(a: np.ndarray, b: np.ndarray) -> float:
    a_flat = np.asarray(a).flatten()
    b_flat = np.asarray(b).flatten()
    dot = np.dot(a_flat, b_flat)
    norm_a = np.linalg.norm(a_flat)
    norm_b = np.linalg.norm(b_flat)
    if norm_a == 0 or norm_b == 0:
        return 0.0
    return float(dot / (norm_a * norm_b))


def find_most_similar(
    graph: SparseMatrix,
    embeddings: np.ndarray,
    query_entity: str,
    top_k: int = 10,
    exclude_self: bool = True,
) -> List[Dict]:
    query_idx = graph.get_entity_index(query_entity)
    query_vec = embeddings[query_idx]

    norms = np.linalg.norm(embeddings, axis=1, keepdims=True)
    normalized = embeddings / np.maximum(norms, 1e-10)
    query_norm = query_vec / max(np.linalg.norm(query_vec), 1e-10)
    similarities = normalized @ query_norm

    if exclude_self:
        similarities[query_idx] = -1.0

    top_indices = np.argsort(similarities)[::-1][:top_k]
    return [
        {
            "entity_id": graph.entity_ids[idx],
            "index": int(idx),
            "similarity": float(similarities[idx]),
        }
        for idx in top_indices
    ]


def embed_edge_features(
    graph: SparseMatrix,
    edge_features: Dict[str, np.ndarray],
    feature_dim: int = DEFAULT_FEATURE_DIM,
    num_iterations: int = DEFAULT_NUM_ITERATIONS,
    propagation: str = "left",
    normalization: str = "l2",
    combine: str = "concat",
    num_workers: Optional[int] = None,
    whiten: bool = True,
    device=None,
) -> np.ndarray:
    """Structural + edge-feature embeddings (parity: pycleora/__init__.py:784-852)."""
    _validate_propagation(propagation)

    struct_emb = embed(
        graph, feature_dim=feature_dim, num_iterations=num_iterations,
        propagation=propagation, normalization=normalization,
        num_workers=num_workers, whiten=whiten, device=device,
    )
    if not edge_features:
        return struct_emb

    sample_feat = next(iter(edge_features.values()))
    edge_feat_dim = len(sample_feat)
    n = graph.num_entities
    index_map = graph._index_map

    node_feats = np.zeros((n, edge_feat_dim), dtype=np.float64)
    node_counts = np.zeros(n, dtype=np.float64)
    for edge_key, feat in edge_features.items():
        parts = edge_key.strip().split()
        if len(parts) == 2:
            ia = index_map.get(parts[0])
            ib = index_map.get(parts[1])
            if ia is not None and ib is not None:
                feat_arr = np.array(feat, dtype=np.float64)
                node_feats[ia] += feat_arr
                node_feats[ib] += feat_arr
                node_counts[ia] += 1
                node_counts[ib] += 1
    node_feats /= np.maximum(node_counts, 1.0)[:, None]

    data = graph.data
    coo_rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(data.indptr))
    base_vals = data.sym_vals if propagation == "symmetric" else data.left_vals
    edge_emb = _propagate_custom_coo(
        graph, coo_rows, data.indices, base_vals, edge_feat_dim, num_iterations,
        "l2", whiten, 0, init=node_feats.astype(np.float32), device=device,
    )

    if combine == "concat":
        return np.concatenate([struct_emb, edge_emb], axis=1)
    if combine == "mean":
        min_dim = min(struct_emb.shape[1], edge_emb.shape[1])
        return (struct_emb[:, :min_dim] + edge_emb[:, :min_dim]) / 2.0
    if combine == "edge_only":
        return edge_emb
    raise ValueError(
        f"Unknown combine mode: '{combine}'. Use 'concat', 'mean', or 'edge_only'."
    )


class CleoraEmbedder:
    """sklearn-style wrapper (parity: pycleora/__init__.py:855-939);
    ``device`` goes to :func:`embed`."""

    def __init__(
        self,
        feature_dim: int = DEFAULT_FEATURE_DIM,
        num_iterations: int = DEFAULT_NUM_ITERATIONS,
        propagation: str = "left",
        normalization: str = "l2",
        columns: str = "complex::reflexive::node",
        seed: int = 0,
        hyperedge_trim_n: int = 16,
        num_workers: Optional[int] = None,
        whiten: bool = True,
        device=None,
    ):
        self.feature_dim = feature_dim
        self.num_iterations = num_iterations
        self.propagation = propagation
        self.normalization = normalization
        self.columns = columns
        self.seed = seed
        self.hyperedge_trim_n = hyperedge_trim_n
        self.num_workers = num_workers
        self.whiten = whiten
        self.device = device
        self.graph_ = None
        self.embeddings_ = None
        self.entity_ids_ = None

    def fit(self, edges: List[str], y=None):
        self.graph_ = SparseMatrix.from_iterator(
            iter(edges), self.columns, self.hyperedge_trim_n, self.num_workers
        )
        self.embeddings_ = embed(
            self.graph_,
            feature_dim=self.feature_dim,
            num_iterations=self.num_iterations,
            propagation=self.propagation,
            normalization=self.normalization,
            seed=self.seed,
            num_workers=self.num_workers,
            whiten=self.whiten,
            device=self.device,
        )
        self.entity_ids_ = list(self.graph_.entity_ids)
        return self

    def transform(self, edges: Optional[List[str]] = None) -> np.ndarray:
        if self.embeddings_ is None:
            raise RuntimeError("Call fit() before transform()")
        if edges is None:
            return self.embeddings_
        index_map = self.graph_._index_map
        seen = set()
        ordered_indices = []
        for edge in edges:
            for ent in edge.strip().split():
                if ent not in seen:
                    idx = index_map.get(ent)
                    if idx is not None:
                        seen.add(ent)
                        ordered_indices.append(idx)
        if not ordered_indices:
            raise ValueError(
                "None of the entities in edges were found in the fitted graph"
            )
        return self.embeddings_[ordered_indices]

    def fit_transform(self, edges: List[str], y=None) -> np.ndarray:
        return self.fit(edges, y).transform()

    def get_params(self, deep=True) -> Dict:
        return {
            "feature_dim": self.feature_dim,
            "num_iterations": self.num_iterations,
            "propagation": self.propagation,
            "normalization": self.normalization,
            "columns": self.columns,
            "seed": self.seed,
            "hyperedge_trim_n": self.hyperedge_trim_n,
            "num_workers": self.num_workers,
            "whiten": self.whiten,
            "device": self.device,
        }

    def set_params(self, **params):
        for key, value in params.items():
            if hasattr(self, key):
                setattr(self, key, value)
            else:
                raise ValueError(f"Invalid parameter: {key}")
        return self


def _normalize(embeddings: np.ndarray, method: str) -> np.ndarray:
    """Host normalization (parity: pycleora/__init__.py:942-960)."""
    if method == "l2":
        norms = np.linalg.norm(embeddings, ord=2, axis=-1, keepdims=True)
        return embeddings / np.maximum(norms, 1e-10)
    if method == "l1":
        norms = np.linalg.norm(embeddings, ord=1, axis=-1, keepdims=True)
        return embeddings / np.maximum(norms, 1e-10)
    if method == "spectral":
        norms = np.linalg.norm(embeddings, ord=2, axis=-1, keepdims=True)
        normalized = embeddings / np.maximum(norms, 1e-10)
        u, s, vt = np.linalg.svd(normalized, full_matrices=False)
        return u * s
    if method == "none":
        return embeddings
    raise ValueError(
        f"Unknown normalization method: {method}. Use 'l2', 'l1', 'spectral', or 'none'."
    )


def _postprocess_iteration(
    embeddings: np.ndarray, normalization: str, whiten: bool
) -> np.ndarray:
    embeddings = _normalize(embeddings, normalization)
    if whiten:
        embeddings = whiten_embeddings(embeddings)
    return embeddings
