"""Embedding visualization (reference: pycleora/viz.py).

``reduce_dimensions`` supports pca / tsne / umap.  The t-SNE is the
reference's built-in minimal implementation (cosine distances, entropy-tuned
Gaussian P, 300 momentum-SGD steps) with the gradient vectorized instead of
per-point; umap falls back to PCA when the package is missing.

A copy of cleora_tpu/viz.py (numpy only; matplotlib and umap are
imported lazily), held equal to it by tests/test_torch_host_modules.py.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def reduce_dimensions(
    embeddings: np.ndarray,
    method: str = "tsne",
    n_components: int = 2,
    seed: int = 42,
) -> np.ndarray:
    if method == "tsne":
        return _tsne_reduce(embeddings, n_components, seed)
    if method == "pca":
        return _pca_reduce(embeddings, n_components)
    if method == "umap":
        return _umap_reduce(embeddings, n_components, seed)
    raise ValueError(f"Unknown method: '{method}'. Use 'tsne', 'pca', or 'umap'.")


def _pca_reduce(embeddings: np.ndarray, n_components: int) -> np.ndarray:
    centered = embeddings - embeddings.mean(axis=0)
    u, s, _ = np.linalg.svd(centered, full_matrices=False)
    return u[:, :n_components] * s[:n_components]


def _conditional_probs(d_row: np.ndarray, i: int, perplexity: float,
                       tol: float = 1e-4, max_iter: int = 64):
    """Precision (beta) calibration for one row: bracketed binary search so
    that the Shannon entropy of p_{j|i} = softmax(-beta * d_ij) matches
    log(perplexity).  Returns the conditional distribution (self-prob 0)."""
    target = np.log(perplexity)
    beta, lo, hi = 1.0, 0.0, np.inf
    d = np.delete(d_row, i)  # exclude self from the softmax entirely
    p = np.full_like(d, 1.0 / max(d.shape[0], 1))
    for _ in range(max_iter):
        shifted = -beta * (d - d.min())  # max-shifted logits, stable
        w = np.exp(shifted)
        z = w.sum()
        p = w / z
        # H = -Σ p log p = log Z_shifted + beta·E[d - d_min]
        entropy = np.log(z) + beta * float((p * (d - d.min())).sum())
        if abs(entropy - target) < tol:
            break
        if entropy > target:  # too flat → sharpen
            lo = beta
            beta = beta * 2 if not np.isfinite(hi) else (beta + hi) / 2
        else:
            hi = beta
            beta = beta / 2 if lo == 0 else (beta + lo) / 2
    out = np.zeros_like(d_row)
    out[np.arange(d_row.shape[0]) != i] = p
    return out


def _tsne_reduce(embeddings: np.ndarray, n_components: int, seed: int) -> np.ndarray:
    """Exact t-SNE on cosine distances (van der Maaten & Hinton 2008).

    Independent implementation of the standard algorithm: per-row precision
    calibrated by bracketed binary search to a perplexity target, symmetrized
    joint P with early exaggeration (×12 for the first quarter of the
    optimization), Student-t low-dimensional kernel, and gradient descent
    with per-coordinate adaptive gains plus momentum (0.5, then 0.8 once
    exaggeration ends).  The reference ships a minimal t-SNE at this spot
    (pycleora/viz.py:27-86); only the module surface is
    kept — the optimizer and calibration here follow the published
    algorithm, not the reference's code.
    """
    x = np.asarray(embeddings, dtype=np.float64)
    n = x.shape[0]
    if n == 0:
        return np.zeros((0, n_components), dtype=np.float32)
    rng = np.random.default_rng(seed)

    norms = np.linalg.norm(x, axis=1, keepdims=True)
    unit = x / np.maximum(norms, 1e-10)
    dist = np.clip(1.0 - unit @ unit.T, 0.0, None)

    perplexity = float(min(30, max(2, n - 1)))
    cond = np.zeros((n, n))
    for i in range(n):
        cond[i] = _conditional_probs(dist[i], i, perplexity)
    joint = (cond + cond.T) / (2.0 * n)
    joint = np.maximum(joint, 1e-12)

    n_steps = 400
    exag_steps = n_steps // 4
    lr = max(50.0, n / 12.0)
    y = rng.standard_normal((n, n_components)) * 1e-2
    velocity = np.zeros_like(y)
    gains = np.ones_like(y)

    p_eff = joint * 12.0  # early exaggeration
    for step in range(n_steps):
        if step == exag_steps:
            p_eff = joint
        sq = (y * y).sum(axis=1)
        student = 1.0 / (1.0 + sq[:, None] + sq[None, :] - 2.0 * (y @ y.T))
        np.fill_diagonal(student, 0.0)
        q = np.maximum(student / max(student.sum(), 1e-12), 1e-12)

        coef = (p_eff - q) * student
        grad = 4.0 * (coef.sum(axis=1)[:, None] * y - coef @ y)

        # adaptive per-coordinate gains (increase when the gradient flips
        # sign against the velocity, decay when it agrees)
        flip = np.sign(grad) != np.sign(velocity)
        gains = np.where(flip, gains + 0.2, gains * 0.8)
        gains = np.maximum(gains, 0.01)

        momentum = 0.5 if step < exag_steps else 0.8
        velocity = momentum * velocity - lr * gains * grad
        y = y + velocity
        y = y - y.mean(axis=0)

    return y.astype(np.float32)


def _umap_reduce(embeddings: np.ndarray, n_components: int, seed: int) -> np.ndarray:
    try:
        import umap

        return umap.UMAP(
            n_components=n_components, random_state=seed
        ).fit_transform(embeddings)
    except ImportError:
        return _pca_reduce(embeddings, n_components)


def plot_embeddings(
    embeddings_2d: np.ndarray,
    labels: Optional[np.ndarray] = None,
    entity_ids: Optional[List[str]] = None,
    title: str = "Graph Embeddings",
    figsize: tuple = (10, 8),
    save_path: Optional[str] = None,
    show_labels: bool = False,
    point_size: int = 50,
    colormap: str = "tab10",
):
    """Scatter plot of 2-D embeddings, optionally class-colored and
    annotated.  Returns the saved path when ``save_path`` is given, else the
    (closed) figure.  API parity: pycleora/viz.py:96-150."""
    plt = _require_matplotlib()

    fig, ax = plt.subplots(figsize=figsize)
    xs, ys = embeddings_2d[:, 0], embeddings_2d[:, 1]
    groups: list
    if labels is None:
        groups = [(None, np.ones(len(xs), dtype=bool))]
    else:
        uniq = np.unique(labels)
        groups = [(lab, labels == lab) for lab in uniq]
        colors = plt.get_cmap(colormap, len(uniq))
    for k, (lab, mask) in enumerate(groups):
        kwargs = dict(s=point_size, alpha=0.7)
        if lab is not None:
            kwargs.update(c=[colors(k)], label=f"Class {lab}")
        ax.scatter(xs[mask], ys[mask], **kwargs)
    if labels is not None:
        ax.legend()

    if show_labels and entity_ids is not None:
        for eid, x, y in zip(entity_ids, xs, ys):
            ax.annotate(eid, (x, y), fontsize=7, alpha=0.8)

    ax.set(title=title, xlabel="Dimension 1", ylabel="Dimension 2")

    try:
        if save_path:
            fig.savefig(save_path, dpi=150, bbox_inches="tight")
            return save_path
        return fig
    finally:
        plt.close(fig)


def _require_matplotlib():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except ImportError:
        raise ImportError(
            "matplotlib is required for plotting. "
            "Install with: pip install matplotlib"
        )


def visualize(
    graph,
    embeddings: np.ndarray,
    labels: Optional[Dict[str, int]] = None,
    method: str = "tsne",
    title: str = "Graph Embeddings",
    save_path: Optional[str] = None,
    show_labels: bool = True,
    figsize: tuple = (12, 10),
):
    """reduce_dimensions + plot (reference viz.py:153-186)."""
    emb_2d = reduce_dimensions(embeddings, method=method)
    label_arr = None
    if labels is not None:
        label_arr = np.zeros(graph.num_entities, dtype=np.int32)
        for eid, label in labels.items():
            try:
                label_arr[graph.get_entity_index(eid)] = label
            except ValueError:
                pass
    return plot_embeddings(
        emb_2d, labels=label_arr, entity_ids=graph.entity_ids, title=title,
        save_path=save_path, show_labels=show_labels, figsize=figsize,
    )
