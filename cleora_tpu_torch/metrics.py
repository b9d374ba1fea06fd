"""Evaluation metrics — numerically matching the reference
(pycleora/metrics.py), vectorized.

``node_classification_scores`` (class-centroid cosine classifier, 80/20 split
seed 42) is THE accuracy metric behind the published benchmarks
(reference metrics.py:88-176; BASELINE.md).  RNG draw order is preserved
everywhere a seed matters, so scores are reproducible against the reference.

A copy of cleora_tpu/metrics.py (numpy and scipy only), held equal to it
by tests/test_torch_host_modules.py.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


def _row_normalize(x: np.ndarray) -> np.ndarray:
    norms = np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-10)
    return x / norms


def link_prediction_scores(
    graph,
    embeddings: np.ndarray,
    test_edges: List[Tuple[str, str]],
    negative_edges: Optional[List[Tuple[str, str]]] = None,
    num_negatives_per_positive: int = 50,
) -> Dict[str, float]:
    """AUC (trapezoid ROC), MRR, hits@{1,3,10,50} vs sampled negatives
    (reference metrics.py:5-85; negatives drawn with rng(42))."""
    index_map = {eid: i for i, eid in enumerate(graph.entity_ids)}
    n = graph.num_entities
    normed = _row_normalize(embeddings)

    pairs = [
        (index_map[a], index_map[b])
        for a, b in test_edges
        if a in index_map and b in index_map
    ]
    if not pairs:
        raise ValueError("No valid positive edges found")
    ia = np.array([p[0] for p in pairs])
    ib = np.array([p[1] for p in pairs])
    pos_arr = np.sum(normed[ia] * normed[ib], axis=1)

    rng = np.random.default_rng(42)
    if negative_edges is not None:
        neg_pairs = [
            (index_map[a], index_map[b])
            for a, b in negative_edges
            if a in index_map and b in index_map
        ]
        na = np.array([p[0] for p in neg_pairs], dtype=np.int64)
        nb = np.array([p[1] for p in neg_pairs], dtype=np.int64)
    else:
        # same rng stream as the reference's per-pair integers(0, n, size=2)
        draw = rng.integers(0, n, size=(len(pos_arr) * num_negatives_per_positive, 2))
        na, nb = draw[:, 0], draw[:, 1]
    neg_arr = np.sum(normed[na] * normed[nb], axis=1)

    all_scores = np.concatenate([pos_arr, neg_arr])
    all_labels = np.concatenate([np.ones(len(pos_arr)), np.zeros(len(neg_arr))])
    order = np.argsort(-all_scores)
    sorted_labels = all_labels[order]
    tp = np.cumsum(sorted_labels)
    fp = np.cumsum(1 - sorted_labels)
    tpr = tp / max(tp[-1], 1)
    fpr = fp / max(fp[-1], 1)
    trap = np.trapezoid if hasattr(np, "trapezoid") else np.trapz
    auc = float(trap(tpr, fpr))

    # rank of each positive among negatives: 1 + #(neg >= pos)
    neg_sorted = np.sort(neg_arr)
    ranks = (
        len(neg_arr)
        - np.searchsorted(neg_sorted, pos_arr, side="left")
        + 1
    ).astype(np.float64)
    mrr = float(np.mean(1.0 / ranks))

    return {
        "auc": auc,
        "mrr": mrr,
        "hits@1": float(np.mean(ranks <= 1)),
        "hits@3": float(np.mean(ranks <= 3)),
        "hits@10": float(np.mean(ranks <= 10)),
        "hits@50": float(np.mean(ranks <= 50)),
        "average_precision": float(np.mean(pos_arr > np.median(neg_arr))),
        "num_positive": len(pos_arr),
        "num_negative": len(neg_arr),
        "mean_positive_score": float(np.mean(pos_arr)),
        "mean_negative_score": float(np.mean(neg_arr)),
    }


def node_classification_scores(
    graph,
    embeddings: np.ndarray,
    labels: Dict[str, int],
    train_ratio: float = 0.8,
    seed: int = 42,
) -> Dict[str, float]:
    """Class-centroid cosine classifier, rng(seed) permutation split
    (reference metrics.py:88-176)."""
    index_map = {eid: i for i, eid in enumerate(graph.entity_ids)}
    idx, y = [], []
    for eid, label in labels.items():
        i = index_map.get(eid)
        if i is not None:
            idx.append(i)
            y.append(label)
    if len(idx) < 4:
        raise ValueError(f"Need at least 4 labeled entities, got {len(idx)}")

    X = embeddings[idx]
    y = np.array(y)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(y))
    split = int(len(y) * train_ratio)
    train_idx, test_idx = perm[:split], perm[split:]
    if len(test_idx) == 0:
        raise ValueError("Test set is empty, reduce train_ratio")

    X_train, y_train = X[train_idx], y[train_idx]
    X_test, y_test = X[test_idx], y[test_idx]

    classes = np.unique(y_train)
    centroids = np.stack([X_train[y_train == c].mean(axis=0) for c in classes])
    c_norms = np.linalg.norm(centroids, axis=1)
    # reference skips zero-norm centroids entirely
    keep = c_norms >= 1e-10
    sims = _row_normalize(X_test) @ (centroids[keep] / c_norms[keep, None]).T
    if sims.shape[1] == 0:
        y_pred = np.full(len(X_test), classes[0])
    else:
        y_pred = classes[keep][np.argmax(sims, axis=1)]
        # reference default when nothing beats -2.0 can't happen with cosine

    accuracy = float(np.mean(y_pred == y_test))
    per_class_f1, weights = [], []
    for c in np.unique(y):
        tp = np.sum((y_pred == c) & (y_test == c))
        fp = np.sum((y_pred == c) & (y_test != c))
        fn = np.sum((y_pred != c) & (y_test == c))
        precision = tp / max(tp + fp, 1)
        recall = tp / max(tp + fn, 1)
        per_class_f1.append(2 * precision * recall / max(precision + recall, 1e-10))
        weights.append(np.sum(y_test == c))

    macro_f1 = float(np.mean(per_class_f1))
    weighted_f1 = float(
        np.dot(per_class_f1, weights) / max(sum(weights), 1)
    )
    return {
        "accuracy": accuracy,
        "macro_f1": macro_f1,
        "weighted_f1": weighted_f1,
        "num_classes": len(classes),
        "train_size": len(train_idx),
        "test_size": len(test_idx),
    }


def clustering_scores(embeddings: np.ndarray, labels: np.ndarray) -> Dict[str, float]:
    """NMI / permutation-matched purity / intra-cluster cosine
    (reference metrics.py:179-247)."""
    n = len(labels)
    if n != embeddings.shape[0]:
        raise ValueError(
            f"embeddings has {embeddings.shape[0]} rows but labels has {n} entries"
        )
    unique_labels = np.unique(labels)
    k = len(unique_labels)
    normed = _row_normalize(embeddings)

    label_map = {l: i for i, l in enumerate(unique_labels)}
    mapped = np.array([label_map[l] for l in labels])

    centroids = np.zeros((k, embeddings.shape[1]))
    for i in range(k):
        mask = mapped == i
        if mask.any():
            centroids[i] = normed[mask].mean(axis=0)
    predicted = np.argmax(normed @ centroids.T, axis=1)

    contingency = np.zeros((k, k), dtype=np.int64)
    np.add.at(contingency, (mapped, predicted), 1)

    if k <= 10:
        from itertools import permutations

        purity = max(
            sum(contingency[i, p[i]] for i in range(k)) / n
            for p in permutations(range(k))
        )
    else:
        purity = float(np.sum(np.max(contingency, axis=1)) / n)

    nmi = _normalized_mutual_info(mapped, predicted, k)

    intra, count = 0.0, 0
    for i in range(k):
        vecs = normed[mapped == i]
        nc = len(vecs)
        if nc > 1:
            intra += (np.sum(vecs @ vecs.T) - nc) / max(nc * (nc - 1), 1)
            count += 1
    return {
        "nmi": nmi,
        "purity": float(purity),
        "avg_intra_cluster_similarity": float(intra / max(count, 1)),
        "num_clusters": k,
    }


def _ranked_retrieval(graph, embeddings, test_edges, k):
    """Shared top-k retrieval over test queries, masking existing edges
    (vectorized via the CSR row — reference scans a pair set per candidate)."""
    index_map = {eid: i for i, eid in enumerate(graph.entity_ids)}
    normed = _row_normalize(embeddings)
    rows, cols, _, n, _ = graph.to_sparse_csr()
    from scipy.sparse import csr_matrix

    adj = csr_matrix(
        (np.ones(len(rows), np.int8),
         (rows.astype(np.int64), cols.astype(np.int64))),
        shape=(n, n),
    )

    queries: Dict[int, set] = {}
    for a, b in test_edges:
        ia, ib = index_map.get(a), index_map.get(b)
        if ia is not None and ib is not None:
            queries.setdefault(ia, set()).add(ib)

    for src, true_targets in queries.items():
        sims = normed @ normed[src]
        sims[src] = -2.0
        neighbors = adj.indices[adj.indptr[src]:adj.indptr[src + 1]]
        mask = np.array(
            [nb for nb in neighbors if nb not in true_targets], dtype=np.int64
        )
        sims[mask] = -2.0
        yield np.argsort(sims)[::-1][:k], true_targets


def map_at_k(graph, embeddings, test_edges, k: int = 10) -> float:
    """Mean average precision@k (reference metrics.py:250-289)."""
    aps = []
    for top_k, true_targets in _ranked_retrieval(graph, embeddings, test_edges, k):
        hits, ap_sum = 0, 0.0
        for rank, idx in enumerate(top_k):
            if idx in true_targets:
                hits += 1
                ap_sum += hits / (rank + 1)
        aps.append(ap_sum / min(len(true_targets), k))
    return float(np.mean(aps)) if aps else 0.0


def ndcg_at_k(graph, embeddings, test_edges, k: int = 10) -> float:
    """NDCG@k (reference metrics.py:292-333)."""
    ndcgs = []
    for top_k, true_targets in _ranked_retrieval(graph, embeddings, test_edges, k):
        dcg = sum(
            1.0 / np.log2(rank + 2)
            for rank, idx in enumerate(top_k)
            if idx in true_targets
        )
        ideal = min(len(true_targets), k)
        idcg = sum(1.0 / np.log2(r + 2) for r in range(ideal))
        ndcgs.append(dcg / max(idcg, 1e-10))
    return float(np.mean(ndcgs)) if ndcgs else 0.0


def adjusted_rand_index(labels_true: np.ndarray, labels_pred: np.ndarray) -> float:
    """ARI from the pair-counting contingency table (reference metrics.py:336-359)."""
    n = len(labels_true)
    ct, inv_t = np.unique(labels_true, return_inverse=True)
    cp, inv_p = np.unique(labels_pred, return_inverse=True)
    contingency = np.zeros((len(ct), len(cp)), dtype=np.int64)
    np.add.at(contingency, (inv_t, inv_p), 1)

    def comb2(x):
        x = np.asarray(x, dtype=np.int64)
        return int(np.sum(x * (x - 1) // 2))

    sum_c = comb2(contingency.ravel())
    sum_a = comb2(contingency.sum(axis=1))
    sum_b = comb2(contingency.sum(axis=0))
    total = n * (n - 1) // 2
    expected = sum_a * sum_b / max(total, 1)
    denom = (sum_a + sum_b) / 2 - expected
    if abs(denom) < 1e-10:
        return 0.0
    return float((sum_c - expected) / denom)


def silhouette_score(embeddings: np.ndarray, labels: np.ndarray) -> float:
    """Cosine-distance silhouette (reference metrics.py:362-404)."""
    n = len(labels)
    if n < 2:
        return 0.0
    unique_labels = np.unique(labels)
    if len(unique_labels) < 2:
        return 0.0

    normed = _row_normalize(embeddings)
    dist = 1.0 - normed @ normed.T
    labels = np.asarray(labels)

    masks = {l: labels == l for l in unique_labels}
    sums = {l: dist[:, m].sum(axis=1) for l, m in masks.items()}
    counts = {l: int(m.sum()) for l, m in masks.items()}

    sil = np.zeros(n)
    for i in range(n):
        own = labels[i]
        own_count = counts[own] - 1
        if own_count <= 0:
            continue
        a_i = sums[own][i] / own_count
        b_i = min(
            sums[l][i] / counts[l]
            for l in unique_labels
            if l != own and counts[l] > 0
        )
        sil[i] = (b_i - a_i) / max(a_i, b_i, 1e-10)
    return float(np.mean(sil))


def cross_validate(
    graph,
    embeddings: np.ndarray,
    labels: Dict[str, int],
    k_folds: int = 5,
    eval_fn: Optional[Callable] = None,
    seed: int = 42,
) -> Dict[str, float]:
    """k-fold CV over the centroid classifier (reference metrics.py:407-466)."""
    index_map = {eid: i for i, eid in enumerate(graph.entity_ids)}
    valid = [(eid, label) for eid, label in labels.items() if eid in index_map]
    if k_folds < 2:
        raise ValueError(f"k_folds must be >= 2, got {k_folds}")
    if len(valid) < k_folds:
        raise ValueError(
            f"Not enough labeled entities ({len(valid)}) for {k_folds}-fold CV"
        )

    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(valid))
    fold_size = len(valid) // k_folds
    accs, f1s = [], []
    for fold in range(k_folds):
        start = fold * fold_size
        end = start + fold_size if fold < k_folds - 1 else len(valid)
        test_set = set(perm[start:end].tolist())
        train_labels, test_labels = {}, {}
        for i, (eid, label) in enumerate(valid):
            (test_labels if i in test_set else train_labels)[eid] = label
        fn = eval_fn or _simple_classify
        scores = fn(graph, embeddings, train_labels, test_labels)
        accs.append(scores.get("accuracy", 0.0))
        f1s.append(scores.get("macro_f1", 0.0))

    return {
        "mean_accuracy": float(np.mean(accs)),
        "std_accuracy": float(np.std(accs)),
        "mean_macro_f1": float(np.mean(f1s)),
        "std_macro_f1": float(np.std(f1s)),
        "fold_accuracies": accs,
        "k_folds": k_folds,
    }


def _simple_classify(graph, embeddings, train_labels, test_labels):
    """Centroid classifier on explicit train/test label dicts
    (reference metrics.py:469-516)."""
    index_map = {eid: i for i, eid in enumerate(graph.entity_ids)}
    classes = sorted(set(train_labels.values()))
    cents, cent_classes = [], []
    for c in classes:
        vecs = [
            embeddings[index_map[eid]]
            for eid, label in train_labels.items()
            if label == c and eid in index_map
        ]
        if vecs:
            cents.append(np.mean(vecs, axis=0))
            cent_classes.append(c)
    if not cents:
        # no train entity resolved to a graph row: fall back to predicting
        # classes[0], like the reference's empty-centroids branch
        # (reference metrics.py:461-501) — np.linalg.norm on the empty
        # (0,)-shaped array would raise AxisError instead
        cents_n = np.zeros((0, embeddings.shape[1]))
        kept_classes = []
    else:
        cents = np.asarray(cents)
        cn = np.linalg.norm(cents, axis=1)
        keep = cn >= 1e-10
        cents_n = cents[keep] / cn[keep, None]
        kept_classes = [c for c, k in zip(cent_classes, keep) if k]

    y_true, y_pred = [], []
    for eid, true_label in test_labels.items():
        i = index_map.get(eid)
        if i is None:
            continue
        v = embeddings[i]
        nv = np.linalg.norm(v)
        if nv < 1e-10:
            continue
        if len(kept_classes):
            sims = cents_n @ (v / nv)
            pred = kept_classes[int(np.argmax(sims))]
        else:
            pred = classes[0]
        y_true.append(true_label)
        y_pred.append(pred)

    y_true_arr = np.array(y_true)
    y_pred_arr = np.array(y_pred)
    accuracy = float(np.mean(y_true_arr == y_pred_arr)) if len(y_true) else 0.0

    per_class_f1 = []
    for c in sorted(set(y_true + y_pred)):
        tp = np.sum((y_pred_arr == c) & (y_true_arr == c))
        fp = np.sum((y_pred_arr == c) & (y_true_arr != c))
        fn = np.sum((y_pred_arr != c) & (y_true_arr == c))
        precision = tp / max(tp + fp, 1)
        recall = tp / max(tp + fn, 1)
        per_class_f1.append(2 * precision * recall / max(precision + recall, 1e-10))
    return {
        "accuracy": accuracy,
        "macro_f1": float(np.mean(per_class_f1)) if per_class_f1 else 0.0,
    }


def _normalized_mutual_info(a: np.ndarray, b: np.ndarray, k: int) -> float:
    """NMI with arithmetic-mean normalization (reference metrics.py:519-542)."""
    n = len(a)
    contingency = np.zeros((k, k), dtype=np.float64)
    np.add.at(contingency, (a, b), 1)
    row = contingency.sum(axis=1)
    col = contingency.sum(axis=0)

    nz = contingency > 0
    p = contingency[nz] / n
    outer = np.maximum(np.outer(row, col)[nz], 1e-10)
    mi = float(np.sum(p * np.log(n * contingency[nz] / outer)))

    h_a = -np.sum(row / n * np.log(np.maximum(row / n, 1e-10)))
    h_b = -np.sum(col / n * np.log(np.maximum(col / n, 1e-10)))
    denom = (h_a + h_b) / 2
    if denom < 1e-10:
        return 0.0
    return float(mi / denom)
