"""Node classifiers on embeddings and graph structure, on the card.

Reference semantics: pycleora/classify.py — ``label_propagation``
(F = αSF + (1−α)Y with labelled rows clamped), ``mlp_classify`` (2-layer
MLP, ReLU and softmax, minibatch SGD, L2 regularisation, best-epoch
checkpointing), ``gcn_classify`` (n-layer GCN over Â = D^-½(A+I)D^-½ with
dropout), ``label_propagation_predict``.

Counterpart of cleora_tpu/classify.py with the same functions, signatures,
splits, numpy draw order and returned keys, plus ``device``: ``None`` means
CUDA, ``"cpu"`` runs the plain PyTorch versions, and without a card and
without ``device="cpu"`` a call raises.

- Label propagation runs ``num_iterations`` launches of kernel K14
  (``ops/label_prop.py``) over S = D⁻¹A in CSR, two buffers in turn at a
  stride of whole float4 groups, and takes the argmax on the card.
- The MLP trains with torch autograd and plain SGD on full-float32 matrix
  products (the JAX program pins ``Precision.HIGHEST``); it has no kernel
  of its own.  ``hidden_dim=0`` is the linear probe.
- The GCN's layers are K1 over Â forward and over Âᵀ backward
  (``ops/gcn.py:CsrSpmm``) and, in hidden layers, K15's ReLU with inverted
  dropout.  Its dropout masks come from Philox at counter (epoch, layer,
  element) keyed by ``seed``, not from JAX's stream: they are the same on
  every device, and match the JAX package in distribution only.

Splits and initial weights come from the same ``np.random.default_rng(seed)``
stream as the JAX package's, in the same order, so both packages start from
identical parameters.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ._util import full_float32_matmul, resolve_device
from .ops.gcn import CsrSpmm, ReluDropout
from .ops.label_prop import label_prop_step
from .ops.spmm import CsrMatrix


def _f1_scores(y_pred: np.ndarray, y_test: np.ndarray, num_classes: int):
    per_class = []
    for c in range(num_classes):
        tp = np.sum((y_pred == c) & (y_test == c))
        fp = np.sum((y_pred == c) & (y_test != c))
        fn = np.sum((y_pred != c) & (y_test == c))
        precision = tp / max(tp + fp, 1)
        recall = tp / max(tp + fn, 1)
        per_class.append(2 * precision * recall / max(precision + recall, 1e-10))
    return float(np.mean(per_class))


def _labeled_split(graph, labels: Dict[str, int], train_ratio: float, seed: int):
    """Shared entity lookup + rng(seed) permutation split (reference
    classify.py:75-105)."""
    if not labels:
        raise ValueError("labels must be a non-empty dict")
    if not (0 < train_ratio < 1):
        raise ValueError(f"train_ratio must be between 0 and 1, got {train_ratio}")
    index_map = {eid: i for i, eid in enumerate(graph.entity_ids)}
    indices, y_list = [], []
    for eid, label in labels.items():
        i = index_map.get(eid)
        if i is not None:
            indices.append(i)
            y_list.append(label)
    if len(indices) < 4:
        raise ValueError(f"Need at least 4 labeled entities, got {len(indices)}")

    y = np.array(y_list)
    classes = np.unique(y)
    class_map = {c: i for i, c in enumerate(classes)}
    y_mapped = np.array([class_map[c] for c in y])

    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(y))
    split = int(len(y) * train_ratio)
    train_idx, test_idx = perm[:split], perm[split:]
    if len(test_idx) == 0:
        raise ValueError("Test set is empty, reduce train_ratio")
    return np.array(indices), y_mapped, classes, train_idx, test_idx, rng


def _row_normalized(graph):
    """S = D⁻¹A as host COO ``(rows, cols, vals, n)``, rows sorted (D = row
    sums of the left-Markov CSR), in float64 and then rounded to float32,
    as cleora_tpu/classify.py:68-79 computes it before padding."""
    rows, cols, vals, n, _ = graph.to_sparse_csr()
    rows64 = rows.astype(np.int64)
    deg = np.zeros(n, dtype=np.float64)
    np.add.at(deg, rows64, vals.astype(np.float64))
    svals = (vals.astype(np.float64) / np.maximum(deg, 1e-10)[rows64]).astype(
        np.float32
    )
    return rows64, cols.astype(np.int64), svals, n


def _gcn_adjacency(graph):
    """Â = D^-½(A+I)D^-½ as host COO ``(rows, cols, vals, n)``: self-loops
    appended to the left-Markov CSR, the entries stable-sorted by row, the
    normalisation in float64 and then rounded to float32
    (cleora_tpu/classify.py:386-396)."""
    n = graph.num_entities
    rows, cols, vals, _, _ = graph.to_sparse_csr()
    rows = np.concatenate([rows.astype(np.int64), np.arange(n, dtype=np.int64)])
    cols = np.concatenate([cols.astype(np.int64), np.arange(n, dtype=np.int64)])
    vals = np.concatenate([vals.astype(np.float64), np.ones(n)])
    order = np.argsort(rows, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    deg = np.zeros(n, dtype=np.float64)
    np.add.at(deg, rows, vals)
    dis = 1.0 / np.sqrt(np.maximum(deg, 1e-10))
    nvals = (dis[rows] * vals * dis[cols]).astype(np.float32)
    return rows, cols, nvals, n


def _gcn_operators(graph, device):
    """Â and Âᵀ as CSR on ``device``.  A is left-Markov, so Â is not
    symmetric and the backward needs Âᵀ."""
    rows, cols, vals, n = _gcn_adjacency(graph)
    return (CsrMatrix.from_coo(rows, cols, vals, n, device),
            CsrMatrix.transpose_from_coo(rows, cols, vals, n, device))


def _label_matrix(graph, labels: Dict[str, int]):
    """One-hot float32 Y (n, classes), the labelled rows' mask and the
    sorted classes; labels of unknown entities are left out."""
    index_map = graph._index_map
    classes = sorted(set(labels.values()))
    class_to_idx = {c: i for i, c in enumerate(classes)}
    Y = np.zeros((graph.num_entities, len(classes)), dtype=np.float32)
    labeled = np.zeros(graph.num_entities, dtype=bool)
    for eid, label in labels.items():
        i = index_map.get(eid)
        if i is not None:
            Y[i, class_to_idx[label]] = 1.0
            labeled[i] = True
    return Y, labeled, classes


# label propagation carries Y, F and its two buffers at a stride rounded up
# to this many columns, the columns past the classes zero (they stay zero:
# each column of a step is its own), so that K14 gathers whole float4 rows
LABEL_STRIDE = 4


def _propagate_labels(S: CsrMatrix, Y: torch.Tensor, mask: torch.Tensor,
                      alpha: float, iters: int) -> torch.Tensor:
    """F (n, C) after ``iters`` steps from F = Y, written into two buffers
    of :data:`LABEL_STRIDE`-rounded width in turn (a view of the first C
    columns).  ``1 − α`` is taken in float32, as the JAX program's traced
    ``1 - alpha``."""
    beta = float(np.float32(1) - np.float32(alpha))
    c = Y.shape[1]
    wide = -(-c // LABEL_STRIDE) * LABEL_STRIDE
    if wide != c:
        Y = F.pad(Y, (0, wide - c))
    buffers = [torch.empty_like(Y), torch.empty_like(Y)] if iters else []
    F_ = Y
    for i in range(iters):
        F_ = label_prop_step(S, F_, Y, mask, alpha, beta, out=buffers[i % 2])
    return F_[:, :c]


def label_propagation(
    graph,
    labels: Dict[str, int],
    num_iterations: int = 30,
    alpha: float = 0.5,
    device=None,
) -> Dict[str, int]:
    """F ← αSF + (1−α)Y, labeled rows clamped each step
    (reference classify.py:5-53); each step is one launch of K14."""
    if not labels:
        raise ValueError("labels must be a non-empty dict")
    dev = resolve_device(device)

    rows, cols, svals, n = _row_normalized(graph)
    S = CsrMatrix.from_coo(rows, cols, svals, n, dev)
    Y, labeled, classes = _label_matrix(graph, labels)
    F_ = _propagate_labels(S, torch.from_numpy(Y).to(dev),
                           torch.from_numpy(labeled).to(dev), alpha,
                           num_iterations)
    pred = torch.argmax(F_, dim=1).cpu().numpy()
    return {
        eid: classes[int(pred[i])]
        for i, eid in enumerate(graph.entity_ids)
    }


def _propagation_split(graph, labels: Dict[str, int], train_ratio: float,
                       seed: int):
    """The train and test label dicts of :func:`label_propagation_predict`:
    the known entities in ``labels`` order, split by ``rng(seed)``."""
    index_map = {eid: i for i, eid in enumerate(graph.entity_ids)}
    labeled_entities = [eid for eid in labels if eid in index_map]
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(labeled_entities))
    split = int(len(labeled_entities) * train_ratio)
    train_labels = {labeled_entities[i]: labels[labeled_entities[i]]
                    for i in perm[:split]}
    test_labels = {labeled_entities[i]: labels[labeled_entities[i]]
                   for i in perm[split:]}
    return train_labels, test_labels


def label_propagation_predict(
    graph,
    embeddings: np.ndarray,
    labels: Dict[str, int],
    num_iterations: int = 30,
    alpha: float = 0.5,
    train_ratio: float = 0.8,
    seed: int = 42,
    device=None,
) -> Dict[str, float]:
    """Train/test split wrapper (reference classify.py:195-237)."""
    train_labels, test_labels = _propagation_split(graph, labels, train_ratio,
                                                   seed)
    predictions = label_propagation(graph, train_labels, num_iterations, alpha,
                                    device=device)
    pairs = [
        (predictions.get(eid), t) for eid, t in test_labels.items()
        if predictions.get(eid) is not None
    ]
    correct = sum(p == t for p, t in pairs)
    return {
        "accuracy": correct / max(len(pairs), 1),
        "train_size": len(train_labels),
        "test_size": len(test_labels),
        "total_predictions": len(predictions),
    }


# ------------------------------------------------------------------- MLP
def _he(rng, fan_in: int, fan_out: int) -> np.ndarray:
    return (rng.standard_normal((fan_in, fan_out))
            * np.sqrt(2.0 / fan_in)).astype(np.float32)


def _mlp_init(rng, input_dim: int, hidden_dim: int,
              num_classes: int) -> Dict[str, np.ndarray]:
    """He init from ``rng`` in the JAX package's order: W1, then W2."""
    if hidden_dim == 0:
        # the linear (logistic-regression) probe of BASELINE config 3
        return {"W1": _he(rng, input_dim, num_classes),
                "b1": np.zeros(num_classes, dtype=np.float32)}
    return {"W1": _he(rng, input_dim, hidden_dim),
            "b1": np.zeros(hidden_dim, dtype=np.float32),
            "W2": _he(rng, hidden_dim, num_classes),
            "b2": np.zeros(num_classes, dtype=np.float32)}


def _mlp_logits(params: Dict[str, torch.Tensor],
                xb: torch.Tensor) -> torch.Tensor:
    if "W2" in params:
        h = torch.relu(xb @ params["W1"] + params["b1"])
        return h @ params["W2"] + params["b2"]
    return xb @ params["W1"] + params["b1"]


def _l2_penalty(weights, l2: float) -> torch.Tensor:
    return 0.5 * l2 * sum((w ** 2).sum() for w in weights)


def _sgd_(params: List[torch.Tensor], loss: torch.Tensor, lr: float) -> None:
    """``p ← p − lr·g`` in place for every parameter."""
    grads = torch.autograd.grad(loss, params)
    with torch.no_grad():
        for p, g in zip(params, grads):
            p -= lr * g


def _mlp_sgd_(params: Dict[str, torch.Tensor], xb: torch.Tensor,
              yb: torch.Tensor, lr: float, l2: float) -> None:
    """One SGD step of ``CE + ½·l2·ΣW²`` (the ``W*`` parameters only)."""
    loss = F.cross_entropy(_mlp_logits(params, xb), yb) + _l2_penalty(
        [w for k, w in params.items() if k.startswith("W")], l2)
    _sgd_(list(params.values()), loss, lr)


def _leaf(w: np.ndarray, dev) -> torch.Tensor:
    """A float32 parameter on ``dev`` that autograd differentiates."""
    return torch.from_numpy(np.array(w, dtype=np.float32)).to(
        dev).requires_grad_()


def _to_device(params: Dict[str, np.ndarray], dev) -> Dict[str, torch.Tensor]:
    return {k: _leaf(v, dev) for k, v in params.items()}


def _to_host(params: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


def _mlp_step(params: Dict[str, np.ndarray], Xb: np.ndarray, yb: np.ndarray,
              lr: float, l2: float, device=None) -> Dict[str, np.ndarray]:
    """One training step from host parameters, for holding it against the
    JAX package's ``_mlp_jits()`` step."""
    dev = resolve_device(device)
    p = _to_device(params, dev)
    with full_float32_matmul():
        _mlp_sgd_(p, torch.from_numpy(np.array(Xb, dtype=np.float32)).to(dev),
                  torch.from_numpy(np.array(yb, dtype=np.int64)).to(dev),
                  lr, l2)
    return _to_host(p)


def _mlp_predict(params: Dict[str, torch.Tensor], x: torch.Tensor) -> np.ndarray:
    with torch.no_grad():
        return torch.argmax(_mlp_logits(params, x), dim=1).cpu().numpy()


def _mlp_train(params: Dict[str, np.ndarray], X_train: np.ndarray,
               y_train: np.ndarray, X_test: np.ndarray, y_test: np.ndarray,
               rng, num_epochs: int, learning_rate: float, l2_reg: float,
               dev):
    """Minibatch SGD from ``params``, one ``rng.permutation`` per epoch,
    evaluated every 10th epoch and at the last.  Returns the final and the
    best parameters as device tensors."""
    p = _to_device(params, dev)
    Xtr = torch.from_numpy(np.ascontiguousarray(X_train)).to(dev)
    ytr = torch.from_numpy(np.asarray(y_train, dtype=np.int64)).to(dev)
    Xte = torch.from_numpy(np.ascontiguousarray(X_test)).to(dev)
    batch_size = min(256, len(X_train))
    best_acc, best = 0.0, {k: v.detach().clone() for k, v in p.items()}
    with full_float32_matmul():
        for epoch in range(num_epochs):
            perm = torch.from_numpy(rng.permutation(len(X_train))).to(dev)
            for start in range(0, len(X_train), batch_size):
                b = perm[start:start + batch_size]
                _mlp_sgd_(p, Xtr[b], ytr[b], learning_rate, l2_reg)
            if epoch % 10 == 0 or epoch == num_epochs - 1:
                acc = float(np.mean(_mlp_predict(p, Xte) == y_test))
                if acc > best_acc:
                    best_acc = acc
                    best = {k: v.detach().clone() for k, v in p.items()}
    return p, best


def mlp_classify(
    graph,
    embeddings: np.ndarray,
    labels: Dict[str, int],
    hidden_dim: int = 64,
    learning_rate: float = 0.01,
    num_epochs: int = 200,
    train_ratio: float = 0.8,
    seed: int = 42,
    l2_reg: float = 1e-4,
    device=None,
) -> Dict[str, float]:
    """2-layer MLP probe (reference classify.py:56-192), trained on the
    device with torch autograd; He init + split use the same numpy rng
    stream.  ``hidden_dim=0`` is the linear probe."""
    node_idx, y_mapped, classes, train_idx, test_idx, rng = _labeled_split(
        graph, labels, train_ratio, seed
    )
    dev = resolve_device(device)
    num_classes = len(classes)
    X = embeddings[node_idx].astype(np.float32)
    X_train, y_train = X[train_idx], y_mapped[train_idx]
    X_test, y_test = X[test_idx], y_mapped[test_idx]

    params = _mlp_init(rng, X.shape[1], hidden_dim, num_classes)
    _, best = _mlp_train(params, X_train, y_train, X_test, y_test, rng,
                         num_epochs, learning_rate, l2_reg, dev)
    with full_float32_matmul():
        y_pred = _mlp_predict(best, torch.from_numpy(X_test).to(dev))
    return {
        "accuracy": float(np.mean(y_pred == y_test)),
        "macro_f1": _f1_scores(y_pred, y_test, num_classes),
        "num_classes": num_classes,
        "train_size": len(train_idx),
        "test_size": len(test_idx),
        "num_epochs": num_epochs,
        "hidden_dim": hidden_dim,
    }


# ------------------------------------------------------------------- GCN
def _gcn_forward(params: List[torch.Tensor], X: torch.Tensor, adj,
                 dropout: float, seed: int, epoch: int) -> torch.Tensor:
    """Logits (n, classes): per layer ``H ← Â·H`` (K1; backward K1 over
    Âᵀ), ``Z = H·W``, and in hidden layers K15's ReLU with dropout
    ``dropout`` drawn at (seed, epoch, layer)."""
    a_hat, a_hat_t = adj
    H = X
    for li, W in enumerate(params):
        H = CsrSpmm.apply(H, a_hat, a_hat_t)
        Z = H @ W
        H = ReluDropout.apply(Z, dropout, seed, epoch, li) \
            if li < len(params) - 1 else Z
    return H


def _gcn_sgd_(params: List[torch.Tensor], X: torch.Tensor, adj,
              train_nodes: torch.Tensor, y_train: torch.Tensor, lr: float,
              l2: float, dropout: float, seed: int, epoch: int) -> None:
    """One full-batch SGD step of ``CE(train rows) + ½·l2·ΣW²``."""
    logits = _gcn_forward(params, X, adj, dropout, seed, epoch)
    loss = F.cross_entropy(logits[train_nodes], y_train) + _l2_penalty(
        params, l2)
    _sgd_(params, loss, lr)


def _gcn_infer(params: List[torch.Tensor], X: torch.Tensor,
               adj) -> torch.Tensor:
    """argmax of the forward without dropout, for every node."""
    with torch.no_grad():
        return torch.argmax(_gcn_forward(params, X, adj, 0.0, 0, 0), dim=1)


def _gcn_step(params: List[np.ndarray], X: np.ndarray, adj,
              train_nodes: np.ndarray, y_train: np.ndarray, lr: float,
              l2: float, dropout: float, seed: int,
              epoch: int) -> List[np.ndarray]:
    """One training step from host parameters on ``adj``'s device (adj =
    :func:`_gcn_operators`), for holding it against the JAX package's
    ``_gcn_jits()`` step."""
    dev = adj[0].device
    p = [_leaf(w, dev) for w in params]
    with full_float32_matmul():
        _gcn_sgd_(p, torch.from_numpy(np.array(X, dtype=np.float32)).to(dev),
                  adj, torch.from_numpy(np.array(train_nodes)).to(dev),
                  torch.from_numpy(np.array(y_train, dtype=np.int64)).to(dev),
                  lr, l2, dropout, seed, epoch)
    return [w.detach().cpu().numpy() for w in p]


def _gcn_train(params: List[np.ndarray], X: torch.Tensor, adj,
               train_nodes: np.ndarray, y_train: np.ndarray,
               test_nodes: np.ndarray, y_test: np.ndarray, num_epochs: int,
               learning_rate: float, l2_reg: float, dropout: float,
               seed: int):
    """Full-batch SGD from ``params``, evaluated every 10th epoch and at
    the last.  Returns the best parameters as device tensors."""
    dev = X.device
    p = [_leaf(w, dev) for w in params]
    tr = torch.from_numpy(np.asarray(train_nodes)).to(dev)
    ytr = torch.from_numpy(np.asarray(y_train, dtype=np.int64)).to(dev)
    te = torch.from_numpy(np.asarray(test_nodes)).to(dev)
    best_acc, best = 0.0, [w.detach().clone() for w in p]
    with full_float32_matmul():
        for epoch in range(num_epochs):
            _gcn_sgd_(p, X, adj, tr, ytr, learning_rate, l2_reg,
                      float(dropout), seed, epoch)
            if epoch % 10 == 0 or epoch == num_epochs - 1:
                preds = _gcn_infer(p, X, adj)[te].cpu().numpy()
                acc = float(np.mean(preds == y_test))
                if acc > best_acc:
                    best_acc = acc
                    best = [w.detach().clone() for w in p]
    return best


def gcn_classify(
    graph,
    embeddings: np.ndarray,
    labels: Dict[str, int],
    hidden_dim: int = 64,
    learning_rate: float = 0.01,
    num_epochs: int = 200,
    train_ratio: float = 0.8,
    seed: int = 42,
    l2_reg: float = 1e-4,
    num_layers: int = 2,
    dropout: float = 0.5,
    device=None,
) -> Dict[str, float]:
    """n-layer GCN over Â = D^-1/2 (A+I) D^-1/2 (reference
    classify.py:240-409), trained full-batch on the device: each layer is
    K1 + a full-float32 matmul, hidden layers K15.  Dropout masks are
    Philox draws at (epoch, layer, element) keyed by ``seed``, not the JAX
    package's stream."""
    node_idx, y_mapped, classes, train_idx, test_idx, rng = _labeled_split(
        graph, labels, train_ratio, seed
    )
    dev = resolve_device(device)
    num_classes = len(classes)
    adj = _gcn_operators(graph, dev)
    X = torch.from_numpy(np.ascontiguousarray(embeddings, dtype=np.float32)).to(
        dev)
    dims = [embeddings.shape[1]] + [hidden_dim] * (num_layers - 1) + [num_classes]
    params = [_he(rng, dims[i], dims[i + 1]) for i in range(len(dims) - 1)]

    test_nodes = node_idx[test_idx]
    y_test = y_mapped[test_idx]
    best = _gcn_train(params, X, adj, node_idx[train_idx],
                      y_mapped[train_idx], test_nodes, y_test, num_epochs,
                      learning_rate, l2_reg, dropout, seed)
    with full_float32_matmul():
        y_pred = _gcn_infer(best, X, adj).cpu().numpy()[test_nodes]
    return {
        "accuracy": float(np.mean(y_pred == y_test)),
        "macro_f1": _f1_scores(y_pred, y_test, num_classes),
        "num_classes": num_classes,
        "train_size": len(train_idx),
        "test_size": len(test_idx),
        "num_layers": num_layers,
        "hidden_dim": hidden_dim,
    }
