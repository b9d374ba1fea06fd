"""Hyperparameter search (reference: pycleora/tuning.py).

grid_search sweeps the cartesian product; random_search samples from lists,
(low, high) ranges (int→integers, float→uniform), or constants.  Failures are
captured per-combination, not raised.

A copy of cleora_tpu/tuning.py; its default scorer is the port's
``metrics.node_classification_scores``.
"""

from __future__ import annotations

import time
from itertools import product as iter_product
from typing import Any, Callable, Dict, List, Optional

import numpy as np


def _default_eval(seed):
    from .metrics import node_classification_scores

    return lambda g, emb, lbls: node_classification_scores(g, emb, lbls, seed=seed)


def _try_combo(graph, labels, embed_fn, params, eval_fn, metric, verbose,
               prefix=""):
    t0 = time.time()
    try:
        emb = embed_fn(graph, **params)
        scores = eval_fn(graph, emb, labels)
        score = scores.get(metric, 0.0)
        result = {
            "params": params,
            "scores": scores,
            metric: score,
            "time": time.time() - t0,
        }
        if verbose:
            print(f"  {prefix}{params} -> {metric}={score:.4f} "
                  f"({result['time']:.2f}s)")
        return result, score, emb
    except Exception as e:
        if verbose:
            print(f"  {prefix}{params} -> ERROR: {e}")
        return {"params": params, "error": str(e)}, None, None


def grid_search(
    graph,
    labels: Dict[str, int],
    embed_fn: Callable,
    param_grid: Dict[str, List],
    eval_fn: Optional[Callable] = None,
    metric: str = "accuracy",
    seed: int = 42,
    verbose: bool = False,
) -> Dict:
    """Exhaustive sweep, best-by-metric (reference tuning.py:7-69)."""
    eval_fn = eval_fn or _default_eval(seed)
    keys = list(param_grid.keys())
    combinations = list(iter_product(*param_grid.values()))

    results = []
    best_score, best_params, best_embeddings = -1.0, None, None
    for combo in combinations:
        params = dict(zip(keys, combo))
        result, score, emb = _try_combo(
            graph, labels, embed_fn, params, eval_fn, metric, verbose
        )
        results.append(result)
        if score is not None and score > best_score:
            best_score, best_params, best_embeddings = score, params, emb

    return {
        "best_params": best_params,
        "best_score": best_score,
        "best_embeddings": best_embeddings,
        "all_results": results,
        "num_combinations": len(combinations),
        "metric": metric,
    }


def random_search(
    graph,
    labels: Dict[str, int],
    embed_fn: Callable,
    param_distributions: Dict[str, Any],
    n_iter: int = 20,
    eval_fn: Optional[Callable] = None,
    metric: str = "accuracy",
    seed: int = 42,
    verbose: bool = False,
) -> Dict:
    """Sampled sweep with rng(seed) (reference tuning.py:71-141)."""
    eval_fn = eval_fn or _default_eval(seed)
    rng = np.random.default_rng(seed)

    results = []
    best_score, best_params, best_embeddings = -1.0, None, None
    for i in range(n_iter):
        params = {}
        for key, dist in param_distributions.items():
            if isinstance(dist, list):
                params[key] = dist[int(rng.integers(len(dist)))]
            elif isinstance(dist, tuple) and len(dist) == 2:
                low, high = dist
                if isinstance(low, int) and isinstance(high, int):
                    params[key] = int(rng.integers(low, high + 1))
                else:
                    params[key] = float(rng.uniform(low, high))
            else:
                params[key] = dist
        result, score, emb = _try_combo(
            graph, labels, embed_fn, params, eval_fn, metric, verbose,
            prefix=f"[{i + 1}/{n_iter}] ",
        )
        results.append(result)
        if score is not None and score > best_score:
            best_score, best_params, best_embeddings = score, params, emb

    return {
        "best_params": best_params,
        "best_score": best_score,
        "best_embeddings": best_embeddings,
        "all_results": results,
        "n_iter": n_iter,
        "metric": metric,
    }
