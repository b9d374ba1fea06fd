"""Benchmark harness: wall time + host peak memory + classifier scores.

API parity with pycleora/benchmark.py (same entry points and
result-dict keys — the CLI ``benchmark`` subcommand and downstream tables
consume them) but an independent implementation: a context-manager measurer
shared by both harnesses and a spec-driven table builder.

A copy of cleora_tpu/benchmark.py over the port's SparseMatrix, datasets
and metrics.  tracemalloc sees host allocations only; the card's memory is
``torch.cuda.max_memory_allocated()``.
"""

from __future__ import annotations

import contextlib
import time
import tracemalloc
from typing import Callable, Dict, List, Optional

import numpy as np


@contextlib.contextmanager
def _measured(out: Dict):
    """Measure wall seconds + tracemalloc peak MB of the with-block into
    ``out`` (keys: seconds, peak_mb).  Always stops tracemalloc."""
    tracemalloc.start()
    start = time.perf_counter()
    try:
        yield out
    finally:
        out["seconds"] = time.perf_counter() - start
        _, peak = tracemalloc.get_traced_memory()
        tracemalloc.stop()
        out["peak_mb"] = peak / (1024.0 * 1024.0)


def _mean_of_numeric(dicts: List[Dict]) -> Dict:
    """Average numeric values key-wise across score dicts."""
    merged: Dict[str, float] = {}
    if not dicts:
        return merged
    for key in dicts[0]:
        nums = [d[key] for d in dicts if isinstance(d.get(key), (int, float))]
        if nums:
            merged[key] = float(np.mean(nums))
    return merged


def build_graph_for_dataset(ds: Dict):
    """Build a SparseMatrix from a load_dataset() dict, taking the
    zero-string integer-array fast path for _LazyEdgeList edges (the big
    SNAP/OGB sets)."""
    from .sparse import SparseMatrix

    edges = ds["edges"]
    if hasattr(edges, "arrays"):
        try:
            src, dst = edges.arrays()
            return SparseMatrix.from_edge_arrays(src, dst, ds["columns"])
        except ValueError:
            pass  # non-reflexive column spec etc. — fall through
    return SparseMatrix.from_iterator(iter(edges), ds["columns"])


def benchmark_algorithms(
    graph,
    labels: Dict[str, int],
    algorithms: Dict[str, Callable],
    metrics_fn: Optional[Callable] = None,
    num_runs: int = 1,
    seed: int = 42,
) -> Dict:
    """Run each algorithm ``num_runs`` times on ``graph``; report mean/std
    wall time, mean peak host memory, and averaged classifier scores.  An
    algorithm that raises reports {"error": str(e)} instead of numbers."""
    from .metrics import node_classification_scores

    def _score(g, emb):
        if metrics_fn is not None:
            return metrics_fn(g, emb, labels)
        return node_classification_scores(g, emb, labels, seed=seed)

    report: Dict[str, Dict] = {}
    for name, algo in algorithms.items():
        runs: List[Dict] = []
        try:
            for _ in range(num_runs):
                m: Dict = {}
                with _measured(m):
                    emb = algo(graph)
                m["scores"] = _score(graph, emb)
                runs.append(m)
        except Exception as e:
            report[name] = {"error": str(e)}
            continue
        secs = [r["seconds"] for r in runs]
        report[name] = {
            "avg_time": float(np.mean(secs)),
            "std_time": float(np.std(secs)) if len(secs) > 1 else 0.0,
            "avg_memory_mb": float(np.mean([r["peak_mb"] for r in runs])),
            "scores": _mean_of_numeric([r["scores"] for r in runs]),
            "num_runs": num_runs,
        }
    return report


def benchmark_datasets(
    dataset_names: List[str],
    embed_fn: Callable,
    feature_dim: int = 256,
    seed: int = 42,
) -> Dict:
    """Load each dataset, build + embed (timed together), and score with the
    centroid classifier.  Failures report {"error": str(e)}."""
    from .datasets import load_dataset
    from .metrics import node_classification_scores

    report: Dict[str, Dict] = {}
    for name in dataset_names:
        try:
            ds = load_dataset(name)
            t0 = time.perf_counter()
            graph = build_graph_for_dataset(ds)
            emb = embed_fn(graph)
            seconds = time.perf_counter() - t0
            report[name] = {
                "num_nodes": ds["num_nodes"],
                "num_edges": ds["num_edges"],
                "num_classes": ds["num_classes"],
                "time": seconds,
                "scores": node_classification_scores(
                    graph, emb, ds["labels"], seed=seed
                ),
            }
        except Exception as e:
            report[name] = {"error": str(e)}
    return report


def _table(results: Dict, columns: List[tuple]) -> str:
    """Fixed-width table from (title, width, getter) column specs; rows with
    an "error" key render the error message instead."""
    header = " ".join(f"{title:<{w}}" for title, w, _ in columns).rstrip()
    body = [header, "-" * len(header)]
    name_w = columns[0][1]
    for name in sorted(results):
        data = results[name]
        if "error" in data:
            body.append(f"{name:<{name_w}} ERROR: {data['error']}")
        else:
            cells = [f"{name:<{name_w}}"]
            cells += [f"{get(data):<{w}}" for _, w, get in columns[1:]]
            body.append(" ".join(cells).rstrip())
    return "\n".join(body)


def format_benchmark_table(results: Dict, metric: str = "accuracy") -> str:
    """Per-algorithm comparison table."""
    return _table(results, [
        ("Algorithm", 15, None),
        ("Time (s)", 12, lambda d: f"{d.get('avg_time', 0):.4f}"),
        ("Memory (MB)", 14, lambda d: f"{d.get('avg_memory_mb', 0):.2f}"),
        (metric.capitalize(), 12,
         lambda d: f"{d.get('scores', {}).get(metric, 0):.4f}"),
    ])


def format_dataset_table(results: Dict, metric: str = "accuracy") -> str:
    """Per-dataset table."""
    return _table(results, [
        ("Dataset", 20, None),
        ("Nodes", 8, lambda d: d.get("num_nodes", 0)),
        ("Edges", 10, lambda d: d.get("num_edges", 0)),
        ("Time (s)", 12, lambda d: f"{d.get('time', 0):.4f}"),
        (metric.capitalize(), 12,
         lambda d: f"{d.get('scores', {}).get(metric, 0):.4f}"),
    ])
