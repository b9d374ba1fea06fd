"""Capacity planner: one host-side report of how a workload maps onto
cards before anything runs (the port of cleora_tpu/plan.py).

It reads the port's own fit formulas — the embed loop's estimate
(``ops/memory.py:estimate_embed_bytes``), the walk-table placement
(``algorithms._walk_table_mode``), the dense and blocked gates of NetMF
and GraRep (``algorithms._dense_fits``, ``_auto_block_rows``) and the
counting pass size (``algorithms._COOC_PASS_PAIRS``) — so a "fits" here
is exactly "the check at dispatch will not fire" for the same budget:

    from cleora_tpu_torch.plan import plan_report, format_plan
    print(format_plan(plan_report(graph, feature_dim=256, n_devices=8)))

or ``python -m cleora_tpu_torch plan -i edges.tsv --dim 256 --devices 8
--walks``.  The port keeps the graph as CSR in its original row order
(kernel K1), so the JAX package's sliced-ELL slot budget has no
counterpart and the layout line reads "CSR".  The budget per card is
``hbm_gib`` when given, else the live card's total memory, else the 80 GiB
of an H100.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

_GIB = 1 << 30
H100_BYTES = 80 << 30  # an H100 SXM's device memory


def _graph_degrees(graph) -> np.ndarray:
    """Out-degrees from anything with the CSR (SparseMatrix, DiskGraph,
    raw GraphData)."""
    data = getattr(graph, "data", graph)
    return np.diff(np.asarray(data.indptr)).astype(np.int64)


def device_budget(hbm_gib: Optional[float] = None):
    """(bytes per card, source): ``hbm_gib`` ("explicit"), else the live
    card's total memory ("device"), else an H100's ("default-h100")."""
    if hbm_gib is not None:
        return int(hbm_gib * _GIB), "explicit"
    if torch.cuda.is_available():
        return int(torch.cuda.mem_get_info()[1]), "device"
    return H100_BYTES, "default-h100"


def plan_report(
    graph,
    feature_dim: int = 256,
    dtype: str = "float32",
    n_devices: int = 1,
    hbm_gib: Optional[float] = None,
    walks: bool = False,
    num_walks: int = 10,
    walk_length: int = 80,
    window_size: int = 5,
    second_order: bool = False,
) -> dict:
    """The capacity report (a plain dict; :func:`format_plan` renders it).
    ``hbm_gib`` overrides the per-card budget, to plan for a card you are
    not on (:func:`device_budget`)."""
    from .algorithms import (
        _COOC_PASS_PAIRS,
        _auto_block_rows,
        _dense_fits,
        _walk_table_mode,
    )
    from .ops.memory import estimate_embed_bytes

    degrees = _graph_degrees(graph)
    n = int(degrees.shape[0])
    nnz = int(degrees.sum())
    limit, src = device_budget(hbm_gib)

    report: dict = {
        "graph": {
            "n": n, "nnz": nnz,
            "deg_min": int(degrees.min()) if n else 0,
            "deg_max": int(degrees.max()) if n else 0,
            "deg_mean": float(degrees.mean()) if n else 0.0,
        },
        "hbm": {"per_device_gib": limit / _GIB, "source": src},
        "layout": {"choice": "empty" if nnz == 0 else "CSR"},
    }

    # --- the embed loop's fit per group size
    fits_at = None
    embed_rows = []
    for P in sorted({1, max(1, int(n_devices))}):
        rows_p, nnz_p = -(-n // P), -(-nnz // P)
        need = estimate_embed_bytes(rows_p, feature_dim, nnz_p, dtype)
        need_bf16 = estimate_embed_bytes(rows_p, feature_dim, nnz_p,
                                         "bfloat16")
        embed_rows.append({
            "devices": P,
            "rows_per_device": rows_p,
            "nnz_per_device": nnz_p,
            "need_gib": round(need / _GIB, 2),
            "fits": need <= limit,
            "need_bf16_gib": round(need_bf16 / _GIB, 2),
            "fits_bf16": need_bf16 <= limit,
        })
        if need <= limit and fits_at is None:
            fits_at = P
    if fits_at is None:  # the smallest power-of-two group that fits
        P = max(2, 2 * max(1, int(n_devices)))
        while P <= 65536:
            if estimate_embed_bytes(-(-n // P), feature_dim, -(-nnz // P),
                                    dtype) <= limit:
                fits_at = P
                break
            P *= 2
    report["embed"] = embed_rows
    report["embed_min_devices"] = fits_at

    # --- the walk pipeline's placement (DeepWalk/Node2Vec, device backend)
    if walks:
        try:
            table_mode = _walk_table_mode(
                "auto", n, nnz, None, second_order,
                world=max(1, int(n_devices)), limit=limit)
        except ValueError:
            table_mode = "host (tables exceed the group — backend='host')"
        # worst-case (all-unique) windowed pair count; walkable starts
        # approximated by degree > 0 (the walk CSR also drops self-loops,
        # so this overcounts slightly — the safe direction)
        starts = int((degrees > 0).sum()) * num_walks
        w = min(window_size, walk_length - 1)
        per_walk = 2 * (w * walk_length - w * (w + 1) // 2)
        pairs = starts * per_walk
        passes = max(1, -(-pairs // _COOC_PASS_PAIRS))
        r = min(n, min(feature_dim, max(1, n - 1)) + 16)
        fact_need = estimate_embed_bytes(n, max(1, (3 * r) // 2), pairs)
        fact = "device (one card)" if fact_need <= limit else (
            "sharded (auto-engages)" if n_devices > 1
            else "sharded — needs a group (pass mesh=/n_devices=)")
        report["walks"] = {
            "table_mode": table_mode,
            "counting_passes": passes,
            "worst_case_pairs": pairs,
            "factorization": fact,
            "factorization_need_gib": round(fact_need / _GIB, 2),
        }
    else:
        report["walks"] = None

    # --- the sibling algorithms: which path engages at this shape
    r_sib = min(n, min(feature_dim, max(1, n - 1)) + 16)
    sparse_need = estimate_embed_bytes(
        n, max(feature_dim, (3 * r_sib) // 2), nnz)
    if sparse_need <= limit:
        sparse_path = "device (one card)"
    elif n_devices > 1:
        sparse_path = "sharded over the group (mesh=/n_devices=)"
    else:
        sparse_path = "sharded — needs a group (pass mesh=/n_devices=)"
    if _dense_fits(n, limit=limit):
        log_path = "dense device (n x n transition powers, float32 GEMMs)"
    else:
        b = _auto_block_rows(n, r_sib, limit=limit)
        log_path = f"blocked device (O(n*b) memory, block_rows~{b})"
        if n_devices > 1:
            log_path += " with the panels' rows over the group"
    report["algorithms"] = {
        "prone/randne/hope": sparse_path,
        "netmf/grarep": log_path,
        "deepwalk/node2vec": "see walk pipeline" if walks
        else "pass walks=True for the walk-pipeline plan",
    }

    # --- recommendations
    recs = []
    final = embed_rows[-1]
    if not final["fits"] and final["fits_bf16"]:
        recs.append('dtype="bfloat16" fits where float32 does not '
                    f'({final["need_bf16_gib"]} vs {final["need_gib"]} GiB '
                    f'per device at P={final["devices"]})')
    if not final["fits"] and fits_at and fits_at > final["devices"]:
        recs.append(f"shard over >= {fits_at} devices "
                    "(cleora_tpu_torch.parallel.embed_sharded, one rank "
                    "per card)")
    if fits_at is None:
        recs.append("no group size <= 65536 fits this shape at "
                    f"dim {feature_dim}/{dtype} — reduce feature_dim")
    if walks and report["walks"]["factorization"].startswith("sharded"):
        recs.append("co-occurrence factorization exceeds one card — "
                    "pass mesh= so factorization='sharded' auto-engages")
    report["recommendations"] = recs
    return report


def format_plan(report: dict) -> str:
    """Render :func:`plan_report`'s dict as the CLI's text."""
    g, h = report["graph"], report["hbm"]
    lines = [
        f"Graph: {g['n']:,} entities, {g['nnz']:,} edges "
        f"(degree min/mean/max {g['deg_min']}/{g['deg_mean']:.1f}/"
        f"{g['deg_max']})",
        f"Device memory budget: {h['per_device_gib']:.2f} GiB/device "
        f"[{h['source']}]",
        f"SpMM layout: {report['layout']['choice']}",
        "",
        "Canonical embed (40 iters, whitening):",
    ]
    for row in report["embed"]:
        verdict = "fits" if row["fits"] else "DOES NOT FIT"
        lines.append(
            f"  P={row['devices']}: {row['rows_per_device']:,} rows x "
            f"{row['nnz_per_device']:,} edges/device -> "
            f"~{row['need_gib']} GiB f32 ({verdict}; bf16 "
            f"~{row['need_bf16_gib']} GiB, "
            f"{'fits' if row['fits_bf16'] else 'does not fit'})"
        )
    if report["embed_min_devices"]:
        lines.append(
            f"  smallest fitting group: P={report['embed_min_devices']}")
    wk = report["walks"]
    if wk:
        lines += [
            "",
            "Walk pipeline (device backend):",
            f"  walk tables: {wk['table_mode']}",
            f"  counting: {wk['counting_passes']} pass(es), worst-case "
            f"{wk['worst_case_pairs']:,} pairs",
            f"  PPMI factorization: {wk['factorization']} "
            f"(~{wk['factorization_need_gib']} GiB on one card)",
        ]
    algos = report.get("algorithms")
    if algos:
        lines += ["", "Sibling algorithms (backend='device'):"]
        lines += [f"  {name}: {path}" for name, path in algos.items()
                  if not path.startswith("pass walks=True")]
    if report["recommendations"]:
        lines += [""] + [f"Recommendation: {r}"
                         for r in report["recommendations"]]
    return "\n".join(lines)
