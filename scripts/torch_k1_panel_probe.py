"""K1's band form and K7's band form at the blocked GraRep's panel against
the parent tree's row-major K1 and clone + K7, on the same card, in one
process; then the blocked GraRep end to end of both trees.

    python scripts/torch_k1_panel_probe.py --parent DIR [--parts k1,k7,grarep]
    python scripts/torch_k1_panel_probe.py --parts past

Needs a CUDA card and nvcc.  ``DIR`` holds the parent tree's
``cleora_tpu_torch`` package (e.g. ``git archive <parent> cleora_tpu_torch
| tar -x -C DIR``); the part ``past`` runs this tree alone.  It is imported under another name, so its kernels
build from its own sources into its own build directory.  Times are means
of 10 calls by CUDA events, in the order parent, this tree, this tree,
parent.

* K1 at the blocked GraRep's panel on ``chip_smoke.py`` phase 6's blocked
  graph (200,000 rows, 4,096 columns; the walk state two transition
  powers in, as the walk meets it), and at phase 6's dense graph (32,768
  rows: phase 12 (b)'s panel): the parent's row-major K1, this tree's
  row-major K1 and its band form on the band-major panel (bitwise the
  parent's K1), beside ``torch.sparse.mm`` and both bounds.  Then the L2's
  gather rate, which holds the band form: the band form over x of 32,768
  rows in bands of 32 (a band 4.2 MB, held in the L2) with a CSR of the
  panel's rows and entries drawn over those 32,768 columns, against the
  same bytes of device memory moved by the band form with x's 200,000
  rows.
* K7 at the panel: the parent's copy + K7 in place, this tree's, and K7's
  band form reading the band-major panel (bitwise, its input unchanged).
* The blocked GraRep end to end (``embed_grarep(block_rows=4096,
  max_step=4, power_iters=1)``, 784 K1 launches) on phase 6's blocked
  graph: one card, and ``n_devices=1`` in a one-rank NCCL group (the
  sharded path, ``parallel/algorithms.py``), of both trees, wall seconds by
  the host clock with the card synchronised: one untimed run of each tree
  (the parent's kernels build at its first call), then one run each a
  turn.
* ``past``: both layouts of this tree where a band of x outgrows the L2,
  at the blocked GraRep's own block width (``_block_shape`` with no
  ``block_rows``) on random graphs of phase 5's density with 400,000,
  1,000,000 and 1,965,206 rows (phase 5's graph) and on phase 5's
  power-law graph: row-major K1 against K1's band form, and K7's one band
  (out of place) against its band form, in the order row, bands, bands,
  row, each pair bitwise equal.

Prints one JSON line a measurement, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

PARENT = "cleora_tpu_torch_parent"
TURNS = (["parent"], ["this"], ["this"], ["parent"])
PAST_TURNS = (["row"], ["bands"], ["bands"], ["row"])
PAST_ROWS = (400_000, 1_000_000)
GRAREP_STEPS = 4


def load_parent(parent_dir: str):
    """The parent tree's package, imported as :data:`PARENT`."""
    init = os.path.join(parent_dir, "cleora_tpu_torch", "__init__.py")
    spec = importlib.util.spec_from_file_location(
        PARENT, init, submodule_search_locations=[os.path.dirname(init)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[PARENT] = pkg
    spec.loader.exec_module(pkg)
    return pkg


def in_turns(runs: dict, turns=TURNS) -> dict:
    """Each of ``runs`` timed in the order of ``turns``: a name ``k`` of a
    turn times every run whose name starts with ``k``."""
    import chip_smoke as cs

    ms = {k: [] for k in runs}
    for names in turns:
        for prefix in names:
            for k in runs:
                if k.startswith(prefix):
                    ms[k].append(cs.time_ms(runs[k]))
    return ms


def transition_csr(nodes: int, edges: int, seed: int, dev):
    """The transposed transition CSR of a ``chip_smoke.py`` graph, as the
    blocked GraRep builds it."""
    import chip_smoke as cs
    import cleora_tpu_torch.algorithms as alg

    g = cs.random_graph(nodes, edges, seed=seed, cover=True)
    rows, cols, vals, n = alg._coo_f32(g)
    csr, _, _ = alg._pt_csr(rows, cols, vals, n, dev)
    return csr, n


def walk_state(csr, n: int, b: int, dev):
    """The block-0 walk state two transition powers in, row-major."""
    import cleora_tpu_torch.algorithms as alg
    from cleora_tpu_torch import kernels

    y = alg._one_hot_block(n, b, 0, dev)
    for _ in range(2):
        y = kernels.spmm_csr(csr.indptr, csr.indices, csr.vals, y,
                             hubs=csr.hub_plan())
    return y


def k1_panel(card: str, label: str, csr, n: int, y, pk) -> dict:
    """The three K1 forms and the library call on one panel; returns the
    measurement (and checks every output bitwise the parent's)."""
    import chip_smoke as cs
    from cleora_tpu_torch import kernels
    from cleora_tpu_torch.ops.spmm import to_bands

    g = kernels.BAND_COLUMNS
    b = y.shape[1]
    yb = to_bands(y, g)
    args = (csr.indptr, csr.indices, csr.vals)
    hubs = csr.hub_plan()
    runs = {"parent K1": lambda: pk.spmm_csr(*args, y),
            "this K1": lambda: kernels.spmm_csr(*args, y, hubs=hubs),
            "this bands": lambda: kernels.spmm_csr_bands(*args, yb, 1,
                                                         hubs)}
    ref = runs["parent K1"]()
    assert torch.equal(runs["this K1"](), ref)
    assert torch.equal(runs["this bands"](), to_bands(ref, g))
    del ref
    ms = in_turns(runs)
    lib_op = cs.sparse_csr(csr)
    lib_ms = cs.time_ms(lambda: torch.sparse.mm(lib_op, y))
    del lib_op
    nnz = int(csr.indices.shape[0])
    once = 8 * (n + 1) + 8 * nnz + 8 * n * b
    gathered = once - 4 * n * b + 4 * nnz * b
    out = {"probe": "K1 panel", "graph": label, "rows": n, "width": b,
           "nnz": nnz, "ms": ms, "library_ms": lib_ms,
           "bound_ms": once / cs.HBM_BYTES_PER_S * 1e3,
           "gather_bound_ms": gathered / cs.HBM_BYTES_PER_S * 1e3,
           "l2_gather_gb": nnz * 4 * b / 1e9, "bitwise_parent": True,
           "card": card}
    print(json.dumps(out), flush=True)
    return out


def l2_gather(card: str, n: int, nnz: int, b: int, dev) -> None:
    """The band form with every band of x held in the L2: x of 32,768 rows
    (a band 4.2 MB) under a CSR of ``n`` rows and ``nnz`` entries whose
    columns fall among those rows; the same out, CSR and bands as at the
    panel, so the difference is where the gathers come from."""
    import chip_smoke as cs
    from cleora_tpu_torch import kernels

    g = kernels.BAND_COLUMNS
    x_rows = 32_768
    rng = np.random.default_rng(3)
    deg = np.bincount(rng.integers(0, n, size=nnz), minlength=n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    cols = rng.integers(0, x_rows, size=nnz).astype(np.int32)
    ip, cl = (torch.from_numpy(a).to(dev) for a in (indptr, cols))
    vals = torch.full((nnz,), 0.125, device=dev)
    xb = torch.randn((b // g, x_rows, g), device=dev)
    ms = cs.time_ms(lambda: kernels.spmm_csr_bands(ip, cl, vals, xb))
    moved = 8 * (n + 1) + 8 * nnz + 4 * x_rows * b + 4 * n * b
    print(json.dumps({
        "probe": "K1 bands, x in the L2", "rows": n, "x_rows": x_rows,
        "width": b, "nnz": nnz, "ms": ms,
        "l2_gather_gb": nnz * 4 * b / 1e9,
        "l2_gather_tb_per_s": nnz * 4 * b / (ms * 1e-3) / 1e12,
        "device_bytes_bound_ms": moved / cs.HBM_BYTES_PER_S * 1e3,
        "card": card}), flush=True)


def k1_probe(card: str) -> None:
    import chip_smoke as cs

    pk = importlib.import_module(PARENT + ".kernels")
    dev = torch.device("cuda")
    b = cs.BLOCK_ROWS
    for label, nodes, edges, seed in (
            ("phase 6's blocked graph", cs.BLOCKED_NODES,
             cs.BLOCKED_UND_EDGES, 12),
            ("phase 6's dense graph", cs.DENSE_NODES, cs.DENSE_UND_EDGES,
             11)):
        csr, n = transition_csr(nodes, edges, seed, dev)
        y = walk_state(csr, n, b, dev)
        panel = k1_panel(card, label, csr, n, y, pk)
        if nodes == cs.BLOCKED_NODES:
            l2_gather(card, n, panel["nnz"], b, dev)
        del csr, y
        torch.cuda.empty_cache()


def k7_probe(card: str) -> None:
    import chip_smoke as cs
    import cleora_tpu_torch.algorithms as alg
    from cleora_tpu_torch import kernels
    from cleora_tpu_torch.ops.spmm import to_bands

    pk = importlib.import_module(PARENT + ".kernels")
    dev = torch.device("cuda")
    b = cs.BLOCK_ROWS
    csr, n = transition_csr(cs.BLOCKED_NODES, cs.BLOCKED_UND_EDGES, 12, dev)
    y = walk_state(csr, n, b, dev)
    del csr
    yb = to_bands(y, kernels.BAND_COLUMNS)
    mode = (alg._GRAREP_FLOOR, alg._GRAREP_OFFSET)
    runs = {"parent clone + K7": lambda: pk.log_clip_(y.clone(), None, None,
                                                      *mode),
            "this clone + K7": lambda: kernels.log_clip_(y.clone(), None,
                                                         None, *mode),
            "this K7 in place": lambda: kernels.log_clip_(y, None, None,
                                                          *mode),
            "this bands": lambda: kernels.log_clip_bands(yb, None, None,
                                                         *mode, b)}
    kept = yb.clone()
    want = runs["parent clone + K7"]()
    assert torch.equal(runs["this bands"](), want)
    assert torch.equal(yb, kept)
    del want, kept
    # "this K7 in place" clips y again and again: its values do not matter
    # to its time, and it runs after the bitwise checks
    ms = in_turns(runs)
    once = 8 * n * b
    print(json.dumps({"probe": "K7 panel", "rows": n, "width": b, "ms": ms,
                      "bound_ms": once / cs.HBM_BYTES_PER_S * 1e3,
                      "clone_bound_ms": once / cs.HBM_BYTES_PER_S * 1e3,
                      "bitwise_parent": True, "card": card}), flush=True)
    del y, yb
    torch.cuda.empty_cache()


def grarep_probe(card: str) -> None:
    import chip_smoke as cs
    import cleora_tpu_torch.algorithms as alg

    palg = importlib.import_module(PARENT + ".algorithms")
    # a graph each: the siblings cache their CSRs on the graph object
    gb, gp = (cs.random_graph(cs.BLOCKED_NODES, cs.BLOCKED_UND_EDGES,
                              seed=12, cover=True) for _ in range(2))
    kw = dict(feature_dim=cs.DIM, max_step=GRAREP_STEPS, backend="device",
              block_rows=cs.BLOCK_ROWS, power_iters=1)

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for mode, extra in (("one card", {}), ("n_devices=1", {"n_devices": 1})):
        runs = {"parent": lambda: palg.embed_grarep(gp, **kw, **extra),
                "this": lambda: alg.embed_grarep(gb, **kw, **extra)}
        seconds = {k: [] for k in runs}
        outs = {}
        with (cs.one_rank_nccl_group() if extra else
              contextlib.nullcontext()):
            for k in runs:  # untimed: the builds and the allocator's pools
                wall(runs[k])
            for names in TURNS:
                for k in names:
                    outs[k], sec = wall(runs[k])
                    seconds[k].append(sec)
        err, top = cs.gram_err(outs["this"], outs["parent"],
                               cs.sample_rows(gb.num_entities))
        print(json.dumps({"probe": "blocked GraRep", "mode": mode,
                          "nodes": gb.num_entities, "seconds": seconds,
                          "equal_to_parent": bool(np.array_equal(
                              outs["this"], outs["parent"])),
                          "gram_err_vs_parent": err, "card": card}),
              flush=True)


def layouts(card: str, label: str, csr, n: int, b: int) -> None:
    """Row-major K1 and K7's one band against their band forms on one
    graph's walk state at width ``b``."""
    import chip_smoke as cs
    import cleora_tpu_torch.algorithms as alg
    from cleora_tpu_torch import kernels
    from cleora_tpu_torch.ops.spmm import to_bands

    g = kernels.BAND_COLUMNS
    y = walk_state(csr, n, b, csr.indptr.device)
    yb = to_bands(y, g)
    args = (csr.indptr, csr.indices, csr.vals)
    hubs = csr.hub_plan()
    mode = (alg._GRAREP_FLOOR, alg._GRAREP_OFFSET)
    k1 = {"row": lambda: kernels.spmm_csr(*args, y, hubs=hubs),
          "bands": lambda: kernels.spmm_csr_bands(*args, yb, 1, hubs)}
    assert torch.equal(k1["bands"](), to_bands(k1["row"](), g))
    k1_ms = in_turns(k1, PAST_TURNS)
    k7 = {"row": lambda: kernels.log_clip_bands(y[None], None, None, *mode,
                                                b),
          "bands": lambda: kernels.log_clip_bands(yb, None, None, *mode, b)}
    assert torch.equal(k7["bands"](), k7["row"]())
    k7_ms = in_turns(k7, PAST_TURNS)
    nnz = int(csr.indices.shape[0])
    once = 8 * (n + 1) + 8 * nnz + 8 * n * b
    print(json.dumps({
        "probe": "layouts past the L2", "graph": label, "rows": n,
        "width": b, "nnz": nnz, "band_mb": 4 * n * g / 1e6,
        "k1_ms": k1_ms, "k7_ms": k7_ms,
        "k1_bound_ms": once / cs.HBM_BYTES_PER_S * 1e3,
        "k1_gather_bound_ms": (once - 4 * n * b + 4 * nnz * b)
        / cs.HBM_BYTES_PER_S * 1e3,
        "k7_bound_ms": 8 * n * b / cs.HBM_BYTES_PER_S * 1e3,
        "bitwise": True, "card": card}), flush=True)
    del y, yb


def past_probe(card: str) -> None:
    import chip_smoke as cs
    import cleora_tpu_torch.algorithms as alg

    dev = torch.device("cuda")
    k = cs.DIM // GRAREP_STEPS
    per_node = cs.FULL_UND_EDGES / cs.FULL_NODES
    for nodes in (*PAST_ROWS, cs.FULL_NODES):
        if nodes == cs.FULL_NODES:  # phase 5's graph
            gr = cs.random_graph(nodes, cs.FULL_UND_EDGES, seed=7)
        else:
            gr = cs.random_graph(nodes, round(nodes * per_node), seed=5,
                                 cover=True)
        rows, cols, vals, n = alg._coo_f32(gr)
        del gr
        csr, _, _ = alg._pt_csr(rows, cols, vals, n, dev)
        del rows, cols, vals
        b = alg._block_shape(n, min(n, k + 10), None, dev)
        layouts(card, f"random, {n} rows", csr, n, b)
        del csr
        torch.cuda.empty_cache()
    csr, _ = cs.chung_lu_csr(cs.FULL_NODES, cs.FULL_UND_EDGES, 7, dev)
    n = cs.FULL_NODES
    b = alg._block_shape(n, min(n, k + 10), None, dev)
    layouts(card, "phase 5's power-law graph", csr, n, b)
    del csr
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--parts", default="k1,k7,grarep")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from cleora_tpu_torch.kernels import build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    parts = args.parts.split(",")
    build.build()
    for lib in ("spmm_csr_bands", "log_clip"):
        print(json.dumps({"ptxas": lib, "log": build.build_logs.get(lib, "")
                          .strip().splitlines()[-12:]}), flush=True)
    if set(parts) - {"past"}:
        if not args.parent:
            ap.error("--parent DIR is needed for k1, k7 and grarep")
        load_parent(args.parent)
    if "past" in parts:
        past_probe(card)
    if "k1" in parts:
        k1_probe(card)
    if "k7" in parts:
        k7_probe(card)
    if "grarep" in parts:
        grarep_probe(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
