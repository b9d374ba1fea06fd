"""K5's banded kernel and K12's record and window form against the parent
tree's, on the same card, in one process.

    python scripts/torch_k5_k12_probe.py --parent DIR [--parts k5,k12,netmf]

Needs a CUDA card and nvcc.  ``DIR`` holds the parent tree's
``cleora_tpu_torch`` package (e.g. ``git archive <parent> cleora_tpu_torch
| tar -x -C DIR``).  It is imported under another name, so its kernels
build from its own sources into its own build directory.  Variants of this
tree's kernels with one constant changed are built from copies of their
sources into a temporary directory and bound in turn in place of the
tree's library (``kernels._BOUND``), so every run goes through the port's
own wrappers.  Times are means of 10 calls by CUDA events, in the order
parent, this tree, this tree, parent.

* K5 at NetMF's blocked panel (200,000 rows, 4,096 columns of x, the walk
  step ``y = A·x; acc += y`` on ``chip_smoke.py`` phase 6's blocked graph
  after three walk steps): the parent's short-row kernel, this tree's
  short-row kernel, and its banded kernel at bands of 8-64 columns, the
  tree's own choice, and the banded kernel without its streaming cache
  operators; beside ``torch.sparse.mm + add_`` and both bounds.  Then x of
  256, 1,024 and 2,048 columns over the same rows (where the band starts
  to pay); x of 4,096 columns over 3,000 to 12,000 rows (x of 49-197 MB,
  about the L2's 50 MB and above) and over phase 6's dense graph (32,768
  rows, the blocked NetMF's panel there and in phase 12 (b)); and the
  Chebyshev step at ``embed()``'s shape (1.96 M rows, D = 256), which
  keeps the short-row kernel, of both trees.  Every output bitwise the
  parent's short-row kernel's.
* K12 on phase 8's batch (131,072 walks of 80, p = 0.5, q = 2, on the 1 M
  node corpus): the parent's and this tree's, and this tree's with blocks
  of 64, 128 and 256 threads, groups of 1, 4
  and 16 stored nodes (1: a store a hop, as the parent) and windows of 8,
  16 and 64 entries; every walk bitwise the parent's; the bound in 32-byte
  sectors.  Then K18 (``walk_p_q_sharded``, walks of 10) at one and
  four slices of both trees, bitwise this tree's K12.
* The blocked NetMF end to end on phase 6's blocked graph
  (``embed_netmf(block_rows=4096, power_iters=1)``, 980 K5 launches): one
  card, and ``n_devices=1`` in a one-rank NCCL group (the sharded path,
  ``parallel/algorithms.py``), of both trees, wall seconds by the host
  clock with the card synchronised: one untimed run of each tree (the
  parent's kernels build at its first call), then one run each a turn.

Prints one JSON line a measurement, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

PARENT = "cleora_tpu_torch_parent"
KDIR = os.path.join(os.path.dirname(HERE), "cleora_tpu_torch", "kernels")
TURNS = (["parent"], ["this"], ["this"], ["parent"])
BANDS = (8, 16, 24, 32, 48, 64)
WIDTHS = (256, 1024, 2048)
ROWS = (3_000, 6_000, 12_000)  # x of 4,096 columns about the L2's size
K18_LENGTH = 10

# (library, variant): the edits of its copy of the source (and header)
VARIANTS = {
    ("spmm_axpy", "no cache hints"): {"spmm_axpy.cu": [
        ("    row_group4<true>(start, end, row, col0,",
         "    row_group4<false>(start, end, row, col0,"),
        ("    row_col<true>(start, end, row, col0,",
         "    row_col<false>(start, end, row, col0,")]},
    ("walk_p_q", "threads 64"): {"walk_p_q.cu": [
        ("constexpr int kThreads = 512;", "constexpr int kThreads = 64;")]},
    ("walk_p_q", "threads 128"): {"walk_p_q.cu": [
        ("constexpr int kThreads = 512;", "constexpr int kThreads = 128;")]},
    ("walk_p_q", "threads 256"): {"walk_p_q.cu": [
        ("constexpr int kThreads = 512;", "constexpr int kThreads = 256;")]},
    ("walk_p_q", "group 1"): {"walk_p_q.cu": [
        ("constexpr int kGroup = 8;", "constexpr int kGroup = 1;")]},
    ("walk_p_q", "group 4"): {"walk_p_q.cu": [
        ("constexpr int kGroup = 8;", "constexpr int kGroup = 4;")]},
    ("walk_p_q", "group 16"): {"walk_p_q.cu": [
        ("constexpr int kGroup = 8;", "constexpr int kGroup = 16;")]},
    ("walk_p_q", "window 8"): {"walk2_hop.cuh": [
        ("constexpr int kWindow = 32;", "constexpr int kWindow = 8;")]},
    ("walk_p_q", "window 16"): {"walk2_hop.cuh": [
        ("constexpr int kWindow = 32;", "constexpr int kWindow = 16;")]},
    ("walk_p_q", "window 64"): {"walk2_hop.cuh": [
        ("constexpr int kWindow = 32;", "constexpr int kWindow = 64;")]},
}


def load_parent(parent_dir: str):
    """The parent tree's package, imported as :data:`PARENT`."""
    init = os.path.join(parent_dir, "cleora_tpu_torch", "__init__.py")
    spec = importlib.util.spec_from_file_location(
        PARENT, init, submodule_search_locations=[os.path.dirname(init)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[PARENT] = pkg
    spec.loader.exec_module(pkg)
    return pkg


def build_variants(tmp: str, parts) -> dict:
    """Every variant of the chosen parts compiled at once; returns
    {(library, name): CDLL}."""
    from cleora_tpu_torch.kernels import build

    headers = [f for f in os.listdir(KDIR) if f.endswith(".cuh")]
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {}
    for i, ((lib, name), edits) in enumerate(VARIANTS.items()):
        if ("k5" if lib == "spmm_axpy" else "k12") not in parts:
            continue
        d = os.path.join(tmp, f"v{i}")
        os.makedirs(d)
        for fname in [f"{lib}.cu", *headers]:
            src = open(os.path.join(KDIR, fname)).read()
            for old, new in edits.get(fname, []):
                assert old in src, (lib, name, old)
                src = src.replace(old, new)
            open(os.path.join(d, fname), "w").write(src)
        so = os.path.join(d, "lib.so")
        procs[lib, name] = (subprocess.Popen(
            [build.nvcc(), *flags, os.path.join(d, f"{lib}.cu"), "-o", so],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for key, (proc, so) in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, (key, log)
        libs[key] = ctypes.CDLL(so)
    return libs


def bound_to(libs: dict, key, entry: str):
    """The launch function ``entry`` of the variant ``key``, bound."""
    from cleora_tpu_torch import kernels

    raw = getattr(libs[key], f"{entry}_launch")
    raw.restype = ctypes.c_int
    raw.argtypes = kernels._ARGTYPES[entry]
    return raw


def routed(entry: str, raw, fn):
    """``fn`` with ``kernels._BOUND[entry]`` set to ``raw`` during the call
    (``raw`` None: the tree's own)."""
    from cleora_tpu_torch import kernels

    def call():
        saved = kernels._BOUND.get(entry)
        if raw is not None:
            kernels._BOUND[entry] = raw
        try:
            return fn()
        finally:
            if saved is None:
                kernels._BOUND.pop(entry, None)
            else:
                kernels._BOUND[entry] = saved
    return call


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


def k5_runs(kernels, pk, csr, x, acc, libs, bands):
    """The runs at one shape, ``name -> call``: each call returns K5's out
    and adds it into ``acc`` in place."""
    args = (csr.indptr, csr.indices, csr.vals, x, 1.0)
    tree_choice = kernels.band_columns
    shapes = {"this short-row": (0, None)}
    for w in bands:
        shapes[f"this band {w}"] = (w, None)
    shapes["this tree"] = (None, None)
    if ("spmm_axpy", "no cache hints") in libs:
        w = tree_choice(x.shape[0], x.shape[1]) or bands[-1]
        shapes[f"this band {w}, no cache hints"] = (
            w, ("spmm_axpy", "no cache hints"))
    runs = {"parent short-row": lambda: pk.spmm_axpy(*args, acc=acc, d=1.0)}
    for name, (w, variant) in shapes.items():
        raw = None if variant is None else bound_to(libs, variant,
                                                    "spmm_axpy_band")

        def call(w=w):
            kernels.band_columns = (tree_choice if w is None
                                    else (lambda r, c, w=w: w))
            try:
                return kernels.spmm_axpy(*args, acc=acc, d=1.0)
            finally:
                kernels.band_columns = tree_choice
        runs[name] = routed("spmm_axpy_band", raw, call)
    return runs


def bitwise_runs(runs: dict, acc: torch.Tensor) -> None:
    """Every run's out and acc (from the same acc) bitwise the parent's."""
    start = acc.clone()
    ref = runs["parent short-row"]()
    ref_acc = acc.clone()
    for name, fn in runs.items():
        acc.copy_(start)
        out = fn()
        assert torch.equal(out, ref) and torch.equal(acc, ref_acc), name
        del out
    acc.copy_(start)


def k5_probe(card: str, libs: dict) -> None:
    import chip_smoke as cs
    import cleora_tpu_torch.algorithms as alg
    from cleora_tpu_torch import kernels

    pk = importlib.import_module(PARENT + ".kernels")
    dev = torch.device("cuda")
    gb = cs.random_graph(cs.BLOCKED_NODES, cs.BLOCKED_UND_EDGES, seed=12,
                         cover=True)
    rows, cols, vals, n = alg._coo_f32(gb)
    csr, _, _ = alg._pt_csr(rows, cols, vals, n, dev)
    del gb, rows, cols, vals
    nnz = int(csr.indices.shape[0])
    b = cs.BLOCK_ROWS
    y = alg._one_hot_block(n, b, 0, dev)
    acc = torch.zeros_like(y)
    for _ in range(3):  # the walk a few steps in, as the panel meets it
        y = kernels.spmm_axpy(csr.indptr, csr.indices, csr.vals, y, 1.0,
                              acc=acc, d=1.0)
    runs = k5_runs(kernels, pk, csr, y, acc, libs, BANDS)
    bitwise_runs(runs, acc)
    ms = in_turns(runs)
    lib_op = cs.sparse_csr(csr)
    acc_l = acc.clone()
    lib_ms = cs.time_ms(lambda: acc_l.add_(torch.sparse.mm(lib_op, y)))
    del lib_op, acc_l
    panel = 4 * n * b
    once = 8 * (n + 1) + 8 * nnz + 4 * panel
    gathered = once - panel + 4 * nnz * b
    print(json.dumps({
        "probe": "K5 panel", "rows": n, "width": b, "nnz": nnz,
        "tree_band": kernels.band_columns(n, b), "ms": ms,
        "library_ms": lib_ms,
        "bound_ms": once / cs.HBM_BYTES_PER_S * 1e3,
        "gather_bound_ms": gathered / cs.HBM_BYTES_PER_S * 1e3,
        "bitwise_parent": True, "card": card}), flush=True)
    del runs, y, acc
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(5)
    for width in WIDTHS:
        x = torch.randn((n, width), device=dev, generator=gen)
        acc = torch.randn((n, width), device=dev, generator=gen)
        runs = k5_runs(kernels, pk, csr, x, acc, {}, (8, 16, 32))
        bitwise_runs(runs, acc)
        print(json.dumps({"probe": "K5 width", "rows": n, "width": width,
                          "tree_band": kernels.band_columns(n, width),
                          "ms": in_turns(runs), "card": card}), flush=True)
        del x, acc, runs
    torch.cuda.empty_cache()

    # x of 4,096 columns about the L2's size and the dense graph's panel
    shapes = [(f"{r} rows", r, 3 * r, 13) for r in ROWS]
    shapes.append(("phase 6's dense graph", cs.DENSE_NODES,
                   cs.DENSE_UND_EDGES, 11))
    for label, nodes, edges, seed in shapes:
        g = cs.random_graph(nodes, edges, seed=seed, cover=True)
        rows, cols, vals, nr = alg._coo_f32(g)
        small, _, _ = alg._pt_csr(rows, cols, vals, nr, dev)
        del g, rows, cols, vals
        if nr >= b:  # the panel a few walk steps in, as NetMF meets it
            x = alg._one_hot_block(nr, b, 0, dev)
            acc = torch.zeros_like(x)
            for _ in range(3):
                x = kernels.spmm_axpy(small.indptr, small.indices,
                                      small.vals, x, 1.0, acc=acc, d=1.0)
        else:
            x = torch.randn((nr, b), device=dev, generator=gen)
            acc = torch.randn((nr, b), device=dev, generator=gen)
        runs = k5_runs(kernels, pk, small, x, acc, {}, (32,))
        bitwise_runs(runs, acc)
        lib_op = cs.sparse_csr(small)
        acc_l = acc.clone()
        lib_ms = cs.time_ms(lambda: acc_l.add_(torch.sparse.mm(lib_op, x)))
        snnz = int(small.indices.shape[0])
        once = 8 * (nr + 1) + 8 * snnz + 16 * nr * b
        print(json.dumps({"probe": "K5 rows", "graph": label, "rows": nr,
                          "width": b, "nnz": snnz, "x_bytes": 4 * nr * b,
                          "tree_band": kernels.band_columns(nr, b),
                          "ms": in_turns(runs), "library_ms": lib_ms,
                          "bound_ms": once / cs.HBM_BYTES_PER_S * 1e3,
                          "card": card}), flush=True)
        del small, x, acc, acc_l, lib_op, runs
    torch.cuda.empty_cache()

    from cleora_tpu_torch.ops.spmm import CsrMatrix

    g = cs.random_graph(cs.FULL_NODES, cs.FULL_UND_EDGES, seed=7)
    rows, cols, vals, nf, _ = g.to_sparse_csr()
    full = CsrMatrix.from_coo(
        rows, cols, alg._sym_normalized_vals(rows, cols, vals, nf), nf, dev)
    del g, rows, cols, vals
    x, z, acc = (torch.randn((nf, cs.DIM), device=dev, generator=gen)
                 for _ in range(3))
    ca, cb, cc, cd = cs.K5_CASES["chebyshev"][:4]
    step = (full.indptr, full.indices, full.vals, x, ca, cb, z, cc)
    runs = {"parent": lambda: pk.spmm_axpy(*step, acc=acc, d=cd),
            "this": lambda: kernels.spmm_axpy(*step, acc=acc, d=cd)}
    assert kernels.band_columns(nf, cs.DIM) == 0
    a0 = acc.clone()
    got = runs["this"]()
    a1 = acc.clone()
    acc.copy_(a0)
    assert torch.equal(runs["parent"](), got) and torch.equal(acc, a1)
    print(json.dumps({"probe": "K5 Chebyshev step", "rows": nf,
                      "width": cs.DIM, "nnz": int(full.indices.shape[0]),
                      "ms": in_turns(runs), "card": card}), flush=True)
    del full, x, z, acc, a0, a1, got, runs
    torch.cuda.empty_cache()


def k12_probe(card: str, libs: dict) -> None:
    import chip_smoke as cs
    import cleora_tpu_torch.algorithms as alg
    from cleora_tpu_torch import kernels
    from cleora_tpu_torch.ops import walk

    pk = importlib.import_module(PARENT + ".kernels")
    pwalk = importlib.import_module(PARENT + ".ops.walk")
    dev = torch.device("cuda")
    g = cs.random_graph(cs.WALK_NODES, cs.WALK_UND_EDGES, seed=7)
    indptr, cols, deg, n, vals, wmax, wsum = alg._walk_csr(g, with_vals=True)
    del g
    starts = torch.from_numpy(np.nonzero(deg > 0)[0][:alg._WALK2_BATCH]
                              .astype(np.int32)).to(dev)
    inv_p = float(np.float32(1.0 / cs.N2V_P))
    inv_q = float(np.float32(1.0 / cs.N2V_Q))
    tries = walk.walk2_tries(cs.N2V_Q)
    t = walk.WalkTables2(indptr, cols, deg, n, vals, wmax, wsum, dev)
    tables = (t.indptr, t.cols, t.vals, t.deg, t.wmax, t.wsum)
    args = (starts, cs.WALK_LENGTH, inv_p, inv_q, tries, 0, 0, n)
    runs = {"parent": lambda: pk.walk_p_q(*tables, *args),
            "this": lambda: kernels.walk_p_q(t.head, t.cols, t.vals, *args)}
    for key in libs:
        if key[0] == "walk_p_q":
            runs[f"this, {key[1]}"] = routed(
                "walk_p_q", bound_to(libs, key, "walk_p_q"), runs["this"])
    ref = runs["parent"]()
    for k, fn in runs.items():
        assert torch.equal(fn(), ref), k
    bound = cs.k12_sector_bytes(ref, t) / cs.HBM_BYTES_PER_S * 1e3
    print(json.dumps({"probe": "K12", "walks": starts.shape[0],
                      "length": cs.WALK_LENGTH, "bound_ms": bound,
                      "ms": in_turns(runs), "bitwise_parent": True,
                      "card": card}), flush=True)
    del runs, ref

    k12 = kernels.walk_p_q(t.head, t.cols, t.vals, starts, K18_LENGTH, inv_p,
                           inv_q, tries, 0, 0, n)
    sargs = (K18_LENGTH, inv_p, inv_q, tries, 0, 0)
    for world in (1, 4):
        mine = [walk.ShardedWalkTables(indptr, cols, deg, n, r, world, dev,
                                       vals, wmax, wsum)
                for r in range(world)]
        theirs = [pwalk.ShardedWalkTables(indptr, cols, deg, n, r, world, dev,
                                          vals, wmax, wsum)
                  for r in range(world)]
        runs = {"parent": lambda: pwalk.walk_p_q_sharded(theirs, starts,
                                                         *sargs),
                "this": lambda: walk.walk_p_q_sharded(mine, starts, *sargs)}
        for fn in runs.values():
            assert torch.equal(fn(), k12)
        print(json.dumps({"probe": "K18", "slices": world,
                          "walks": starts.shape[0], "length": K18_LENGTH,
                          "ms": in_turns(runs), "card": card}), flush=True)
        del mine, theirs, runs
    torch.cuda.empty_cache()


def netmf_probe(card: str) -> None:
    import time

    import chip_smoke as cs
    import cleora_tpu_torch.algorithms as alg

    palg = importlib.import_module(PARENT + ".algorithms")
    # a graph each: the siblings cache their CSRs on the graph object
    gb, gp = (cs.random_graph(cs.BLOCKED_NODES, cs.BLOCKED_UND_EDGES,
                              seed=12, cover=True) for _ in range(2))
    kw = dict(feature_dim=cs.DIM, backend="device",
              block_rows=cs.BLOCK_ROWS, power_iters=1)

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    for mode, extra in (("one card", {}), ("n_devices=1", {"n_devices": 1})):
        runs = {"parent": lambda: palg.embed_netmf(gp, **kw, **extra),
                "this": lambda: alg.embed_netmf(gb, **kw, **extra)}
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
        print(json.dumps({"probe": "blocked NetMF", "mode": mode,
                          "nodes": gb.num_entities, "seconds": seconds,
                          "gram_err_vs_parent": err, "card": card}),
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--parts", default="k5,k12,netmf")
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
    for lib in ("spmm_axpy", "walk_p_q"):
        print(json.dumps({"ptxas": lib, "log": build.build_logs.get(lib, "")
                          .strip().splitlines()[-12:]}), flush=True)
    load_parent(args.parent)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(tmp, parts)
        if "k5" in parts:
            k5_probe(card, libs)
        if "k12" in parts:
            k12_probe(card, libs)
        if "netmf" in parts:
            netmf_probe(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
