"""K6 written once from shared tiles and K4 over the raw state, against the
parent tree's, on the same card, in one process.

    python scripts/torch_k4_k6_probe.py --parent DIR [--parts k6,k4,wide,hubs]

Needs a CUDA card and nvcc.  ``DIR`` holds the parent tree's
``cleora_tpu_torch`` package (e.g. ``git archive <parent> cleora_tpu_torch
| tar -x -C DIR``).  It is imported under another name, so its kernels
build from its own sources into its own build directory.  Variants of this
tree's kernels with one constant changed are built from copies of their
sources into a temporary directory and bound in turn in place of the
tree's library (``kernels._BOUND``), so every run goes through the port's
own wrappers.  Times are means of 10 calls by CUDA events (5 at the wide
full-width shape), in the order parent, this tree, this tree, parent.

* ``k6``: K6 at ``chip_smoke.py`` phase 6's dense graph (32,768 nodes):
  the parent's and this tree's, and this tree's with segments of 4,096
  floats a warp, windows of 1,024 floats and blocks of 128 threads; a fill of the (n, n) buffer (``torch.empty((n, n)).zero_()``,
  the card's measured write rate) and the bound (P written once).  deg is
  checked bitwise the parent's, P bitwise the parent's on every row
  without duplicate entries and within 1e-6 elsewhere, vol within rtol
  1e-6.
* ``k4``: K4 at D = 1,028 on phase 4's graph (19,938 rows) and at D = 256
  on phase 5's graph (1,958,363 rows), on the raw state of one propagate
  step (K3's init through K1): the parent's K4 alone on the normalised
  state, the parent's path (a float32 copy, K2 on it, K4) and this tree's
  K4 on the raw state, and this tree's with 4 and 18 slots' worth of
  edges a batch (``kK4Loads``: 1 and 2 edges at D = 1,028, 2 and 8 at
  D = 256), blocks of 128 threads and 2 and 64 slots' worth of edges a
  batch in a hub's slices (``kK4SliceLoads``); at D = 1,028 also the whole attention
  step of both trees (the parent's copy + K2 + K4 + K1 + K2, this tree's
  K4 + K1 + K2).  The weights are checked against the plain version at
  rtol 1e-5, atol 1e-6 (and the parent's at the same tolerance); the
  floor is one gathered row of x an entry.
* ``wide``: K4 at D = 1,028 on phase 5's graph (x of 8 GB): the parent's
  path against this tree's K4, checked against each other at rtol 1e-5,
  atol 1e-6 (the plain version's gather would need 54 GB), beside the
  floor of one gathered row an entry.
* ``hubs``: K4 at D = 256 and 1,028 on ``chip_smoke.py`` phase 5's
  power-law graph (Chung-Lu, rows of up to 333,156 entries): the parent's
  K4 alone, this tree's with the hub rows in slices and a join, and this
  tree's with every row walked by its own team (a hub's early scores kept
  in ``out``), the largest difference from the parent's, and the floor
  of one gathered row an entry.

Prints one JSON line a measurement, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
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
WIDE = 1_028
# the libraries the probe launches (the parent's: all but K3)
USED = ["dense_markov", "edge_attention", "row_normalize", "spmm_csr",
        "hash_init"]
HBM = 3.35e12

# (library, variant): the edits of its copy of the source
VARIANTS = {
    ("dense_markov", "segment 4096"): [
        ("constexpr int64_t kSegment = 2048;",
         "constexpr int64_t kSegment = 4096;")],
    ("dense_markov", "window 1024"): [("constexpr int kGroups = 4;",
                                       "constexpr int kGroups = 8;")],
    ("dense_markov", "threads 128"): [("constexpr int kThreads = 256;",
                                       "constexpr int kThreads = 128;")],
    ("edge_attention", "loads 4"): [("constexpr int kK4Loads = 2;",
                                     "constexpr int kK4Loads = 4;")],
    ("edge_attention", "loads 18"): [("constexpr int kK4Loads = 2;",
                                      "constexpr int kK4Loads = 18;")],
    ("edge_attention", "threads 128"): [("constexpr int kK4Threads = 256;",
                                         "constexpr int kK4Threads = 128;")],
    ("edge_attention", "slice loads 2"): [
        ("constexpr int kK4SliceLoads = 32;",
         "constexpr int kK4SliceLoads = 2;")],
    ("edge_attention", "slice loads 64"): [
        ("constexpr int kK4SliceLoads = 32;",
         "constexpr int kK4SliceLoads = 64;")],
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
    """The variants of the libraries ``parts`` needs, compiled at once;
    returns {(library, variant): CDLL}."""
    from cleora_tpu_torch.kernels import build

    need = {"dense_markov"} if "k6" in parts else set()
    if {"k4", "wide", "hubs"} & set(parts):
        need.add("edge_attention")
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    headers = [f for f in os.listdir(KDIR) if f.endswith(".cuh")]
    procs = {}
    for i, ((lib, name), edits) in enumerate(VARIANTS.items()):
        if lib not in need:
            continue
        d = os.path.join(tmp, f"v{i}")
        os.makedirs(d)
        for h in headers:
            with open(os.path.join(KDIR, h)) as f, \
                    open(os.path.join(d, h), "w") as g:
                g.write(f.read())
        with open(os.path.join(KDIR, f"{lib}.cu")) as f:
            src = f.read()
        for old, new in edits:
            assert old in src, (lib, name)
            src = src.replace(old, new)
        with open(os.path.join(d, f"{lib}.cu"), "w") as f:
            f.write(src)
        so = os.path.join(d, "lib.so")
        procs[(lib, name)] = (subprocess.Popen(
            [build.nvcc(), *flags, os.path.join(d, f"{lib}.cu"), "-o", so],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for key, (proc, so) in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, (key, log)
        libs[key] = ctypes.CDLL(so)
    return libs


def bind(entry: str, lib) -> None:
    """Route the wrapper's launches of ``entry`` to a variant's library
    (None: back to the tree's own)."""
    from cleora_tpu_torch import kernels

    kernels._BOUND.pop(entry, None)
    if lib is None:
        return
    raw = getattr(lib, f"{entry}_launch")
    raw.restype = ctypes.c_int
    raw.argtypes = kernels._ARGTYPES[entry]
    kernels._BOUND[entry] = raw


def in_turns(runs: dict, turns=TURNS, reps: int = 10) -> dict:
    """Each of ``runs`` timed in the order of ``turns`` (lists of names)."""
    import chip_smoke as cs

    ms = {k: [] for k in runs}
    for names in turns:
        for k in names:
            ms[k].append(cs.time_ms(runs[k], reps=reps))
    return ms


def emit(**row) -> None:
    print(json.dumps(row), flush=True)


def k6_probe(card: str, libs: dict) -> None:
    import chip_smoke as cs
    import cleora_tpu_torch.algorithms as alg
    from cleora_tpu_torch import kernels
    from cleora_tpu_torch.ops.spmm import CsrMatrix

    pk = importlib.import_module(PARENT + ".kernels")
    dev = torch.device("cuda")
    g = cs.random_graph(cs.DENSE_NODES, cs.DENSE_UND_EDGES, seed=11,
                        cover=True)
    rows, cols, vals, _ = alg._coo_f32(g)
    n = g.num_entities
    csr = CsrMatrix.from_coo(rows, cols, vals, n, dev)
    keys = csr.plain_index()[0].cpu().numpy() * n + csr.indices.cpu().numpy()
    uniq, counts = np.unique(keys, return_counts=True)
    dup = np.zeros(n, dtype=bool)
    dup[uniq[counts > 1] // n] = True
    args = (csr.indptr, csr.indices, csr.vals)
    runs = {"parent": lambda: pk.dense_markov(*args),
            "this": lambda: kernels.dense_markov(*args)}
    p0, d0, v0 = runs["parent"]()

    def check(tag):
        p1, d1, v1 = kernels.dense_markov(*args)
        torch.cuda.synchronize()
        assert torch.equal(d0, d1), tag
        differ = (p0 != p1).any(dim=1).cpu().numpy()
        assert not (differ & ~dup).any(), (tag, np.flatnonzero(differ & ~dup))
        err = float((p0 - p1).abs().max())
        assert err <= 1e-6, (tag, err)
        torch.testing.assert_close(v1, v0, rtol=1e-6, atol=0.0)
        return err

    err = check("this")
    fill = torch.empty((n, n), dtype=torch.float32, device=dev)
    fill_ms = [cs.time_ms(lambda: fill.zero_()) for _ in range(2)]
    del fill
    nbytes = 8 * (n + 1) + 8 * csr.nnz + 4 * n * n + 4 * n + 8
    emit(probe="K6", n=n, nnz=csr.nnz, dup_rows=int(dup.sum()),
         ms=in_turns(runs), fill_ms=fill_ms, bound_ms=nbytes / HBM * 1e3,
         max_abs_diff_vs_parent=err, card=card)
    for (lib, name), so in libs.items():
        if lib != "dense_markov":
            continue
        bind("dense_markov", so)
        verr = check(name)
        emit(probe="K6 variant", variant=name,
             ms=in_turns({"this": runs["this"]}, turns=(["this"], ["this"])),
             max_abs_diff_vs_parent=verr, card=card)
        bind("dense_markov", None)


def raw_state(g, d: int, dev):
    """The raw state of one propagate step: K3's init at width d through
    K1 (no normalisation)."""
    from cleora_tpu_torch.ops.init import device_init
    from cleora_tpu_torch.ops.spmm import spmm

    csr = g._device_csr("left", dev)
    x0 = device_init(g._device_hashes(dev), d)
    x = spmm(csr, x0)
    del x0
    return csr, x


def k4_shape(label: str, csr, x, card: str, libs: dict, plain: bool,
             step: bool, reps: int = 10, check: bool = True,
             whole: bool = False) -> None:
    from cleora_tpu_torch import kernels
    from cleora_tpu_torch.ops.attention import (
        attention_step,
        edge_attention_weights_plain,
    )
    from cleora_tpu_torch.ops.normalize import l2_normalize

    pk = importlib.import_module(PARENT + ".kernels")
    pattn = importlib.import_module(PARENT + ".ops.attention")
    n, d, nnz = csr.n_rows, x.shape[1], csr.nnz
    a = (csr.indptr, csr.indices, csr.vals)
    xn = pk.row_normalize_(x.to(torch.float32, copy=True), "l2")
    hubs = csr.hub_plan()
    runs = {
        "parent": lambda: pk.edge_attention(*a, xn, 1.0),
        "parent path": lambda: pk.edge_attention(
            *a, pk.row_normalize_(x.to(torch.float32, copy=True), "l2"),
            1.0),
        "this": lambda: kernels.edge_attention(*a, x, 1.0, hubs),
    }
    if whole:  # every row walked by its own team, a hub's early scores in out
        runs["this, a team a row"] = lambda: kernels.edge_attention(
            *a, x, 1.0)
    want = runs["parent"]()
    got = runs["this"]()
    torch.cuda.synchronize()
    if check:  # a hub's weights are sums of 10^5 terms in two orders
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    err_plain = None
    if plain:
        ref = edge_attention_weights_plain(csr, x, 1.0)
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)
        err_plain = float((got - ref).abs().max())
        del ref
    gather = 8 * (n + 1) + nnz * (8 + 4 * d) + 4 * n * d + 4 * nnz
    once = 4 * n * d + 8 * (n + 1) + 8 * nnz + 4 * nnz
    mine = [k for k in runs if k.startswith("this")]
    turns = (["parent path", "parent"], mine, mine[::-1],
             ["parent", "parent path"])
    emit(probe="K4", shape=label, rows=n, nnz=nnz, d=d,
         ms=in_turns(runs, turns=turns, reps=reps),
         bound_ms=once / HBM * 1e3, gather_floor_ms=gather / HBM * 1e3,
         max_abs_err_plain=err_plain,
         max_abs_diff_vs_parent=float((got - want).abs().max()), card=card)
    for (lib, name), so in libs.items():
        if lib != "edge_attention":
            continue
        bind("edge_attention", so)
        v = runs["this"]()
        torch.testing.assert_close(v, got, rtol=1e-5, atol=1e-6)
        emit(probe="K4 variant", shape=label, variant=name,
             ms=in_turns({"this": runs["this"]}, turns=(["this"], ["this"]),
                         reps=reps), card=card)
        bind("edge_attention", None)
    if step:
        state = l2_normalize(x.clone())
        steps = {"parent": lambda: pattn.attention_step(csr, state, 1.0,
                                                        "l2"),
                 "this": lambda: attention_step(csr, state, 1.0, "l2")}
        torch.testing.assert_close(steps["this"](), steps["parent"](),
                                   rtol=1e-5, atol=1e-6)
        kernels.reset_launches()
        steps["this"]()
        launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
        emit(probe="attention step", shape=label, d=d,
             ms=in_turns(steps, reps=reps), launches=launches, card=card)


def k4_probe(card: str, libs: dict) -> None:
    import chip_smoke as cs

    dev = torch.device("cuda")
    wide = cs.random_graph(cs.PARITY_NODES, cs.PARITY_EDGES, seed=3)
    csr, x = raw_state(wide, WIDE, dev)
    k4_shape(f"D={WIDE}, phase 4's graph", csr, x, card, libs, True, True)
    del wide, csr, x
    g = cs.random_graph(cs.FULL_NODES, cs.FULL_UND_EDGES, seed=7)
    csr, x = raw_state(g, cs.DIM, dev)
    k4_shape(f"D={cs.DIM}, phase 5's graph", csr, x, card, libs, True,
             False)
    del g, csr, x
    torch.cuda.empty_cache()


def wide_probe(card: str, libs: dict) -> None:
    import chip_smoke as cs

    dev = torch.device("cuda")
    g = cs.random_graph(cs.FULL_NODES, cs.FULL_UND_EDGES, seed=7)
    csr, x = raw_state(g, WIDE, dev)
    del g
    k4_shape(f"D={WIDE}, phase 5's graph", csr, x, card, libs, False,
             False, reps=5)


def hubs_probe(card: str, libs: dict) -> None:
    import chip_smoke as cs

    dev = torch.device("cuda")
    csr, deg = cs.chung_lu_csr(cs.FULL_NODES, cs.FULL_UND_EDGES, 7, dev)
    for d in (cs.DIM, WIDE):
        gen = torch.Generator(device=dev).manual_seed(7)
        x = torch.randn((csr.n_rows, d), device=dev, generator=gen)
        k4_shape(f"D={d}, phase 5's power-law graph (largest row "
                 f"{int(deg.max())}, {int(csr.hub_plan().split.shape[0])} "
                 "rows cut into slices)", csr, x, card, libs, False, False,
                 reps=5, check=False, whole=True)
        del x
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--parts", default="k6,k4,wide,hubs")
    a = ap.parse_args()
    parts = a.parts.split(",")
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    from cleora_tpu_torch.kernels import build

    build._build_locked(USED)
    for k in ("dense_markov", "edge_attention"):
        for line in build.build_logs.get(k, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"{k}: {line.strip()}")
    load_parent(a.parent)
    pbuild = importlib.import_module(PARENT + ".kernels.build")
    pbuild._build_locked(USED[:-1])
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(tmp, parts)
        if "k6" in parts:
            k6_probe(card, libs)
            torch.cuda.empty_cache()
        if "k4" in parts:
            k4_probe(card, libs)
        if "wide" in parts:
            wide_probe(card, libs)
        if "hubs" in parts:
            hubs_probe(card, libs)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
