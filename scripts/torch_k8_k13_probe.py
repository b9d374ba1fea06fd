"""K8's record form and K13's lane form against the parent tree's, on the
same card, in one process.

    python scripts/torch_k8_k13_probe.py --parent DIR [--parts k8,k13,shapes]

Needs a CUDA card and nvcc.  ``DIR`` holds the parent tree's
``cleora_tpu_torch`` package (e.g. ``git archive <parent> cleora_tpu_torch
| tar -x -C DIR``).  It is imported under another name, so its kernels
build from its own sources into its own build directory.  Variants of this
tree's kernels with one constant changed are built from copies of their
sources into a temporary directory and bound in turn in place of the
tree's library (``kernels._BOUND``), so every run goes through the port's
own wrappers.  Times are means of 10 calls by CUDA events (5 for K13 and
the PQ batch), in the order parent, this tree, this tree, parent.

* K8 on ``chip_smoke.py`` phase 7's batch (131,072 walks of 80 on the 1 M
  node DeepWalk corpus): the parent's three-array form and this tree's
  record form, and this tree's with blocks of 64, 256 and 512 threads,
  stores of 1 (a store a hop, as the parent), 8 and 32 nodes, and 1 walk
  a thread; the bound in 32-byte sectors at three sectors a moving hop
  (the three arrays) and at two (the record).  Then
  ``ops.walk.device_walks`` over DeepWalk's 16 batches of both trees
  (resident walks, as ``embed_deepwalk``'s device counting takes them),
  and K17 (``walk_uniform_sharded``) at one slice of both trees.
* K13 at phase 9's shape (1,024 queries, 1,958,363 rows, M = 8, C = 256,
  uint8 codes encoded on the card from a random table and codebooks
  drawn from its rows): the parent's and this tree's, and this tree's with
  blocks of 256 threads and with streaming stores; two diagnostics whose
  outputs are wrong by design (the kernel without its score stores, and
  its stores without the sums) and a fill of the scores;
  ``F.embedding_bag`` on the same inputs and the bounds (the scores' bytes,
  and the table reads from shared memory at 128 bytes a cycle an SM).
  Then ``torch.topk`` over the scores of both trees (this tree's rows are
  padded to 32 floats) and ``PQIndex.search_batch`` of the 1,024 queries
  of both trees (host clock, results on the host).
* K13 shapes (``--parts shapes``): both trees at 1, 64, 256, 1,000 and
  1,024 queries of M = 8 and at 1, 64 and 1,024 queries of M = 16, over
  the same rows with random tables and uniform codes, with the tile width
  this tree takes.

Every output but the diagnostics' is checked bitwise the parent's.  Prints
one JSON line a measurement, and the card's name and power limit.
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
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

PARENT = "cleora_tpu_torch_parent"
KDIR = os.path.join(os.path.dirname(HERE), "cleora_tpu_torch", "kernels")
TURNS = (["parent"], ["this"], ["this"], ["parent"])
WALKS = 131_072
QUERIES = 1_024
# (queries, subspaces) of the K13 shapes sweep
SHAPES = ((1, 8), (64, 8), (256, 8), (1_000, 8), (1_024, 8), (1, 16),
          (64, 16), (1_024, 16))
ROWS = 1_958_363
SUBSPACES, CENTROIDS, DIM = 8, 256, 256
SM_CLOCK_HZ = 1.755e9  # the H100 SXM's boost clock the guide's table uses

# (library, variant): the edits of its copy of the source
VARIANTS = {
    ("walk_uniform", "threads 64"): {"walk_uniform.cu": [
        ("constexpr int kThreads = 128;", "constexpr int kThreads = 64;")]},
    ("walk_uniform", "threads 256"): {"walk_uniform.cu": [
        ("constexpr int kThreads = 128;", "constexpr int kThreads = 256;")]},
    ("walk_uniform", "threads 512"): {"walk_uniform.cu": [
        ("constexpr int kThreads = 128;", "constexpr int kThreads = 512;")]},
    ("walk_uniform", "group 1"): {"walk_uniform.cu": [
        ("constexpr int kGroup = 16;", "constexpr int kGroup = 1;")]},
    ("walk_uniform", "group 8"): {"walk_uniform.cu": [
        ("constexpr int kGroup = 16;", "constexpr int kGroup = 8;")]},
    ("walk_uniform", "group 32"): {"walk_uniform.cu": [
        ("constexpr int kGroup = 16;", "constexpr int kGroup = 32;")]},
    ("walk_uniform", "1 walk a thread"): {"walk_uniform.cu": [
        ("constexpr int kWalks = 2;", "constexpr int kWalks = 1;")]},
    ("pq_adc", "threads 256"): {"pq_adc.cu": [
        ("constexpr int kThreads = 512;", "constexpr int kThreads = 256;")]},
    ("pq_adc", "streaming stores"): {"pq_adc.cu": [
        ("scores[(q0 + e) * ld + i] = v[e];",
         "__stcs(scores + (q0 + e) * ld + i, v[e]);")]},
    # diagnostics, wrong by design (no bitwise check): the kernel without
    # its score stores, and its stores without the sums
    ("pq_adc", "diag no stores"): {"pq_adc.cu": [
        ("if (q0 + e < q && i < n)", "if (q0 + e < q && i < n && c < 0)")]},
    ("pq_adc", "diag stores only"): {"pq_adc.cu": [
        ("run_packed<kQt>(acc, base, codes, r0, n, group, lag, off);",
         "for (int k = 0; k < kSteps; ++k)"
         " acc[k] = make_float4((float)r0, (float)k, (float)lag, 1.0f);")]},
}
PART = {"walk_uniform": "k8", "pq_adc": "k13"}


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
        if PART[lib] not in parts:
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


def routed(entry: str, lib, fn):
    """``fn`` with ``kernels._BOUND[entry]`` set to ``lib``'s launch
    function during the call."""
    from cleora_tpu_torch import kernels

    raw = getattr(lib, f"{entry}_launch")
    raw.restype = ctypes.c_int
    raw.argtypes = kernels._ARGTYPES[entry]

    def call():
        saved = kernels._BOUND.get(entry)
        kernels._BOUND[entry] = raw
        try:
            return fn()
        finally:
            if saved is None:
                kernels._BOUND.pop(entry, None)
            else:
                kernels._BOUND[entry] = saved
    return call


def in_turns(runs: dict, reps: int = 10, turns=TURNS) -> dict:
    """Each of ``runs`` timed in the order of ``turns``: a name ``k`` of a
    turn times every run whose name starts with ``k``."""
    import chip_smoke as cs

    ms = {k: [] for k in runs}
    for names in turns:
        for prefix in names:
            for k in runs:
                if k.startswith(prefix):
                    ms[k].append(cs.time_ms(runs[k], reps=reps))
    return ms


def variant_runs(runs: dict, libs: dict, entry: str, base: str) -> None:
    """Adds a run of ``runs[base]`` through each variant of ``entry``."""
    for key, lib in libs.items():
        if key[0] == entry:
            runs[f"{base}, {key[1]}"] = routed(entry, lib, runs[base])


def k8_probe(card: str, libs: dict) -> None:
    import chip_smoke as cs
    import cleora_tpu_torch.algorithms as alg
    from cleora_tpu_torch import kernels
    from cleora_tpu_torch.ops import walk

    pk = importlib.import_module(PARENT + ".kernels")
    pwalk = importlib.import_module(PARENT + ".ops.walk")
    dev = torch.device("cuda")
    g = cs.random_graph(cs.WALK_NODES, cs.WALK_UND_EDGES, seed=7)
    indptr, cols, deg, n = alg._walk_csr(g)
    del g
    nodes = np.nonzero(deg > 0)[0].astype(np.int32)
    starts = torch.from_numpy(np.tile(nodes, cs.WALKS_PER_NODE)[:WALKS]).to(
        dev)
    length = cs.WALK_LENGTH
    t = walk.WalkTables(indptr, cols, deg, n, dev)
    pt = pwalk.WalkTables(indptr, cols, deg, n, dev)
    runs = {"parent": lambda: pk.walk_uniform(pt.indptr, pt.cols, pt.deg,
                                              starts, length, 0, 0, n),
            "this": lambda: kernels.walk_uniform(t.record, t.cols, starts,
                                                 length, 0, 0, n)}
    variant_runs(runs, libs, "walk_uniform", "this")
    ref = runs["parent"]()
    for k, fn in runs.items():
        assert torch.equal(fn(), ref), k
    reads = int((ref[:, :-1] < n).sum())
    moves = int((ref[:, 1:] < n).sum())
    out = 4 * WALKS * length + 4 * WALKS
    print(json.dumps({
        "probe": "K8", "walks": WALKS, "length": length,
        "bound_ms": (32 * (reads + 2 * moves) + out)
        / cs.HBM_BYTES_PER_S * 1e3,
        "record_bound_ms": (32 * (reads + moves) + out)
        / cs.HBM_BYTES_PER_S * 1e3,
        "ms": in_turns(runs), "bitwise_parent": True, "card": card}),
        flush=True)
    del runs

    # DeepWalk's batches through ops.walk.device_walks, left on the card
    def batches(mod, tables):
        def call():
            return [w for w, _ in mod.device_walks(
                tables, nodes, cs.WALKS_PER_NODE, length, 0, batch=WALKS,
                resident=True)]
        return call
    runs = {"parent": batches(pwalk, pt), "this": batches(walk, t)}
    got, want = runs["this"](), runs["parent"]()
    assert len(got) == len(want) and all(
        torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(got[0], ref)
    print(json.dumps({"probe": "device_walks", "batches": len(got),
                      "walks": sum(w.shape[0] for w in got),
                      "ms": in_turns(runs, reps=3), "bitwise_parent": True,
                      "card": card}), flush=True)
    del got, want, runs

    # K17 at one slice: its hop is walk_hop.cuh's, which K8 shares
    mine = [walk.ShardedWalkTables(indptr, cols, deg, n, 0, 1, dev)]
    theirs = [pwalk.ShardedWalkTables(indptr, cols, deg, n, 0, 1, dev)]
    runs = {"parent": lambda: pwalk.walk_uniform_sharded(theirs, starts,
                                                         length, 0, 0),
            "this": lambda: walk.walk_uniform_sharded(mine, starts, length, 0,
                                                      0)}
    for fn in runs.values():
        assert torch.equal(fn(), ref)
    print(json.dumps({"probe": "K17 one slice", "walks": WALKS,
                      "length": length, "ms": in_turns(runs),
                      "bitwise_parent": True, "card": card}), flush=True)
    del mine, theirs, runs, t, pt, ref
    torch.cuda.empty_cache()


def k13_probe(card: str, libs: dict) -> None:
    import torch.nn.functional as F

    import chip_smoke as cs
    import cleora_tpu_torch.compress as compress
    from cleora_tpu_torch import kernels
    from cleora_tpu_torch.ops.pq import device_codes

    pk = importlib.import_module(PARENT + ".kernels")
    pcompress = importlib.import_module(PARENT + ".compress")
    dev = torch.device("cuda")
    rng = np.random.default_rng(9)
    table = rng.standard_normal((ROWS, DIM), dtype=np.float32)
    sub = DIM // SUBSPACES
    codebooks = np.ascontiguousarray(
        table[rng.choice(ROWS, CENTROIDS, replace=False)]
        .reshape(CENTROIDS, SUBSPACES, sub).transpose(1, 0, 2))
    codes = cs.encode_rows(table, codebooks, dev)
    counts = np.bincount(codes.reshape(-1), minlength=CENTROIDS)
    queries = table[rng.choice(ROWS, QUERIES, replace=False)]
    del table
    codes_dev = device_codes(codes, CENTROIDS, dev)
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    cb = codebooks / np.maximum(
        np.linalg.norm(codebooks, axis=2, keepdims=True), 1e-10)
    tables = torch.einsum(
        "qmd,mcd->qmc",
        torch.from_numpy(qn.reshape(QUERIES, SUBSPACES, sub)).to(dev),
        torch.from_numpy(cb.astype(np.float32)).to(dev)).contiguous()
    runs = {"parent": lambda: pk.pq_adc(tables, codes_dev),
            "this": lambda: kernels.pq_adc(tables, codes_dev)}
    variant_runs(runs, libs, "pq_adc", "this")
    ref = runs["parent"]()
    for k, fn in runs.items():
        if "diag" not in k:
            assert torch.equal(fn(), ref), k
    # a fill of the (Q, N) scores (the card's write rate)
    runs["this: fill_ of the scores (diag)"] = lambda: ref.fill_(1.0)
    weight = tables.permute(1, 2, 0).reshape(SUBSPACES * CENTROIDS, QUERIES)
    bags = codes_dev.long() + CENTROIDS * torch.arange(SUBSPACES, device=dev)
    lib_ms = cs.time_ms(lambda: F.embedding_bag(bags, weight, mode="sum"),
                        reps=5)
    del weight, bags
    width = kernels.pq_tile_width(QUERIES, SUBSPACES, CENTROIDS)
    lanes_ms = cs.time_ms(lambda: kernels.pq_lane_tables(tables, width))
    scores_bytes = 4 * QUERIES * ROWS + codes.size + 4 * tables.numel()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    smem_ms = (4 * QUERIES * ROWS * SUBSPACES) / (128 * sms * SM_CLOCK_HZ) \
        * 1e3
    print(json.dumps({
        "probe": "K13", "queries": QUERIES, "rows": ROWS, "m": SUBSPACES,
        "c": CENTROIDS, "code_share_max": float(counts.max() / counts.sum()
                                                * CENTROIDS),
        "bound_ms": scores_bytes / cs.HBM_BYTES_PER_S * 1e3,
        "shared_load_floor_ms": smem_ms, "tile_width": width,
        "lane_tables_ms": lanes_ms,
        "ms": in_turns(runs, reps=5), "library_ms": lib_ms,
        "bitwise_parent": True, "card": card}), flush=True)
    del runs, ref

    # the top-k over the parent's scores, over this tree's whole padded
    # rows (contiguous, -inf past N, as PQIndex.search_batch takes them)
    # and over their (Q, N) view (strided rows, which torch.topk copies)
    views = {"parent": pk.pq_adc(tables, codes_dev),
             "this": kernels.pq_adc_rows(tables, codes_dev)}
    views["this, the (Q, N) view"] = views["this"][:, :ROWS]
    tops = {k: torch.topk(v, 10, dim=1) for k, v in views.items()}
    for k in views:
        assert all(torch.equal(a, b) for a, b in zip(tops[k],
                                                     tops["parent"])), k
    print(json.dumps({
        "probe": "torch.topk over the K13 scores", "queries": QUERIES,
        "rows": ROWS, "strides": {k: list(v.stride())
                                  for k, v in views.items()},
        "ms": in_turns({k: (lambda v=v: torch.topk(v, 10, dim=1))
                        for k, v in views.items()}, reps=5),
        "bitwise_parent": True, "card": card}), flush=True)
    del views, tops
    torch.cuda.empty_cache()

    shape = (ROWS, DIM)
    mine = compress.PQIndex(codes, codebooks, SUBSPACES, sub, shape,
                            device=dev)
    theirs = pcompress.PQIndex(codes, codebooks, SUBSPACES, sub, shape,
                               device=dev)
    got = mine.search_batch(queries, 10, backend="device")
    want = theirs.search_batch(queries, 10, backend="device")
    assert all(np.array_equal(got[k], want[k]) for k in got)
    seconds = {"parent": [], "this": []}
    for names in TURNS:
        for k in names:
            index = theirs if k == "parent" else mine
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                index.search_batch(queries, 10, backend="device")
                seconds[k].append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({"probe": "PQIndex.search_batch", "queries": QUERIES,
                      "rows": ROWS, "ms": seconds, "bitwise_parent": True,
                      "card": card}), flush=True)


def shapes_probe(card: str) -> None:
    """K13 of both trees at other query counts and at M = 16, over the
    corpus's 1,958,363 rows: random tables and uniform uint8 codes."""
    import chip_smoke as cs
    from cleora_tpu_torch import kernels

    pk = importlib.import_module(PARENT + ".kernels")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    for q, m in SHAPES:
        codes = torch.randint(0, CENTROIDS, (ROWS, m), generator=gen,
                              device=dev, dtype=torch.int32).to(torch.uint8)
        tables = torch.randn((q, m, CENTROIDS), generator=gen, device=dev)
        runs = {"parent": lambda: pk.pq_adc(tables, codes),
                "this": lambda: kernels.pq_adc(tables, codes)}
        ref = runs["parent"]()
        assert torch.equal(runs["this"](), ref), (q, m)
        del ref
        reps = 10 if q <= 256 else 5
        print(json.dumps({
            "probe": "K13 shape", "queries": q, "rows": ROWS, "m": m,
            "c": CENTROIDS,
            "tile_width": kernels.pq_tile_width(q, m, CENTROIDS),
            "bound_ms": (4 * q * ROWS + m * ROWS + 4 * q * m * CENTROIDS)
            / cs.HBM_BYTES_PER_S * 1e3,
            "ms": in_turns(runs, reps=reps), "bitwise_parent": True,
            "card": card}), flush=True)
        del runs, codes, tables
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--parts", default="k8,k13,shapes")
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
    for lib in ("walk_uniform", "pq_adc"):
        print(json.dumps({"ptxas": lib, "log": build.build_logs.get(lib, "")
                          .strip().splitlines()[-12:]}), flush=True)
    load_parent(args.parent)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(tmp, parts)
        if "k8" in parts:
            k8_probe(card, libs)
        if "k13" in parts:
            k13_probe(card, libs)
        if "shapes" in parts:
            shapes_probe(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
