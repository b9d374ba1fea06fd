"""K19's gather batch and K11's constants, swept on the card.

    python scripts/torch_k19_k11_sweep.py

Needs a CUDA card and nvcc.  Copies of ``kernels/spmm_acc.cu`` and
``kernels/ppmi.cu`` (with ``row_team.cuh``) are built with one constant
changed each, into a temporary directory, and bound in turn in place of
the tree's library (``kernels._BOUND``), so every variant runs through the
port's own wrappers.  Two turns, each variant timed in each (CUDA events,
10 calls):

* K19 at ``kLoads4`` (float4 slot loads in flight a lane) 4, 8 (the
  tree's) and 16 (K1's): shard 0's four rounds of the 4-way plan of
  ``chip_smoke.py``'s full-width graph in their modes, and one shard's
  single round (the ``halo="overlap"`` step), outputs checked bitwise
  equal to the tree's (the batch does not change the order of the adds);
* K11 on phase 7's range 0: ``kWarpEntries`` (entries a warp of the rows
  pass scans) 256, 1,024 (the tree's) and 4,096, outputs checked bitwise;
  and two diagnostics whose outputs are wrong by design, marked so:
  ``gather_l1`` (the values pass gathers its column sums from 1,024
  entries, which the L1 holds: what the L2 gathers cost) and ``atomic32``
  (the column sums by 32-bit atomics: whether the atomics' width sets
  their rate), with ``index_add_`` of the same counts beside.

Prints one JSON line each for K19 and K11, with the card's name and power
limit.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

KDIR = os.path.join(os.path.dirname(HERE), "cleora_tpu_torch", "kernels")
D = 256

K19 = {
    "kLoads4=8 (tree)": [],
    "kLoads4=4": [("constexpr int kLoads4 = 8;",
                   "constexpr int kLoads4 = 4;")],
    "kLoads4=16 (K1's)": [("constexpr int kLoads4 = 8;",
                           "constexpr int kLoads4 = 16;")],
}
K11 = {
    "kWarpEntries=1024 (tree)": [],
    "kWarpEntries=256": [("constexpr int kWarpEntries = 1024;",
                          "constexpr int kWarpEntries = 256;")],
    "kWarpEntries=4096": [("constexpr int kWarpEntries = 1024;",
                           "constexpr int kWarpEntries = 4096;")],
    "gather_l1 (diagnostic)": [("__ldg(col + x)", "__ldg(col + (x & 1023))")],
    "atomic32 (diagnostic)": [
        ("    atomicAdd(col + __ldcs(ctx + i), w);",
         "    atomicAdd(reinterpret_cast<unsigned*>(col) + __ldcs(ctx + i),\n"
         "              (unsigned)w);")],
}


def build_variants(tmp: str) -> dict:
    """Every variant compiled at once; returns {(library, name): CDLL}."""
    from cleora_tpu_torch.kernels import build

    header = open(os.path.join(KDIR, "row_team.cuh")).read()
    procs = {}
    for lib, table in (("spmm_acc", K19), ("ppmi", K11)):
        for i, (name, edits) in enumerate(table.items()):
            d = os.path.join(tmp, f"{lib}{i}")
            os.makedirs(d)
            src = open(os.path.join(KDIR, f"{lib}.cu")).read()
            for old, new in edits:
                assert old in src, (lib, name)
                src = src.replace(old, new)
            open(os.path.join(d, f"{lib}.cu"), "w").write(src)
            open(os.path.join(d, "row_team.cuh"), "w").write(header)
            so = os.path.join(d, "lib.so")
            flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
            procs[lib, name] = (subprocess.Popen(
                [build.nvcc(), *flags, os.path.join(d, f"{lib}.cu"), "-o",
                 so], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), so)
    libs = {}
    for key, (proc, so) in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, (key, log)
        libs[key] = ctypes.CDLL(so)
    return libs


def bind(libs: dict, lib: str, name: str, *entries: str) -> None:
    """Route the wrappers' launches of ``entries`` to a variant."""
    from cleora_tpu_torch import kernels

    for entry in entries:
        raw = getattr(libs[lib, name], f"{entry}_launch")
        raw.restype = ctypes.c_int
        raw.argtypes = kernels._ARGTYPES[entry]
        kernels._BOUND[entry] = raw


def k19_sweep(libs: dict, card: str) -> None:
    import chip_smoke as cs
    from cleora_tpu_torch.ops.halo import halo_pack
    from cleora_tpu_torch.parallel.embed import overlap_round, overlap_views
    from cleora_tpu_torch.parallel.shard import (
        RoundCsr,
        plan_halo,
        plan_overlap,
        shard_graph,
    )

    dev = torch.device("cuda")
    g = cs.random_graph(cs.FULL_NODES, cs.FULL_UND_EDGES, seed=7)
    n, ds = g.num_entities, g.data
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((n, D), device=dev, generator=gen)
    rc0 = RoundCsr.from_edges(np.repeat(np.arange(n, dtype=np.int32),
                                        np.diff(ds.indptr)),
                              ds.indices, ds.left_vals)
    one = overlap_views([rc0], n, dev)
    sharded = shard_graph(g, "left", 4)
    plan = plan_overlap(sharded, halo=plan_halo(sharded))
    rps, M = sharded.rows_per_shard, plan.M
    padded = torch.zeros((sharded.n_rows_padded, D), device=dev)
    padded[:n] = x
    own = padded[:rps]
    tabs = [own] + [halo_pack(padded[((-r) % 4) * rps:((-r) % 4 + 1) * rps],
                              torch.from_numpy(np.ascontiguousarray(
                                  plan.send_idx[(-r) % 4, 0][None])).to(dev)
                              ).view(M, D) for r in range(1, 4)]
    views = overlap_views(plan.rounds[0], rps, dev)
    acc = torch.empty((rps, D), device=dev)
    acc1 = torch.empty((n, D), device=dev)
    res, ref = {}, None
    for _ in range(2):
        for name in K19:
            bind(libs, "spmm_acc", name, "spmm_acc")
            row = res.setdefault(name, {})
            outs = []
            for r in range(4):
                acc.copy_(own)
                outs.append(overlap_round(acc, views, r, tabs[r], own, 0.0,
                                          "l2").clone())
                row.setdefault(f"round {r}", []).append(cs.time_ms(
                    lambda: overlap_round(acc, views, r, tabs[r], own, 0.0,
                                          "l2")))
            outs.append(overlap_round(acc1, one, 0, x, x, 0.0, "l2").clone())
            row.setdefault("one shard", []).append(cs.time_ms(
                lambda: overlap_round(acc1, one, 0, x, x, 0.0, "l2")))
            if ref is None:
                ref = outs
            row["bitwise"] = all(torch.equal(a, b)
                                 for a, b in zip(outs, ref))
    print(json.dumps({"sweep": "K19", "ms": res, "card": card}), flush=True)


def k11_sweep(libs: dict, card: str) -> None:
    import chip_smoke as cs
    import cleora_tpu_torch.algorithms as alg
    from cleora_tpu_torch import kernels
    from cleora_tpu_torch.ops import cooccur

    dev = torch.device("cuda")
    g = cs.random_graph(cs.WALK_NODES, cs.WALK_UND_EDGES, seed=7)
    n = g.num_entities
    passes = alg._cooc_passes(g, cs.WALKS_PER_NODE, cs.WALK_LENGTH,
                              cs.WINDOW)
    batch = alg._WALK_BATCH // 2
    ranges, _ = cooccur.device_pair_counts(
        lambda: alg._device_walks(g, cs.WALKS_PER_NODE, cs.WALK_LENGTH, 0,
                                  batch=batch, resident=True, device=dev),
        n, cs.WINDOW, passes=passes, device=dev)
    col, total = cooccur.range_col_sums(ranges, n, dev)
    cen, ctx, cnt, m0 = ranges[0]
    del ranges
    res, ref = {}, None
    for _ in range(2):
        for name in K11:
            bind(libs, "ppmi", name, "ppmi", "ppmi_colsum")
            row = res.setdefault(name, {})
            got = kernels.ppmi(cen, ctx, cnt, col, total, n)
            c2, t2 = torch.zeros_like(col), torch.zeros_like(total)
            kernels.ppmi_colsum_(ctx, cnt, c2, t2)
            got = (*got, c2.clone())  # the timed calls add into c2 again
            if ref is None:
                ref = got
            row["bitwise"] = all(torch.equal(a, b) for a, b in zip(got, ref))
            row.setdefault("launch", []).append(cs.time_ms(
                cs.k11_launch_only(cen, ctx, cnt, col, total, n)))
            row.setdefault("colsum", []).append(cs.time_ms(
                lambda: kernels.ppmi_colsum_(ctx, cnt, c2, t2)))
    c2, ctx64, cnt64 = torch.zeros_like(col), ctx.long(), cnt.long()
    res["index_add_"] = cs.time_ms(lambda: c2.index_add_(0, ctx64, cnt64))
    print(json.dumps({"sweep": "K11", "entries": m0, "ms": res,
                      "card": card}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_variants(tmp)
        k11_sweep(libs, card)
        k19_sweep(libs, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
