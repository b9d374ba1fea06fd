"""K19's overlap step and K11 against the parent tree's on the same card,
in one process.

    python scripts/torch_k19_k11_probe.py --parent DIR

Needs a CUDA card.  ``DIR`` holds the parent tree's ``cleora_tpu_torch``
package (e.g. ``git archive <parent> cleora_tpu_torch | tar -x -C DIR``).
It is imported under another name, so its kernels build from its own
sources into its own build directory.  In the order parent, this tree,
this tree, parent (10 calls each, by CUDA events), it times:

* one shard's ``halo="overlap"`` step on ``chip_smoke.py``'s full-width
  graph (roadNet-CA's shape, D = 256, l2): the parent's zero fill, K19
  over round 0's compact rows and K2, against this tree's one K19 launch
  over a view of every row with the normalisation fused, beside K1 with
  l2 fused on the same graph, the parent's and this tree's (K1 and K19
  launch one kernel of ``row_team.cuh`` here; all bitwise equal);
* shard 0's rounds of the 4-way plan (``plan_overlap(shard_graph(graph,
  4))``) on the same state, each in its mode: the parent's compact rounds
  (and its zero fill and K2 over the shard) against this tree's first
  round written over every row, middle rounds over their compact rows,
  last round over every row with the normalisation; and the whole step of
  shard 0 (3 K16 packs and 4 rounds, no transfers);
* K11 on every range of ``chip_smoke.py``'s phase 7 counts (the DeepWalk
  corpus: 1 M nodes, 2 walks of 80, window 5): the whole wrapper and the
  launch alone, ``vals`` and ``indptr`` checked bitwise the parent's; and
  K11's column sums (one range) beside ``index_add_`` of the same counts.

Prints one JSON line a measurement, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

PARENT = "cleora_tpu_torch_parent"
D = 256
SHARDS = 4
TURNS = (["parent"], ["this"], ["this"], ["parent"])


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


def kernel_ms(fn, reps: int = 5) -> dict:
    """Device ms a call of ``fn`` by kernel name, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", 0) or getattr(
            e, "cuda_time_total", 0)
        if us:
            out[e.key[:48]] = us / reps / 1e3
    return out


def k19_probe(card: str) -> None:
    import chip_smoke as cs
    from cleora_tpu_torch import kernels
    from cleora_tpu_torch.ops.halo import halo_pack
    from cleora_tpu_torch.ops.spmm import CsrMatrix, spmm
    from cleora_tpu_torch.parallel.embed import overlap_round, overlap_views
    from cleora_tpu_torch.parallel.shard import (
        RoundCsr,
        plan_halo,
        plan_overlap,
        shard_graph,
    )

    pspmm = importlib.import_module(PARENT + ".ops.spmm")
    pnorm = importlib.import_module(PARENT + ".ops.normalize")
    dev = torch.device("cuda")
    g = cs.random_graph(cs.FULL_NODES, cs.FULL_UND_EDGES, seed=7)
    n, ds = g.num_entities, g.data
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((n, D), device=dev, generator=gen)
    x = x / x.norm(dim=1, keepdim=True)

    # ---- one shard: round 0 holds every edge and is the last round
    deg = np.diff(ds.indptr)
    rc0 = RoundCsr.from_edges(np.repeat(np.arange(n, dtype=np.int32), deg),
                              ds.indices, ds.left_vals)
    compact = cs.round_tensors(rc0, dev)
    views = overlap_views([rc0], n, dev)
    csr = CsrMatrix.from_numpy(ds.indptr, ds.indices, ds.left_vals, dev)
    pcsr = pspmm.CsrMatrix.from_numpy(ds.indptr, ds.indices, ds.left_vals,
                                      dev)

    def parent_step():
        acc = torch.zeros((n, D), device=dev)
        pspmm.spmm_acc(acc, *compact, x)
        return pnorm.l2_normalize(acc)

    def this_step():
        acc = torch.empty((n, D), device=dev)
        return overlap_round(acc, views, 0, x, x, 0.0, "l2")

    want = spmm(csr, x, normalization="l2")
    bitwise = (torch.equal(parent_step(), want),
               torch.equal(this_step(), want),
               torch.equal(pspmm.spmm(pcsr, x, normalization="l2"), want))
    assert all(bitwise), bitwise
    kernels.reset_launches()
    this_step()
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    runs = {"parent": parent_step, "this": this_step,
            "parent K1 with l2 fused": lambda: pspmm.spmm(
                pcsr, x, normalization="l2"),
            "this K1 with l2 fused": lambda: spmm(csr, x,
                                                  normalization="l2")}
    ms = in_turns(runs)
    print(json.dumps({
        "probe": "one-shard overlap step", "rows": n, "edges": int(deg.sum()),
        "width": D, "ms": ms, "launches_this_step": launches,
        "bytes_this": cs.round_bytes(rc0, 4, D, "only", n),
        "bytes_parent_k19": cs.round_bytes(rc0, 4, D, "old"),
        "bitwise_k1_fused": True, "card": card}), flush=True)
    del compact, views, csr, pcsr, want

    # ---- shard 0 of the 4-way plan
    sharded = shard_graph(g, "left", SHARDS)
    oplan = plan_overlap(sharded, halo=plan_halo(sharded))
    rps, M = sharded.rows_per_shard, oplan.M
    padded = torch.zeros((sharded.n_rows_padded, D), device=dev)
    padded[:n] = x
    blocks = [padded[k * rps:(k + 1) * rps] for k in range(SHARDS)]
    slab_of = {r: (-r) % SHARDS for r in range(SHARDS)}
    sends = {r: torch.from_numpy(np.ascontiguousarray(
        oplan.send_idx[slab_of[r], 0][None])).to(dev)
        for r in range(1, SHARDS)}
    tabs = [blocks[0]] + [halo_pack(blocks[slab_of[r]], sends[r]).view(M, D)
                          for r in range(1, SHARDS)]
    rounds = oplan.rounds[0]
    compact = [cs.round_tensors(rc, dev) for rc in rounds]
    views = overlap_views(rounds, rps, dev)
    acc_p = torch.zeros((rps, D), device=dev)
    acc_t = torch.empty((rps, D), device=dev)
    last = SHARDS - 1
    for r in range(SHARDS):
        runs = {"parent": lambda r=r: pspmm.spmm_acc(acc_p, *compact[r],
                                                     tabs[r]),
                "this": lambda r=r: overlap_round(acc_t, views, r, tabs[r],
                                                  blocks[0], 0.0, "l2")}
        if r == 0:
            runs["parent zero fill"] = acc_p.zero_
        if r == last:
            runs["parent K2"] = lambda: pnorm.l2_normalize(acc_p)
        mode = ("write, every row" if r == 0 else
                "add, every row, l2" if r == last else "add, compact rows")
        print(json.dumps({
            "probe": "4-way round", "round": r, "mode": mode,
            "rows": int(rounds[r].row_ids.shape[0]),
            "edges": int(rounds[r].cols.shape[0]),
            "ms": in_turns(runs),
            "bytes_this": cs.round_bytes(
                rounds[r], 4, D, "first" if r == 0 else
                "last" if r == last else "middle", rps),
            "bytes_parent": cs.round_bytes(rounds[r], 4, D, "old"),
            "card": card}), flush=True)

    def parent_shard_step():
        acc = torch.zeros((rps, D), device=dev)
        for r in range(SHARDS):
            tab = blocks[0] if r == 0 else halo_pack(
                blocks[slab_of[r]], sends[r]).view(M, D)
            pspmm.spmm_acc(acc, *compact[r], tab)
        return pnorm.l2_normalize(acc)

    def this_shard_step():
        acc = torch.empty((rps, D), device=dev)
        for r in range(SHARDS):
            tab = blocks[0] if r == 0 else halo_pack(
                blocks[slab_of[r]], sends[r]).view(M, D)
            overlap_round(acc, views, r, tab, blocks[0], 0.0, "l2")
        return acc

    a, b = parent_shard_step(), this_shard_step()
    err = float((a - b).abs().max())
    print(json.dumps({
        "probe": "4-way shard 0 step", "ms": in_turns(
            {"parent": parent_shard_step, "this": this_shard_step}),
        "kernels_ms": {"parent": kernel_ms(parent_shard_step),
                       "this": kernel_ms(this_shard_step)},
        "max_abs_diff_parent": err, "bitwise_parent": bool(torch.equal(a, b)),
        "card": card}), flush=True)
    del blocks, padded, tabs, compact, views, acc_p, acc_t, a, b
    torch.cuda.empty_cache()


def k11_probe(card: str) -> None:
    import chip_smoke as cs
    import cleora_tpu_torch.algorithms as alg
    from cleora_tpu_torch import kernels
    from cleora_tpu_torch.ops import cooccur

    pk = importlib.import_module(PARENT + ".kernels")
    dev = torch.device("cuda")
    g = cs.random_graph(cs.WALK_NODES, cs.WALK_UND_EDGES, seed=7)
    n = g.num_entities
    passes = alg._cooc_passes(g, cs.WALKS_PER_NODE, cs.WALK_LENGTH,
                              cs.WINDOW)
    batch = alg._WALK_BATCH // 2

    def batches_fn():
        return alg._device_walks(g, cs.WALKS_PER_NODE, cs.WALK_LENGTH, 0,
                                 batch=batch, resident=True, device=dev)

    ranges, m_total = cooccur.device_pair_counts(
        batches_fn, n, cs.WINDOW, passes=passes, device=dev)
    col, total = cooccur.range_col_sums(ranges, n, dev)
    for i, (cen, ctx, cnt, m) in enumerate(ranges):
        p_vals, p_indptr = pk.ppmi(cen, ctx, cnt, col, total, n)
        vals, indptr = kernels.ppmi(cen, ctx, cnt, col, total, n)
        assert torch.equal(vals, p_vals) and torch.equal(indptr, p_indptr), i
        del p_vals, p_indptr, vals, indptr
    cen, ctx, cnt, m0 = ranges[0]
    vals = torch.empty((m0,), dtype=torch.float32, device=dev)
    indptr = torch.empty((n + 1,), dtype=torch.int64, device=dev)
    p_launch = pk._bound("ppmi")
    ptrs = (cen.data_ptr(), ctx.data_ptr(), cnt.data_ptr(), m0, n,
            col.data_ptr(), total.data_ptr(), vals.data_ptr(),
            indptr.data_ptr())
    runs = {"parent wrapper": lambda: pk.ppmi(cen, ctx, cnt, col, total, n),
            "this wrapper": lambda: kernels.ppmi(cen, ctx, cnt, col, total,
                                                 n),
            "parent launch": lambda: p_launch(
                *ptrs, torch.cuda.current_stream().cuda_stream),
            "this launch (with its scratch zeroed)": cs.k11_launch_only(
                cen, ctx, cnt, col, total, n)}
    bytes_ppmi = 16 * m0 + 8 * n + 8 + 8 * (n + 1)
    print(json.dumps({
        "probe": "K11", "range": 0, "entries": m0, "ms": in_turns(runs),
        "kernels_ms": kernel_ms(runs["this launch (with its scratch "
                                     "zeroed)"]),
        "bound_ms": bytes_ppmi / cs.HBM_BYTES_PER_S * 1e3,
        "two_pass_floor_ms": (24 * m0 + 16 * n + 8)
        / cs.HBM_BYTES_PER_S * 1e3, "card": card}), flush=True)

    def every_range(mod):
        return lambda: [mod.ppmi(c, x, w, col, total, n)
                        for c, x, w, _ in ranges]

    print(json.dumps({
        "probe": "K11 every range", "ranges": len(ranges),
        "entries": int(m_total),
        "ms": in_turns({"parent": every_range(pk),
                        "this": every_range(kernels)}),
        "card": card}), flush=True)
    col2 = torch.zeros_like(col)
    tot2 = torch.zeros_like(total)
    ctx64, cnt64 = ctx.long(), cnt.long()
    ms = in_turns({"this colsum": lambda: kernels.ppmi_colsum_(ctx, cnt, col2,
                                                               tot2),
                   "index_add_": lambda: col2.index_add_(0, ctx64, cnt64)},
                  (["this", "index_add_"], ["index_add_", "this"]))
    print(json.dumps({
        "probe": "K11 colsum", "range": 0, "entries": m0, "ms": ms,
        "bound_ms": (8 * m0 + 8 * n) / cs.HBM_BYTES_PER_S * 1e3,
        "card": card}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
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
    build.build()
    load_parent(args.parent)
    k19_probe(card)
    k11_probe(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
