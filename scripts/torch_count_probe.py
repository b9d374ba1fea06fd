"""What ``chip_smoke.py`` does not time of K10 and K5's long-row path: the
designs they replaced, the band size and the row-length threshold, on one
card.

    python scripts/torch_count_probe.py [--parent DIR] [--bands MB,MB,...]
                                        [--lengths L,L,...] [--profile]

Needs a CUDA card.  Builds the port's kernels, generates ``chip_smoke.py``'s
phase 7 corpus (1,000,000 nodes, 5,500,000 undirected edges, seed 7; 2
walks of 80 a node, window 5, D=256), and prints, with the card's name and
power limit:

* with ``--parent``, where ``DIR`` holds the parent tree's
  ``cleora_tpu_torch/kernels/run_length.cu`` (heads kernel,
  ``torch.cumsum``, reduce kernel): its K10 beside K10's sweep form and
  ``torch.unique_consecutive`` on the first batch's sorted keys,
  partition 0's first and last chain merge by the merge form and by the
  path it replaced (pack, ``torch.sort``, gather, the parent's K10), and
  the count stage (``device_pair_counts``) end to end with its peak device
  memory in both designs, the ranges checked equal;
* with ``--profile``, the device time of one sweep call and of
  ``torch.unique_consecutive`` by ``torch.profiler``;
* the rsvd apply (``ops/dense.py:_apply_pieces``) over the PPMI pieces at
  width 272, by K5's long-row path with x walked in bands of each size in
  ``--bands`` (MB; 0 = one band), and by the short-row path as before (K1
  on piece 0, K5 on every row of the others);
* K5 over a row plan of random rows of each mean length in ``--lengths``
  (about 32 M entries, width 272, x of 1 M rows), by the long-row kernel
  and by the short-row kernel over the same plan: where the dispatch's
  threshold ``kernels.LONG_BAND_ENTRIES`` (entries a row a band of x)
  stands.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402


def events_ms(fn, reps=5, warmup=1):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def parent_k10(parent: str, out_dir: str):
    """The parent tree's K10 (two kernels and a cumsum) as a function of
    (keys, counts, n, passes)."""
    from cleora_tpu_torch.kernels import build

    src = os.path.join(parent, "cleora_tpu_torch", "kernels", "run_length.cu")
    lib = os.path.join(out_dir, "libparent_run_length.so")
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, src, "-o", lib],
                   check=True, capture_output=True)
    so = ctypes.CDLL(lib)
    v = ctypes.c_void_p
    heads_fn = so.run_length_heads_launch
    heads_fn.argtypes = [v, ctypes.c_int64, v, v]
    reduce_fn = so.run_length_launch
    reduce_fn.argtypes = [v, v, v, v, ctypes.c_int64, ctypes.c_int64,
                          ctypes.c_int, v, v, v, v, v]

    def run(keys, counts, n, passes):
        dev = keys.device
        stream = torch.cuda.current_stream(dev).cuda_stream
        length = keys.shape[0]
        heads = torch.empty((length,), dtype=torch.int32, device=dev)
        assert heads_fn(keys.data_ptr(), length, heads.data_ptr(), stream) == 0
        pos = torch.cumsum(heads, 0, dtype=torch.int32)
        m = int(pos[-1]) if length else 0
        cen, ctx, cnt = (torch.empty((m,), dtype=torch.int32, device=dev)
                         for _ in range(3))
        m_per = torch.zeros((passes,), dtype=torch.int32, device=dev)
        assert reduce_fn(keys.data_ptr(),
                         None if counts is None else counts.data_ptr(),
                         heads.data_ptr(), pos.data_ptr(), length, n, passes,
                         cen.data_ptr(), ctx.data_ptr(), cnt.data_ptr(),
                         m_per.data_ptr(), stream) == 0
        return cen, ctx, cnt, m_per
    return run


def _sort_path(a, b, n, reduce):
    """The chain merge before the merge form: pack, torch.sort, gather,
    K10."""
    k = torch.cat([a[0].long() * n + a[1], b[0].long() * n + b[1]])
    k, order = torch.sort(k)
    c = torch.cat([a[2], b[2]])[order]
    del order
    return reduce(k, c, n, 1)


def random_plan_csr(n, rows, mean, seed, dev):
    """A CSR of ``n`` rows of which ``rows`` (random) hold about ``mean``
    ascending random columns each (uniform in [mean/2, 3 mean/2])."""
    from cleora_tpu_torch.ops.spmm import CsrMatrix

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    full = torch.randperm(n, generator=gen, device=dev)[:rows]
    deg = torch.zeros(n, dtype=torch.int64, device=dev)
    deg[full] = torch.randint(max(1, mean // 2), mean + mean // 2 + 1,
                              (rows,), generator=gen, device=dev)
    row_of = torch.repeat_interleave(torch.arange(n, device=dev), deg)
    key = torch.sort(row_of * n + torch.randint(
        0, n, (row_of.shape[0],), generator=gen, device=dev)).values
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    indptr[1:] = torch.cumsum(deg, 0)
    vals = torch.rand(key.shape[0], generator=gen, device=dev)
    return CsrMatrix(indptr, (key % n).to(torch.int32), vals)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--bands", default="24")
    ap.add_argument("--lengths", default="8,16,32,64,128,810")
    ap.add_argument("--profile", action="store_true",
                    help="device time of one sweep call by torch.profiler")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import cleora_tpu_torch.algorithms as alg
    from cleora_tpu_torch import kernels
    from cleora_tpu_torch.kernels import build
    from cleora_tpu_torch.ops import cooccur, dense
    from cleora_tpu_torch.ops.spmm import spmm, spmm_axpy

    build.build()
    card = cs.environment()
    dev = torch.device("cuda")
    r = cs.DIM + 16

    for mean in [int(v) for v in args.lengths.split(",") if v]:
        nx = 1_000_000
        csr = random_plan_csr(nx, min(nx, (32 << 20) // mean), mean, mean,
                              dev)
        plan = csr.row_plan()
        x = torch.randn((nx, r), device=dev)
        acc = torch.zeros_like(x)
        saved = kernels.LONG_BAND_ENTRIES
        row = {"mean_entries": mean, "rows": int(plan.rows.shape[0]),
               "nnz": csr.nnz, "width": r}
        for label, threshold in (("long", 0), ("short", 1 << 62)):
            kernels.LONG_BAND_ENTRIES = threshold
            try:
                row[f"{label}_ms"] = events_ms(
                    lambda: dense.spmm_accumulate_(csr, x, acc), 5, 1)
            finally:
                kernels.LONG_BAND_ENTRIES = saved
        row["gather_floor_ms"] = (4 * r * csr.nnz / cs.HBM_BYTES_PER_S
                                  * 1e3)
        bands = -(-nx // max(1, kernels.BAND_BYTES // (4 * r)))
        row["entries_a_row_a_band"] = csr.nnz / row["rows"] / bands
        print(json.dumps({"card": card, **row}), flush=True)
        del csr, plan, x, acc

    g = cs.random_graph(cs.WALK_NODES, cs.WALK_UND_EDGES, seed=7)
    n = g.num_entities
    passes = alg._cooc_passes(g, cs.WALKS_PER_NODE, cs.WALK_LENGTH,
                              cs.WINDOW)
    batch = alg._WALK_BATCH // 2
    # K8-K10 on the first batch, bitwise against plain (sweep and a merge)
    _, _, walks, keys, runs = cs.walk_kernels_vs_plain(g, dev, passes,
                                                       "probe")
    del walks
    print(json.dumps({
        "card": card, "keys": keys.shape[0], "runs": runs[0].shape[0],
        "passes": passes,
        "sweep_bound_ms": (8 * keys.shape[0] + 12 * runs[0].shape[0])
        / cs.HBM_BYTES_PER_S * 1e3}), flush=True)

    def batches_fn():
        return alg._device_walks(g, cs.WALKS_PER_NODE, cs.WALK_LENGTH, 0,
                                 batch=batch, resident=True, device=dev)

    def count(label):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ranges, m_total = cooccur.device_pair_counts(
            batches_fn, n, cs.WINDOW, passes=passes, device=dev)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        fps = [cs.range_fingerprint(r, n) for r in ranges]
        print(json.dumps({"count": label, "s": s, "peak_gib": peak,
                          "m_total": m_total}), flush=True)
        return ranges, fps

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        for label, fn in (("sweep", lambda: cooccur.run_length(
                keys, n, passes)), ("unique_consecutive", lambda:
                torch.unique_consecutive(keys, return_counts=True))):
            fn()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    fn()
                torch.cuda.synchronize()
            rows = sorted(((e.key, e.self_device_time_total / 5e3)
                           for e in prof.key_averages()
                           if e.self_device_time_total > 0),
                          key=lambda t: -t[1])
            print(json.dumps({"profile": label, "device_ms_per_call": {
                k[:60]: round(v, 4) for k, v in rows[:6]}}), flush=True)

    ranges, fps = count("merge form")
    if args.parent:
        old = parent_k10(args.parent, build.BUILD_DIR)
        want = old(keys, None, n, passes)
        assert all(torch.equal(a, b) for a, b in zip(runs, want))
        print(json.dumps({
            "sweep_ms": events_ms(lambda: cooccur.run_length(keys, n, passes),
                                  10, 2),
            "parent_sweep_ms": events_ms(lambda: old(keys, None, n, passes),
                                         10, 2),
            "unique_consecutive_ms": events_ms(
                lambda: torch.unique_consecutive(keys, return_counts=True),
                10, 2)}), flush=True)
        del ranges
        with cs.captured_merges(cooccur, passes) as captured:
            ranges, _ = count("captured")
        for label, v in captured.items():
            a, b = v[:3], v[3:]
            got = cooccur._merge(a, b, n)
            want = cooccur.merge_plain(a, b, n)
            assert got[3] == want[3] and all(torch.equal(x, y) for x, y in
                                             zip(got[:3], want[:3]))
            print(json.dumps({
                "merge": label, "a": a[0].shape[0], "b": b[0].shape[0],
                "m": got[3],
                "bound_ms": 12 * (a[0].shape[0] + b[0].shape[0] + got[3])
                / cs.HBM_BYTES_PER_S * 1e3,
                "merge_ms": events_ms(lambda: cooccur._merge(a, b, n), 5, 1),
                "parent_sort_path_ms": events_ms(
                    lambda: _sort_path(a, b, n, old), 5, 1)}), flush=True)
        del captured

        def old_merge(a, b, nn):
            cen, ctx, cnt, _ = _sort_path(a, b, nn, old)
            return cen, ctx, cnt, int(cen.shape[0])

        def old_run_length(k, nn, p):
            return old(k, None, nn, p)

        real = cooccur._merge, cooccur.run_length
        del ranges  # as when the merge form counted
        cooccur._merge, cooccur.run_length = old_merge, old_run_length
        try:
            ranges, fps_old = count("parent")
        finally:
            cooccur._merge, cooccur.run_length = real
        assert fps_old == fps
    del keys, runs
    if not args.bands:
        return 0

    # ---- the rsvd apply over the PPMI pieces at width 272
    pieces = cooccur.ppmi_csrs(ranges, n)
    x = torch.randn((n, r), device=dev)
    nnz = sum(p.nnz for p in pieces)
    floor = 4 * r * nnz / cs.HBM_BYTES_PER_S * 1e3
    once = (8 * nnz + 8 * (n + 1) * len(pieces) + 2 * 4 * n * r) \
        / cs.HBM_BYTES_PER_S * 1e3
    print(json.dumps({"apply_entries": nnz, "pieces": len(pieces),
                      "bound_ms": once, "gather_floor_ms": floor}),
          flush=True)

    def old_apply():  # without a row plan K5 takes its short-row kernel
        y = spmm(pieces[0], x)
        for p in pieces[1:]:
            spmm_axpy(p, x, 1.0, acc=y, d=1.0)
        return y

    y_old = old_apply()
    res = {"apply_short_rows_ms": events_ms(old_apply, 3, 1)}
    for mb in [int(v) for v in args.bands.split(",")]:
        kernels.BAND_BYTES = (mb << 20) if mb else (1 << 62)
        y = dense._apply_pieces(pieces, x)
        res[f"apply_band_{mb}MB_err"] = float((y - y_old).abs().max())
        res[f"apply_band_{mb}MB_ms"] = events_ms(
            lambda: dense._apply_pieces(pieces, x), 3, 1)
        piece = pieces[1]
        acc = torch.zeros_like(x)
        res[f"k5_piece_band_{mb}MB_ms"] = events_ms(
            lambda: dense.spmm_accumulate_(piece, x, acc), 5, 1)
        print(json.dumps(res), flush=True)
    plan = pieces[1].row_plan()
    print(json.dumps({"piece_rows": int(plan.rows.shape[0]),
                      "piece_slices": int(plan.item_rows.shape[0]),
                      "piece_rows_cut": int(plan.split.shape[0]),
                      "piece_nnz": pieces[1].nnz}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
