"""Profiler sessions in one long process: which of them record the port's
ctypes-launched kernels.

    python scripts/torch_trace_sessions.py [--cudart-shared] [--nccl]
                                           [--busy 3] [--sessions 4]

Needs a CUDA card.  The port's kernels are built first (into a build
directory of their own with ``--cudart-shared``, which links each library
against the shared CUDA runtime instead of a static copy), K1 runs once
outside any profiler (with ``--nccl``: inside a one-rank NCCL process
group, as ``chip_smoke.py``'s phases 11-14 use one, beside an all-reduce;
the group is destroyed before the sessions), then ``--busy`` sessions of
``torch.profiler``
with ``key_averages()`` over three iterations of the embed loop (as
``chip_smoke.py``'s ``device_busy`` does), then ``--sessions``
``tracing.trace()`` sessions, each around one ``embed()`` iteration on
``chip_smoke.py``'s phase 4 graph (20,000 nodes, 60,000 edges).  Prints
one JSON line per session: its kind, its kernel events and how many of them
are K1 (``spmm_csr``) and K2 (``row_normalize``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

from cleora_tpu_torch.kernels import build  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cudart-shared", action="store_true")
    ap.add_argument("--nccl", action="store_true")
    ap.add_argument("--busy", type=int, default=3)
    ap.add_argument("--sessions", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    if args.cudart_shared:
        build.NVCC_FLAGS = (*build.NVCC_FLAGS, "-cudart", "shared")
        build.BUILD_DIR = os.path.join(build.BUILD_DIR, "cudart_shared")
    build.build()

    import chip_smoke as cs
    import cleora_tpu_torch as ctt
    from cleora_tpu_torch.ops.loop import embed_loop
    from cleora_tpu_torch.tracing import annotate, trace
    from torch.profiler import ProfilerActivity, profile

    g = cs.random_graph(cs.PARITY_NODES, cs.PARITY_EDGES, seed=3)
    if args.nccl:
        with cs.one_rank_nccl_group():
            import torch.distributed as dist

            dist.all_reduce(torch.ones(4, device="cuda"))
            ctt.embed(g, feature_dim=cs.DIM, num_iterations=1)
    else:
        ctt.embed(g, feature_dim=cs.DIM, num_iterations=1)  # K1 first
    torch.cuda.synchronize()
    csr = g._device_csr("left", torch.device("cuda"))

    def report(kind, i, names):
        print(json.dumps({
            "cudart_shared": args.cudart_shared, "nccl": args.nccl,
            "session": kind, "i": i,
            "kernels": len(names),
            "spmm_csr": sum("spmm_csr" in k for k in names),
            "row_normalize": sum("row_normalize" in k for k in names)}),
            flush=True)

    for i in range(args.busy):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            x0 = torch.randn((g.num_entities, cs.DIM), device="cuda")
            embed_loop(csr, x0, 3, 0.0, "l2", True)
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if e.self_device_time_total > 0]
        report("busy", i, names)
    for i in range(args.sessions):
        with tempfile.TemporaryDirectory() as tmp:
            with trace(tmp):
                with annotate("session"):
                    ctt.embed(g, feature_dim=cs.DIM, num_iterations=1)
            with open(os.path.join(tmp, "trace.json")) as f:
                events = json.load(f)["traceEvents"]
        report("trace", i, cs.trace_kernels(events))
    return 0


if __name__ == "__main__":
    sys.exit(main())
