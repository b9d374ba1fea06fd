"""When a ``torch.profiler`` session stops recording K1: a loop that
launches only K1 and K3 between sessions, in one process a mode.

    python scripts/torch_trace_probe.py [--sessions 40] [--between 20]
                                        [--modes bare,aten,distinct]

Needs a CUDA card.  K1 (``spmm_csr``) and K3 (``hash_init``) are built
first; then each mode runs in a process of its own (this script with
``--mode``), on a random 20,000-row Markov CSR at width 256:

* ``bare``: between sessions K1 and K3 ``--between`` times each; each
  session around one K1 and one K3;
* ``aten``: the same, and each session also launches 600 of one ATen
  elementwise kernel (a session of about the size of ``chip_smoke.py``'s
  traced embed iteration, 660 kernels);
* ``distinct``: the same as ``bare``, and between sessions 8 ATen kernels
  the process has not launched before (unary and binary ops over four
  dtypes), so the count of distinct kernels grows by 8 a session;
* ``warm``: ``distinct``, and each session first launches one ATen kernel
  and waits 50 ms before K1 and K3 (if only a session's first launches
  are lost, K1 and K3 survive here).

Each session prints one JSON line: the mode, the session, the launches
and distinct kernels the process made so far, and the kernel events the
profiler recorded (all, K1, K3).  Each mode ends with a summary line
(the first session without K1, with the counts at that point, or null)
and one ``tracing.trace()`` session, whose trace holds every launch of
the port's kernels: each ``(entry, source)``, source ``profiler`` where
the profiler recorded it and ``events`` where it was written from its
CUDA event pair.
"""

from __future__ import annotations

import argparse
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

ROWS = 20_000
DIM = 256
SESSION_ATEN = 600
DISTINCT_PER_ROUND = 8
UNARY = ("sin", "cos", "tan", "exp", "log1p", "sqrt", "rsqrt", "tanh",
         "sigmoid", "erf", "abs", "neg", "floor", "ceil", "round", "trunc",
         "frac", "reciprocal", "sign", "exp2", "log2", "log10", "expm1",
         "asin", "acos", "atan", "sinh", "cosh", "asinh", "atanh", "erfc",
         "lgamma", "digamma", "square", "relu", "sinc")
BINARY = ("add", "sub", "mul", "div", "maximum", "minimum", "pow", "atan2",
          "fmod", "remainder", "hypot", "copysign")
DTYPES = (torch.float32, torch.float64, torch.float16, torch.bfloat16)


def distinct_ops():
    """(label, call) pairs, each launching an ATen kernel of its own."""
    for dtype in DTYPES:
        for op in UNARY:
            yield f"{op}/{dtype}", (lambda o=op, t=dtype: getattr(
                torch, o)(torch.rand(4096, device="cuda", dtype=t) + 0.5))
        for op in BINARY:
            yield f"{op}/{dtype}", (lambda o=op, t=dtype: getattr(torch, o)(
                torch.rand(4096, device="cuda", dtype=t) + 0.5,
                torch.rand(4096, device="cuda", dtype=t) + 0.5))


def run_mode(mode: str, sessions: int, between: int) -> None:
    from torch.profiler import ProfilerActivity, profile

    from cleora_tpu_torch import kernels
    from cleora_tpu_torch.ops.spmm import CsrMatrix, spmm
    from cleora_tpu_torch.tracing import port_launches, trace

    rng = np.random.default_rng(0)
    deg = rng.poisson(6, size=ROWS)
    indptr = np.concatenate([[0], np.cumsum(deg)])
    cols = rng.integers(0, ROWS, size=int(indptr[-1]))
    vals = (1.0 / np.maximum(deg, 1))[np.repeat(np.arange(ROWS), deg)]
    csr = CsrMatrix.from_numpy(indptr, cols, vals, torch.device("cuda"))
    x = torch.randn((ROWS, DIM), device="cuda")
    hashes = torch.from_numpy(rng.integers(0, 2**62, size=ROWS)).cuda()
    filler = torch.rand(1 << 16, device="cuda")
    ops = iter(distinct_ops())
    state = {"launches": 0, "distinct": 2}

    def port():
        spmm(csr, x)
        kernels.hash_init(hashes, DIM)
        state["launches"] += 2

    def aten_burst():
        for _ in range(SESSION_ATEN):
            filler.mul_(1.0)
        state["launches"] += SESSION_ATEN

    first_lost = None
    port()
    if mode == "aten":
        aten_burst()
        state["distinct"] += 1
    for s in range(sessions):
        for _ in range(between):
            port()
        added = 0
        while mode in ("distinct", "warm") and added < DISTINCT_PER_ROUND:
            item = next(ops, None)
            if item is None:
                break
            try:
                item[1]()
            except (RuntimeError, TypeError):  # no kernel for this dtype
                continue
            added += 1
            state["launches"] += 1
            state["distinct"] += 1
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if mode == "warm":
                filler.mul_(1.0)
                torch.cuda.synchronize()
                time.sleep(0.05)
            port()
            if mode == "aten":
                aten_burst()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        k1 = sum("spmm_csr" in n for n in names)
        k3 = sum("hash_init" in n for n in names)
        line = {"mode": mode, "session": s + 1,
                "launches_so_far": state["launches"],
                "distinct_kernels_so_far": state["distinct"],
                "kernels": len(names), "spmm_csr": k1, "hash_init": k3}
        print(json.dumps(line), flush=True)
        if k1 == 0 and first_lost is None:
            first_lost = line
    with tempfile.TemporaryDirectory() as tmp:
        with trace(tmp):
            port()
        with open(os.path.join(tmp, "trace.json")) as f:
            traced = port_launches(json.load(f)["traceEvents"])
    print(json.dumps({"mode": mode, "first_session_without_k1": first_lost,
                      "tracing_trace_launches": traced}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=40)
    ap.add_argument("--between", type=int, default=20)
    ap.add_argument("--modes", default="bare,aten,distinct,warm")
    ap.add_argument("--mode", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    if args.mode:
        run_mode(args.mode, args.sessions, args.between)
        return 0
    from cleora_tpu_torch.kernels import build

    build.load("spmm_csr")
    build.load("hash_init")
    rc = 0
    for mode in args.modes.split(","):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--mode", mode,
             "--sessions", str(args.sessions), "--between",
             str(args.between)], cwd=os.path.dirname(HERE), timeout=900)
        rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
