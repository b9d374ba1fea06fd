"""K14's gather batch and the place of its y load, swept on the card.

    python scripts/torch_k14_sweep.py

Needs a CUDA card and nvcc.  Copies of ``kernels/label_prop.cu`` (with
``row_team.cuh``) are built with one constant changed each, into a
temporary directory, and bound in turn in place of the tree's library
(``kernels._BOUND``), so every variant runs through the port's own
wrapper: ``kVecLoads`` (float4 slot loads in flight a lane) 4, 8 (the
tree's) and 16 (K1's), ``kScalarLoads`` (single-column loads) 4, 8 (the
tree's) and 16, and y's row loaded on the other side of the gathers
(``kVecEarlyY``, ``kScalarEarlyY``).  Two turns, each variant timed in
each (CUDA events, 10 calls) on ``chip_smoke.py``'s phase 5 graph (S =
D⁻¹A,
1,958,363 rows) at C = 40 and 47 and at C = 47 carried at a stride of 48
(label propagation's layout); every output checked bitwise equal to the
tree's (the batch and the load order do not change the adds).

Prints one JSON line a width, with the card's name and power limit.
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

import torch  # noqa: E402

KDIR = os.path.join(os.path.dirname(HERE), "cleora_tpu_torch", "kernels")
VARIANTS = {
    "tree": [],
    "kVecLoads=4": [("constexpr int kVecLoads = 8;",
                     "constexpr int kVecLoads = 4;")],
    "kVecLoads=16 (K1's)": [("constexpr int kVecLoads = 8;",
                             "constexpr int kVecLoads = 16;")],
    "kScalarLoads=4": [("constexpr int kScalarLoads = 8;",
                        "constexpr int kScalarLoads = 4;")],
    "kScalarLoads=16": [("constexpr int kScalarLoads = 8;",
                         "constexpr int kScalarLoads = 16;")],
    "float4 groups: y before the gathers": [
        ("constexpr bool kVecEarlyY = false;",
         "constexpr bool kVecEarlyY = true;")],
    "single columns: y after the gathers": [
        ("constexpr bool kScalarEarlyY = true;",
         "constexpr bool kScalarEarlyY = false;")],
}


def build_variants(tmp: str) -> dict:
    """Every variant compiled at once; returns {name: CDLL}."""
    from cleora_tpu_torch.kernels import build

    header = open(os.path.join(KDIR, "row_team.cuh")).read()
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        d = os.path.join(tmp, f"v{i}")
        os.makedirs(d)
        src = open(os.path.join(KDIR, "label_prop.cu")).read()
        for old, new in edits:
            assert old in src, name
            src = src.replace(old, new)
        open(os.path.join(d, "label_prop.cu"), "w").write(src)
        open(os.path.join(d, "row_team.cuh"), "w").write(header)
        so = os.path.join(d, "lib.so")
        procs[name] = (subprocess.Popen(
            [build.nvcc(), *flags, os.path.join(d, "label_prop.cu"), "-o",
             so], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, (name, log)
        libs[name] = ctypes.CDLL(so)
    return libs


def bind(lib) -> None:
    """Route the wrapper's launches to a variant's library."""
    from cleora_tpu_torch import kernels

    raw = lib.label_prop_launch
    raw.restype = ctypes.c_int
    raw.argtypes = kernels._ARGTYPES["label_prop"]
    kernels._BOUND["label_prop"] = raw


def sweep(libs: dict, card: str) -> None:
    import torch.nn.functional as F

    import chip_smoke as cs
    import cleora_tpu_torch.classify as cl
    from cleora_tpu_torch.ops.label_prop import label_prop_step
    from cleora_tpu_torch.ops.spmm import CsrMatrix

    dev = torch.device("cuda")
    big = cs.random_graph(cs.FULL_NODES, cs.FULL_UND_EDGES, seed=7)
    rows, cols, svals, n = cl._row_normalized(big)
    del big
    S = CsrMatrix.from_coo(rows, cols, svals, n, dev)
    del rows, cols, svals
    for c, stride in ((40, 40), (47, 47), (47, 48)):
        f, y, mask = cs.label_state(n, c, dev, c)
        f, y = F.pad(f, (0, stride - c)), F.pad(y, (0, stride - c))
        out = torch.empty_like(f)
        want = None
        ms = {name: [] for name in libs}
        for _ in range(2):
            for name, lib in libs.items():
                bind(lib)
                label_prop_step(S, f, y, mask, 0.5, 0.5, out=out)
                if want is None:
                    want = out.clone()
                assert torch.equal(out, want), (c, stride, name)
                ms[name].append(cs.time_ms(lambda: label_prop_step(
                    S, f, y, mask, 0.5, 0.5, out=out)))
        print(json.dumps({"sweep": "K14", "c": c, "stride": stride,
                          "rows": n, "nnz": S.nnz, "ms": ms, "card": card}),
              flush=True)
        del f, y, mask, out, want


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
        sweep(libs, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
