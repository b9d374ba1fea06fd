"""K1 against the parent tree's K1 on the same card, in one process.

    python scripts/torch_k1_probe.py --parent DIR

Needs a CUDA card.  ``DIR`` holds the parent tree's
``cleora_tpu_torch/kernels/spmm_csr.cu`` (e.g. ``git archive <parent>
cleora_tpu_torch/kernels/spmm_csr.cu | tar -x -C DIR``: the design with a
row of threads a row and no epilogue normalisation, whose launch function
takes ``indptr, indices, vals, x, x_bf16, res, out, n_rows, d, keep, w,
vec4, stream``).  It is built into the build directory beside this
tree's kernels.  On ``chip_smoke.py``'s phase 5 graph (roadNet-CA's
shape, seed 7) at D = 256 and 64, and on its power-law graph (Chung-Lu,
seed 7) at D = 256, it times, in the order parent, this tree, this tree,
parent (10 launches each by CUDA events): the parent's K1 followed by K2
(the loop's step until this tree), this tree's K1 with the l2
normalisation fused, and each K1 alone without normalisation.  Prints one
JSON line a graph and width, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

_c = ctypes
PARENT_ARGTYPES = [_c.c_void_p, _c.c_void_p, _c.c_void_p, _c.c_void_p,
                   _c.c_int, _c.c_void_p, _c.c_void_p, _c.c_int64,
                   _c.c_int64, _c.c_float, _c.c_float, _c.c_int, _c.c_void_p]


def parent_k1(parent_dir: str):
    """The parent's K1 launch function, built from its source."""
    from cleora_tpu_torch.kernels import build

    src = os.path.join(parent_dir, "cleora_tpu_torch", "kernels",
                       "spmm_csr.cu")
    out_dir = os.path.join(build.BUILD_DIR, "parent")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libspmm_csr_parent.so")
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, src, "-o", lib],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(lib).spmm_csr_launch
    fn.restype = ctypes.c_int
    fn.argtypes = PARENT_ARGTYPES

    def run(csr, x):
        n, d = csr.n_rows, x.shape[1]
        out = torch.empty((n, d), dtype=torch.float32, device=x.device)
        rc = fn(csr.indptr.data_ptr(), csr.indices.data_ptr(),
                csr.vals.data_ptr(), x.data_ptr(), 0, x.data_ptr(),
                out.data_ptr(), n, d, 1.0, 0.0, int(d % 4 == 0),
                torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        return out
    return run


def compare(label: str, csr, d: int, parent, card: str) -> None:
    import chip_smoke as cs
    from cleora_tpu_torch import kernels
    from cleora_tpu_torch.ops.normalize import l2_normalize_plain, normalize
    from cleora_tpu_torch.ops.spmm import spmm, spmm_plain

    gen = torch.Generator(device="cuda").manual_seed(d)
    x = torch.randn((csr.n_rows, d), device="cuda", generator=gen)
    want = spmm_plain(csr, x)
    # rows up to LONG_SLICE entries (chip_smoke.py checks the hubs)
    short = (csr.indptr[1:] - csr.indptr[:-1]) <= kernels.LONG_SLICE
    torch.testing.assert_close(parent(csr, x)[short], want[short],
                               rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(spmm(csr, x, normalization="l2")[short],
                               l2_normalize_plain(want.clone())[short],
                               rtol=1e-5, atol=1e-6)
    del want
    runs = {"parent K1 + K2": lambda: normalize(parent(csr, x), "l2"),
            "K1 l2 fused": lambda: spmm(csr, x, normalization="l2"),
            "parent K1": lambda: parent(csr, x),
            "K1": lambda: spmm(csr, x)}
    ms = {k: [] for k in runs}
    for order in (("parent K1 + K2", "parent K1"), ("K1 l2 fused", "K1"),
                  ("K1 l2 fused", "K1"), ("parent K1 + K2", "parent K1")):
        for k in order:
            ms[k].append(cs.time_ms(runs[k]))
    print(json.dumps({"graph": label, "rows": csr.n_rows, "nnz": csr.nnz,
                      "d": d, "ms": ms, "card": card}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from cleora_tpu_torch.kernels import build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    build.build()
    parent = parent_k1(args.parent)
    dev = torch.device("cuda")
    g = cs.random_graph(cs.FULL_NODES, cs.FULL_UND_EDGES, seed=7)
    csr = g._device_csr("left", dev)
    for d in (256, 64):
        compare("phase 5 (roadNet-CA shape)", csr, d, parent, card)
    del g, csr
    csr, _ = cs.chung_lu_csr(cs.FULL_NODES, cs.FULL_UND_EDGES, 7, dev)
    compare("power law (Chung-Lu, exponent 0.9)", csr, 256, parent, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
