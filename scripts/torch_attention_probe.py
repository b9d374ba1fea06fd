"""The fused attention pass's block size, edge batch and occupancy hint,
timed on the same card.

    python scripts/torch_attention_probe.py

Needs a CUDA card.  Builds copies of ``kernels/edge_attention.cu`` with
other values of its constants (threads a block, ``kAttThreads``; edges a
batch, the numerator of ``AttTile::kB``; a minimum of blocks an SM in
``__launch_bounds__``) into the build directory, one ``nvcc`` each, all
started together, and times each copy's ``attention_spmm_launch`` (10
launches by CUDA events, in the order of the list and then reversed) on
``chip_smoke.py``'s phase 5 graph (roadNet-CA's shape, seed 7, D = 256,
l2) and on its power-law graph (Chung-Lu, seed 7), beside the tree's
own build.  Every copy's output is held to the tree's at rtol=1e-5,
atol=1e-6.  Prints one JSON line a graph and the card's name and power
limit, and each copy's ptxas register count.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

# (label, threads a block, batch numerator for float4 slots (4 slot
# loads in flight a lane in the tree), min blocks an SM)
VARIANTS = (("tree", None, None, None),
            ("t128_b16", 128, 16, None),
            ("t128_b8", 128, 8, None),
            ("t128_b8_min6", 128, 8, 6),
            ("t256_b8", 256, 8, None),
            ("t64_b8", 64, 8, None))


def build_variants():
    """{label: (launch function, ptxas registers line)}."""
    from cleora_tpu_torch import kernels
    from cleora_tpu_torch.kernels import build

    src = open(build.source_path("edge_attention")).read()
    out_dir = os.path.join(build.BUILD_DIR, "attention_probe")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for label, threads, batch, min_blocks in VARIANTS:
        if threads is None:
            continue
        text = src.replace("constexpr int kAttThreads = 128;",
                           f"constexpr int kAttThreads = {threads};")
        text = text.replace("(kVec4 ? 4 : 8) / kS",
                            f"(kVec4 ? {batch} : {2 * batch}) / kS")
        if min_blocks:
            text = text.replace("__launch_bounds__(kAttThreads)",
                                f"__launch_bounds__(kAttThreads, {min_blocks})")
        path = os.path.join(out_dir, f"{label}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"lib{label}.so")
        procs[label] = (subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, path, "-o", lib],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    out = {}
    for label, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, log
        fn = ctypes.CDLL(lib).attention_spmm_launch
        fn.restype = ctypes.c_int
        fn.argtypes = kernels._ARGTYPES["attention_spmm"]
        regs = re.findall(r"Used (\d+) registers", log)
        out[label] = (fn, regs)
    return out


def run(fn, csr, x, hubs):
    from cleora_tpu_torch import kernels

    n, d = csr.n_rows, x.shape[1]
    out = torch.empty((n, d), dtype=torch.float32, device=x.device)
    hub = kernels._hub_args(hubs, x.device, "probe")
    part = stats = None
    if hub[4]:
        part = torch.empty((hub[4], d), dtype=torch.float32, device=x.device)
        stats = torch.empty((hub[4], 3), dtype=torch.float32, device=x.device)
    rc = fn(csr.indptr.data_ptr(), csr.indices.data_ptr(),
            csr.vals.data_ptr(), x.data_ptr(), out.data_ptr(), n, d, 1.0, 1,
            1, *hub, None if part is None else part.data_ptr(),
            None if stats is None else stats.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    assert rc == 0, rc
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from cleora_tpu_torch.kernels import build
    from cleora_tpu_torch.ops.attention import attention_spmm

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    build.build()
    variants = build_variants()
    for label, (_, regs) in variants.items():
        print(json.dumps({"variant": label, "registers": regs}), flush=True)
    dev = torch.device("cuda")
    g = cs.random_graph(cs.FULL_NODES, cs.FULL_UND_EDGES, seed=7)
    graphs = [("phase 5 (roadNet-CA shape)", g._device_csr("left", dev))]
    del g
    graphs.append(("power law (Chung-Lu, exponent 0.9)",
                   cs.chung_lu_csr(cs.FULL_NODES, cs.FULL_UND_EDGES, 7,
                                   dev)[0]))
    for name, csr in graphs:
        gen = torch.Generator(device=dev).manual_seed(3)
        x = torch.randn((csr.n_rows, cs.DIM), device=dev, generator=gen)
        x = x / torch.linalg.norm(x, dim=1, keepdim=True)
        hubs = csr.hub_plan()
        want = attention_spmm(csr, x, 1.0, "l2")
        calls = {"tree": lambda: attention_spmm(csr, x, 1.0, "l2")}
        for label, (fn, _) in variants.items():
            torch.testing.assert_close(run(fn, csr, x, hubs), want,
                                       rtol=1e-5, atol=1e-6)
            calls[label] = (lambda f=fn: run(f, csr, x, hubs))
        ms = {k: [] for k in calls}
        order = list(calls)
        for k in order + order[::-1]:
            ms[k].append(cs.time_ms(calls[k]))
        print(json.dumps({"graph": name, "ms": ms, "card": card}),
              flush=True)
        del want, x
    return 0


if __name__ == "__main__":
    sys.exit(main())
