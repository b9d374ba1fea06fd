#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (cleora_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

1. environment: the card's name and power limit, torch/CUDA versions;
2. build: K1 (kernels/spmm_csr.cu), K2 (kernels/row_normalize.cu), K3
   (kernels/hash_init.cu) and K4 (kernels/edge_attention.cu) are compiled
   from the checkout's sources, one nvcc each, in parallel;
3. each kernel against its plain PyTorch version on the card: K1 on a random
   Markov CSR with zero-degree rows and one row of degree 50,000, D in
   {8, 256, 300}, float32 and bfloat16 x, residual weight 0 and 0.3
   (float32 rtol=1e-5, atol=1e-6; bfloat16 atol=1e-2); K2 in l2 and l1
   modes on rows that include an all-zero row (atol=1e-6); K3 bitwise
   against its plain version and the host init on 20,000 random uint64
   hashes (0, 2**64-1 and top-bit values among them), D in {1, 7, 256, 300},
   seed in {0, 7, -3, 2**40+5}; K4 on the same CSR plus a row whose values
   are all 0, D in {8, 256, 300}, T in {0.7, 1.0} (rtol=1e-5, atol=1e-6);
4. slice parity: a 20,000-node random graph through the card and through
   device="cpu": embed() unwhitened allclose, whitened Gram matrices of
   2,000 sampled rows, bf16 storage, and the same early-stop iteration under
   a convergence threshold; embed_with_attention unwhitened allclose and
   whitened Gram; embed_multiscale and embed_weighted unwhitened allclose;
5. full width: bench.py's roadNet-CA-shaped graph (1,965,206 nodes,
   5,533,214 undirected edges, seed 7) ingested through
   SparseMatrix.from_edge_arrays, then the two main paths, each with the
   kernels' launch counts zeroed just before and read just after:
   embed(feature_dim=256, num_iterations=40, whiten=True) and
   embed_with_attention(feature_dim=256, num_iterations=40, whiten=True).
   Prints ingest, host and card init, loop seconds, edge-ops/s,
   per-iteration K1/K2/whiten times, peak device memory, torch.sparse.mm's
   time on the same product, and checks each output (finite, covariance
   close to the identity), K3's full-size output bitwise against the host
   init and one full-size K1, K2 and K4 call against their plain versions.

The line before the last is one JSON object with every kernel's numbers;
the last line is {"ok": true, "device": {...}}.  Without a CUDA card the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

# published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
# float32 (non-tensor-core) FLOP/s — the bounds below use these
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

K1_CHECK_ROWS = 20_000
HUB_DEGREE = 50_000
K3_CHECK_HASHES = 20_000
PARITY_NODES = 20_000
PARITY_EDGES = 60_000
PARITY_SAMPLE = 2_000
FULL_NODES = 1_965_206
FULL_UND_EDGES = 5_533_214
DIM = 256
ITERATIONS = 40


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_share(csr, x0, iterations: int = 3) -> None:
    """Device busy share of a few loop iterations, and the kernels that
    take the time, from a torch.profiler trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cleora_tpu_torch.ops.loop import embed_loop

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        embed_loop(csr, x0, iterations, 0.0, "l2", True)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side events only: a CPU op's row repeats its kernels' time
    kernels_us = [(e.key, e.self_device_time_total)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0]
    busy_us = sum(us for _, us in kernels_us)
    if not busy_us:
        log("device busy share: not measured (the trace holds no device time)")
        return
    log(f"device busy share over {iterations} traced iterations: "
        f"{busy_us / wall_us:.3f} ({busy_us / 1e3:.3f} of "
        f"{wall_us / 1e3:.3f} ms)")
    for key, us in sorted(kernels_us, key=lambda t: -t[1])[:8]:
        log(f"  {us / 1e3 / iterations:9.3f} ms/it  {key[:90]}")


def environment() -> str:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, "
        f"allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    return card


def build_kernels() -> None:
    from cleora_tpu_torch.kernels import build

    for name in build.KERNELS:  # build from the checkout's sources, always
        if os.path.exists(build.lib_path(name)):
            os.remove(build.lib_path(name))
    t0 = time.perf_counter()
    seconds = build.build()
    log(f"build: {time.perf_counter() - t0:.2f} s wall, per kernel "
        + ", ".join(f"{k} {v:.2f} s" for k, v in seconds.items()))
    for name, text in build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


def markov_csr(n: int, seed: int, hub_degree: int = 0):
    """Random left-Markov CSR (rows sum to 1) with zero-degree rows and,
    optionally, row 1 of degree ``hub_degree``."""
    rng = np.random.default_rng(seed)
    deg = rng.poisson(6, size=n)
    deg[::5] = 0
    if hub_degree:
        deg[1] = hub_degree
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    cols = rng.integers(0, n, size=int(indptr[-1]), dtype=np.int64)
    vals = (1.0 / np.maximum(deg, 1))[np.repeat(np.arange(n), deg)]
    return indptr, cols, vals.astype(np.float32)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def check_kernels(dev: torch.device) -> None:
    from cleora_tpu_torch.ops.normalize import (
        l1_normalize_plain,
        l2_normalize_plain,
        normalize,
    )
    from cleora_tpu_torch.ops.spmm import CsrMatrix, spmm, spmm_plain

    csr = CsrMatrix.from_numpy(*markov_csr(K1_CHECK_ROWS, 1, HUB_DEGREE), dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for d in (8, 256, 300):
        x32 = torch.randn((K1_CHECK_ROWS, d), device=dev, generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            for w in (0.0, 0.3):
                got = spmm(csr, x, w)
                want = spmm_plain(csr, x, w)
                torch.cuda.synchronize()
                tol = ({"rtol": 1e-5, "atol": 1e-6} if dtype == torch.float32
                       else {"rtol": 0.0, "atol": 1e-2})
                torch.testing.assert_close(got, want, **tol)
                log(f"K1 d={d} {str(dtype)[6:]} w={w}: max |err| "
                    f"{max_err(got, want):.3e}")
        x32[7] = 0.0
        for method, plain in (("l2", l2_normalize_plain),
                              ("l1", l1_normalize_plain)):
            got = normalize(x32.clone(), method)
            want = plain(x32.clone())
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=0.0, atol=1e-6)
            assert torch.all(got[7] == 0.0)
            log(f"K2 d={d} {method}: max |err| {max_err(got, want):.3e}")
    check_k3(dev)
    check_k4(dev)


def check_k3(dev: torch.device) -> None:
    from cleora_tpu_torch.graph.hashing import init_embeddings
    from cleora_tpu_torch.ops.init import (
        device_init,
        device_init_plain,
        hashes_as_int64,
    )

    h = np.random.default_rng(2).integers(
        0, 2**64 - 1, size=K3_CHECK_HASHES, dtype=np.uint64, endpoint=True)
    h[:5] = [0, 2**64 - 1, 2**63, 2**63 - 1, 2**63 + 1]
    t = hashes_as_int64(h).to(dev)
    for d in (1, 7, 256, 300):
        for seed in (0, 7, -3, 2**40 + 5):
            got = device_init(t, d, seed)
            want = device_init_plain(t, d, seed)
            host = init_embeddings(h, d, seed)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (d, seed)
            assert got.cpu().numpy().tobytes() == host.tobytes(), (d, seed)
        log(f"K3 d={d}: bitwise equal to its plain version and the host init "
            "for seeds 0, 7, -3, 2**40+5")


def check_k4(dev: torch.device) -> None:
    from cleora_tpu_torch.ops.attention import (
        edge_attention_weights,
        edge_attention_weights_plain,
    )
    from cleora_tpu_torch.ops.normalize import l2_normalize_plain
    from cleora_tpu_torch.ops.spmm import CsrMatrix

    indptr, cols, vals = markov_csr(K1_CHECK_ROWS, 1, HUB_DEGREE)
    deg = np.diff(indptr)
    zero_row = int(np.flatnonzero(deg[2:] > 0)[0]) + 2
    vals[indptr[zero_row]:indptr[zero_row + 1]] = 0.0
    csr = CsrMatrix.from_numpy(indptr, cols, vals, dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    for d in (8, 256, 300):
        xn = l2_normalize_plain(
            torch.randn((K1_CHECK_ROWS, d), device=dev, generator=gen))
        for temperature in (0.7, 1.0):
            got = edge_attention_weights(csr, xn, temperature)
            want = edge_attention_weights_plain(csr, xn, temperature)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
            zero = got[int(indptr[zero_row]):int(indptr[zero_row + 1])]
            assert torch.all(zero == 0.0)
            log(f"K4 d={d} T={temperature}: max |err| "
                f"{max_err(got, want):.3e}")


def random_graph(n_nodes: int, n_und_edges: int, seed: int):
    """bench.py's synthetic_coo edge draw, as a SparseMatrix."""
    import cleora_tpu_torch as ctt

    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, size=n_und_edges, dtype=np.int64)
    dst = rng.integers(0, n_nodes, size=n_und_edges, dtype=np.int64)
    return ctt.SparseMatrix.from_edge_arrays(src, dst)


def slice_parity(dev: torch.device) -> None:
    import cleora_tpu_torch as ctt

    g = random_graph(PARITY_NODES, PARITY_EDGES, seed=3)
    cpu = torch.device("cpu")
    kw = dict(feature_dim=DIM, num_iterations=ITERATIONS, whiten=False)
    a = ctt.embed(g, device=dev, **kw)
    b = ctt.embed(g, device=cpu, **kw)
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    log(f"parity unwhitened ({g.num_entities} nodes, {ITERATIONS} it): "
        f"max |err| {np.abs(a - b).max():.3e}")

    kw = dict(feature_dim=DIM, num_iterations=5, whiten=True)
    a = ctt.embed(g, device=dev, **kw)
    b = ctt.embed(g, device=cpu, **kw)
    assert np.isfinite(a).all()
    rows = np.random.default_rng(0).choice(g.num_entities, PARITY_SAMPLE,
                                           replace=False)
    err, scale = gram_err(a, b, rows)
    log(f"parity whitened Gram ({PARITY_SAMPLE} rows, 5 it): max |err| "
        f"{err:.3e} of max |G| {scale:.3e}")
    assert err <= 1e-4 * scale, (err, scale)

    kw = dict(feature_dim=DIM, num_iterations=5, whiten=False,
              dtype="bfloat16")
    a = ctt.embed(g, device=dev, **kw)
    b = ctt.embed(g, device=cpu, **kw)
    np.testing.assert_allclose(a, b, rtol=0.0, atol=2e-2)
    log(f"parity bfloat16 storage (5 it): max |err| {np.abs(a - b).max():.3e}")

    its = [g.embed_fast_convergence(DIM, ITERATIONS,
                                    convergence_threshold=1e-3, device=d)[1]
           for d in (dev, cpu)]
    log(f"parity convergence: stops after {its[0]} (card) / {its[1]} (cpu) "
        "iterations")
    assert its[0] == its[1] and 1 < its[0] < ITERATIONS, its

    kw = dict(feature_dim=DIM, num_iterations=10, attention_temperature=0.7,
              whiten=False)
    a = ctt.embed_with_attention(g, device=dev, **kw)
    b = ctt.embed_with_attention(g, device=cpu, **kw)
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    log(f"parity embed_with_attention unwhitened (10 it): max |err| "
        f"{np.abs(a - b).max():.3e}")
    kw = dict(feature_dim=DIM, num_iterations=5, whiten=True)
    a = ctt.embed_with_attention(g, device=dev, **kw)
    b = ctt.embed_with_attention(g, device=cpu, **kw)
    assert np.isfinite(a).all()
    err, scale = gram_err(a, b, rows)
    log(f"parity embed_with_attention whitened Gram ({PARITY_SAMPLE} rows, "
        f"5 it): max |err| {err:.3e} of max |G| {scale:.3e}")
    assert err <= 1e-4 * scale, (err, scale)

    kw = dict(feature_dim=DIM, scales=[3, 10], whiten=False)
    a = ctt.embed_multiscale(g, device=dev, **kw)
    b = ctt.embed_multiscale(g, device=cpu, **kw)
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    log(f"parity embed_multiscale (scales 3, 10): max |err| "
        f"{np.abs(a - b).max():.3e}")

    rng = np.random.default_rng(5)
    ends = rng.integers(0, PARITY_NODES, size=(PARITY_EDGES, 2))
    weights = rng.uniform(0.5, 3.0, size=PARITY_EDGES)
    edges = [(f"{s} {d}", float(w)) for (s, d), w in zip(ends, weights)]
    kw = dict(feature_dim=DIM, num_iterations=10, whiten=False)
    a = ctt.embed_weighted(edges, "complex::reflexive::node", device=dev,
                           **kw)[1]
    b = ctt.embed_weighted(edges, "complex::reflexive::node", device=cpu,
                           **kw)[1]
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    log(f"parity embed_weighted (10 it): max |err| {np.abs(a - b).max():.3e}")


def gram_err(a: np.ndarray, b: np.ndarray, rows: np.ndarray):
    """Largest difference of the two row Gram matrices over ``rows``, and
    the largest entry of the second."""
    ga = a[rows].astype(np.float64) @ a[rows].T.astype(np.float64)
    gb = b[rows].astype(np.float64) @ b[rows].T.astype(np.float64)
    return np.abs(ga - gb).max(), np.abs(gb).max()


def check_covariance(out: np.ndarray, dev: torch.device) -> None:
    """A whitened output: finite, and its covariance within 1e-2 of I."""
    n = out.shape[0]
    assert out.shape == (n, DIM) and np.isfinite(out).all()
    o = torch.from_numpy(out).to(dev, torch.float64)
    oc = o - o.mean(dim=0)
    cov = oc.T @ oc / (n - 1)
    cov_err = float((cov - torch.eye(DIM, device=dev,
                                     dtype=torch.float64)).abs().max())
    log(f"output covariance: max |cov - I| {cov_err:.3e}")
    assert cov_err <= 1e-2


def run_main_path(name: str, call) -> tuple:
    """Drives one main path with every launch count zeroed just before and
    read just after; returns (output, launches)."""
    from cleora_tpu_torch import kernels

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = call()
    wall_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log(f"{name}: {wall_s:.3f} s end to end, launches {launches}, "
        f"peak device memory {peak / 2**30:.3f} GiB ({held / 2**30:.3f} GiB "
        "held before the call)")
    return out, launches


def full_width(dev: torch.device, card: str) -> list:
    import torch.nn.functional as F

    import cleora_tpu_torch as ctt
    from cleora_tpu_torch.ops.attention import (
        edge_attention_weights,
        edge_attention_weights_plain,
    )
    from cleora_tpu_torch.ops.init import device_init, device_init_plain
    from cleora_tpu_torch.ops.loop import embed_loop
    from cleora_tpu_torch.ops.normalize import l2_normalize_plain, normalize
    from cleora_tpu_torch.ops.spmm import spmm, spmm_plain
    from cleora_tpu_torch.ops.whiten import whiten

    t0 = time.perf_counter()
    g = random_graph(FULL_NODES, FULL_UND_EDGES, seed=7)
    ingest_s = time.perf_counter() - t0
    n, nnz = g.num_entities, g.num_edges
    t0 = time.perf_counter()
    init = g.initialize_deterministically(DIM)
    init_s = time.perf_counter() - t0
    log(f"full width: {n} entities, {nnz} nnz; ingest {ingest_s:.3f} s, "
        f"host init {init_s:.3f} s")

    # ---- the main path, through the user's entry point
    out, launches = run_main_path("embed()", lambda: ctt.embed(
        g, feature_dim=DIM, num_iterations=ITERATIONS, whiten=True))
    assert launches == {"spmm_csr": ITERATIONS, "row_normalize": ITERATIONS,
                        "hash_init": 1, "edge_attention": 0}, launches
    check_covariance(out, dev)
    del out

    # ---- the attention path, through the user's entry point
    att_out, att_launches = run_main_path(
        "embed_with_attention()", lambda: ctt.embed_with_attention(
            g, feature_dim=DIM, num_iterations=ITERATIONS, whiten=True))
    assert att_launches == {
        "spmm_csr": ITERATIONS, "row_normalize": 2 * ITERATIONS - 1,
        "hash_init": 1, "edge_attention": ITERATIONS - 1}, att_launches
    check_covariance(att_out, dev)
    del att_out

    # ---- K3 at full width: bitwise against the host init, and its time
    hashes = g._device_hashes(dev)
    k3_out = device_init(hashes, DIM)
    torch.cuda.synchronize()
    assert k3_out.cpu().numpy().tobytes() == init.tobytes()
    k3_plain = device_init_plain(hashes, DIM)
    assert torch.equal(k3_out, k3_plain)
    del k3_plain
    k3_ms = time_ms(lambda: device_init(hashes, DIM))
    k3_plain_ms = time_ms(lambda: device_init_plain(hashes, DIM), reps=3,
                          warmup=1)
    log(f"K3 {k3_ms:.3f} ms on the card (plain {k3_plain_ms:.3f} ms), "
        f"bitwise equal to the host init, which took {init_s:.3f} s; [{card}]")

    # ---- the loop alone, on the cached device CSR
    csr = g._device_csr("left", dev)
    x0 = k3_out
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    embed_loop(csr, x0, ITERATIONS, 0.0, "l2", True)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    log(f"loop: {loop_s:.3f} s for {ITERATIONS} iterations, "
        f"{nnz * ITERATIONS / loop_s:.4e} edge-ops/s")

    # ---- per-iteration split by CUDA events over a few iterations
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(4)]
          for _ in range(3)]
    x = x0
    for e in ev:
        e[0].record()
        y = spmm(csr, x)
        e[1].record()
        y = normalize(y, "l2")
        e[2].record()
        x = whiten(y)
        e[3].record()
    torch.cuda.synchronize()
    split = [np.mean([e[k].elapsed_time(e[k + 1]) for e in ev])
             for k in range(3)]
    log(f"per iteration: K1 {split[0]:.3f} ms, K2 {split[1]:.3f} ms, "
        f"whiten {split[2]:.3f} ms")
    # whitening's bound: its two N x D x D float32 GEMMs (covariance and
    # projection) against reading its input and writing its output once
    wh_ops_ms = 2 * 2 * n * DIM * DIM / FP32_FLOP_PER_S * 1e3
    wh_bytes_ms = 2 * 4 * n * DIM / HBM_BYTES_PER_S * 1e3
    log(f"whiten bound {max(wh_ops_ms, wh_bytes_ms):.3f} ms (operations "
        f"{wh_ops_ms:.3f} ms, bytes {wh_bytes_ms:.3f} ms)")
    device_share(csr, x0)

    # ---- the same split of an attention iteration (ops/attention.py's
    # attention_step, stage by stage)
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(6)]
          for _ in range(3)]
    for e in ev:
        e[0].record()
        xn = normalize(x.to(torch.float32, copy=True), "l2")
        e[1].record()
        weights = edge_attention_weights(csr, xn, 1.0)
        e[2].record()
        y = spmm(csr.with_vals(weights), x)
        e[3].record()
        y = normalize(y, "l2")
        e[4].record()
        x = whiten(y)
        e[5].record()
    torch.cuda.synchronize()
    split = [np.mean([e[k].elapsed_time(e[k + 1]) for e in ev])
             for k in range(5)]
    log(f"per attention iteration: copy + K2 {split[0]:.3f} ms, K4 "
        f"{split[1]:.3f} ms, K1 {split[2]:.3f} ms, K2 {split[3]:.3f} ms, "
        f"whiten {split[4]:.3f} ms")
    del x, xn, y, weights

    # ---- each kernel at the main path's shape: error, times, bounds
    k1_out = spmm(csr, x0)
    k1_plain = spmm_plain(csr, x0)
    torch.cuda.synchronize()
    k1_err = max_err(k1_out, k1_plain)
    torch.testing.assert_close(k1_out, k1_plain, rtol=1e-5, atol=1e-6)
    k1_ms = time_ms(lambda: spmm(csr, x0))
    k1_plain_ms = time_ms(lambda: spmm_plain(csr, x0), reps=3, warmup=1)
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        a = torch.sparse_csr_tensor(csr.indptr.int(), csr.indices, csr.vals,
                                    size=(n, n), check_invariants=False)
        lib = torch.sparse.mm(a, x0)
    torch.testing.assert_close(lib, k1_plain, rtol=1e-5, atol=1e-6)
    k1_lib_ms = time_ms(lambda: torch.sparse.mm(a, x0))
    del a, lib, k1_plain

    y = k1_out
    k2_out = normalize(y.clone(), "l2")
    k2_plain = l2_normalize_plain(y.clone())
    torch.cuda.synchronize()
    k2_err = max_err(k2_out, k2_plain)
    torch.testing.assert_close(k2_out, k2_plain, rtol=0.0, atol=1e-6)
    k2_ms = time_ms(lambda: normalize(k2_out, "l2"))
    k2_plain_ms = time_ms(lambda: l2_normalize_plain(k2_plain))
    k2_lib_ms = time_ms(lambda: F.normalize(y, p=2.0, dim=1, eps=1e-10))
    del k2_plain

    # K4 on the normalised state of one propagate step (T = 1, the default)
    xn = k2_out
    k4_out = edge_attention_weights(csr, xn, 1.0)
    k4_plain = edge_attention_weights_plain(csr, xn, 1.0)
    torch.cuda.synchronize()
    k4_err = max_err(k4_out, k4_plain)
    torch.testing.assert_close(k4_out, k4_plain, rtol=1e-5, atol=1e-6)
    del k4_plain
    k4_ms = time_ms(lambda: edge_attention_weights(csr, xn, 1.0))
    k4_plain_ms = time_ms(lambda: edge_attention_weights_plain(csr, xn, 1.0),
                          reps=3, warmup=1)

    # bound: each input read once, each output written once, against the
    # flops at float32 — the larger of the two times
    k1_bytes = 8 * (n + 1) + 8 * nnz + 4 * n * DIM + 4 * n * DIM
    k1_flops = 2 * nnz * DIM
    k2_bytes = 2 * 4 * n * DIM
    k2_flops = 3 * n * DIM
    # K3: the hashes in, the init out; one float division per value (its
    # integer work has no float32 peak to set it against)
    k3_bytes = 8 * n + 4 * n * DIM
    k3_flops = n * DIM
    # K4: xn, the CSR and the weights once; the scores' dot products
    k4_bytes = 4 * n * DIM + 8 * (n + 1) + 8 * nnz + 4 * nnz
    k4_flops = 2 * nnz * DIM
    gather_bytes = nnz * (8 + 4 * DIM) + 4 * n * DIM
    log(f"K1 {k1_ms:.3f} ms (plain {k1_plain_ms:.3f}, torch.sparse.mm "
        f"{k1_lib_ms:.3f}); one x row per edge = {gather_bytes / 1e9:.3f} GB "
        f"-> {gather_bytes / (k1_ms * 1e-3) / 1e12:.3f} TB/s; [{card}]")
    log(f"K2 {k2_ms:.3f} ms (plain {k2_plain_ms:.3f}, F.normalize "
        f"{k2_lib_ms:.3f}); [{card}]")
    log(f"K4 {k4_ms:.3f} ms (plain {k4_plain_ms:.3f}); one xn row per edge = "
        f"{gather_bytes / 1e9:.3f} GB -> "
        f"{gather_bytes / (k4_ms * 1e-3) / 1e12:.3f} TB/s; [{card}]")

    def entry(name, source, replaces, ms, plain_ms, lib_ms, err, nbytes,
              flops, runs):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOP_PER_S * 1e3
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": runs[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms,
        }

    return [
        entry("spmm_csr", "cleora_tpu_torch/kernels/spmm_csr.cu",
              "cleora_tpu/ops/spmm_ell.py:437", k1_ms, k1_plain_ms,
              k1_lib_ms, k1_err, k1_bytes, k1_flops, launches),
        entry("row_normalize", "cleora_tpu_torch/kernels/row_normalize.cu",
              "cleora_tpu/ops/normalize.py:15", k2_ms, k2_plain_ms,
              k2_lib_ms, k2_err, k2_bytes, k2_flops, launches),
        # no single PyTorch call computes K3's or K4's function
        entry("hash_init", "cleora_tpu_torch/kernels/hash_init.cu",
              "cleora_tpu/ops/init.py:60", k3_ms, k3_plain_ms, None, 0.0,
              k3_bytes, k3_flops, launches),
        entry("edge_attention", "cleora_tpu_torch/kernels/edge_attention.cu",
              "cleora_tpu/__init__.py:502", k4_ms, k4_plain_ms, None, k4_err,
              k4_bytes, k4_flops, att_launches),
    ]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = environment()
    build_kernels()
    check_kernels(dev)
    slice_parity(dev)
    rows = full_width(dev, card)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
