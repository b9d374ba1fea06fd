#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (cleora_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

1. environment: the card's name and power limit, torch/CUDA versions;
2. build: K1 (kernels/spmm_csr.cu), K2 (kernels/row_normalize.cu), K3
   (kernels/hash_init.cu), K4 (kernels/edge_attention.cu), K5
   (kernels/spmm_axpy.cu), K6 (kernels/dense_markov.cu), K7
   (kernels/log_clip.cu), K8 (kernels/walk_uniform.cu), K9
   (kernels/pair_enum.cu), K10 (kernels/run_length.cu) and K11
   (kernels/ppmi.cu) are compiled from the checkout's sources, one nvcc
   each, in parallel;
3. each kernel against its plain PyTorch version on the card: K1 on a random
   Markov CSR with zero-degree rows and one row of degree 50,000, D in
   {8, 256, 300, 4096} (the last loops over column tiles, as the blocked
   paths do), float32 and bfloat16 x, residual weight 0 and 0.3
   (float32 rtol=1e-5, atol=1e-6; bfloat16 atol=1e-2); K2 in l2 and l1
   modes on rows that include an all-zero row (atol=1e-6); K3 bitwise
   against its plain version and the host init on 20,000 random uint64
   hashes (0, 2**64-1 and top-bit values among them), D in {1, 7, 256, 300},
   seed in {0, 7, -3, 2**40+5}; K4 on the same CSR plus a row whose values
   are all 0, D in {8, 256, 300}, T in {0.7, 1.0} (rtol=1e-5, atol=1e-6);
   K5 on the first CSR, D in {8, 136, 256, 300, 4096}, with RandNE's,
   Chebyshev's (z and acc) and Katz's coefficients (rtol=1e-5, atol=1e-6:
   the tail is rounded like the plain version's, the row sum in another
   order); K6 at n in {1, 257, 4096} with duplicate entries and an empty
   row (P and deg atol=1e-6, vol rtol=1e-6); K7 on (4096, 4096) and
   (1000, 300), NetMF's and GraRep's modes, with and without scales
   (atol=1e-6: the same float32 operations);
4. slice parity: a 20,000-node random graph through the card and through
   device="cpu": embed() unwhitened allclose, whitened Gram matrices of
   2,000 sampled rows, bf16 storage, and the same early-stop iteration under
   a convergence threshold; embed_with_attention unwhitened allclose and
   whitened Gram; embed_multiscale and embed_weighted unwhitened allclose;
   the spectral siblings: _prone_chebyshev_core and
   _device_spmm_weighted_sum allclose (rtol=1e-4, atol=1e-5),
   embed_hope(feature_dim=32) by the Gram matrix of 2,000 rows (atol=5e-3),
   and on a 2,000-node graph embed_netmf and embed_grarep, dense and with
   block_rows=256, by the Gram matrix of all rows (atol=5e-3: unit rows, a
   sketched SVD whose column signs and near-degenerate directions may
   differ between cuSOLVER and LAPACK);
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
   init and one full-size K1, K2 and K4 call against their plain versions;
6. the spectral siblings at full width, each through its public entry point
   with backend="device" and the launch counts zeroed before and read
   after: embed_randne (40 iterations), embed_prone and embed_hope at
   feature_dim=256 on phase 5's graph (one run each, under the stage
   stopwatch); embed_netmf and embed_grarep dense
   at 32,768 nodes and 98,304 undirected edges (six (n, n) float32 buffers
   are 25.8 GB) and blocked (block_rows=4096, power_iters=1) at 200,000
   nodes and 600,000 undirected edges.  Each entry point runs twice: once
   as a user calls it, which gives the end-to-end seconds, the launch
   counts and the peak device memory, and once more with its stages wrapped
   in a stopwatch that synchronises the device around every call, which
   gives the seconds by stage and nothing else.  Checks each output
   (finite, unit rows) and holds the kernels against their plain versions
   at every shape these paths give them: K5 at D=256 with each coefficient
   set and its Katz step at D=136 on the big graph, K6 and K7 at 32,768
   nodes, and one row block of each blocked path step by step on the
   200,000-node graph's transposed transition CSR (K5 and K1 at
   (200,000, 4,096) on the walk's own states, K7 in NetMF's mode on the
   summed walk and in GraRep's on each power); times them beside one
   library call each;
7. DeepWalk (the walk pipeline), with launch counts zeroed before and read
   after its main path: on a 20,000-node, 60,000-edge parity graph, K8, K9 and K10
   bitwise against their plain versions on the first walk batch (K10 after
   the sweep and after a merge), the walks and the count ranges of the card
   bitwise equal to device="cpu", K11 against its plain version (column
   sums and row pointers bitwise, values rtol=1e-6: another logf), and
   embed_deepwalk with device counting, with host counting and the device
   factorization, and with the host factorization, each by the Gram matrix
   of 2,000 rows against device="cpu" (atol=1e-3: a value perturbation of
   1e-6 moves it by 2e-5 on this graph; the graph is a ring plus random
   edges, connected, because a small component's rows are rounding noise
   after the factorization on any backend); at full width, scripts/deepwalk_e2e.py's corpus (1,000,000 nodes,
   5,500,000 undirected edges from default_rng(7), 2 walks of 80 per node,
   window 5; num_walks cut from the API's 10 to 2) through
   embed_deepwalk(feature_dim=256, backend="device", cooccurrence="device")
   once untouched and once under the stage stopwatch, the count alone
   (unique pairs within 1 % of the JAX package's 810,145,222 on this
   corpus shape), K8-K11 against their plain versions at the main path's
   shapes and timed beside torch.sort and torch.unique_consecutive; and
   scripts/walk_quality_probe.py's 100,000-node, 50-community planted
   partition, whose centroid accuracy must reach 0.99.

The line before the last is one JSON object with every kernel's numbers;
the last line is {"ok": true, "device": {...}}.  Without a CUDA card the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import inspect
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
SMALL_PARITY_NODES = 2_000
SMALL_PARITY_EDGES = 6_000
DENSE_NODES = 32_768
DENSE_UND_EDGES = 98_304
BLOCKED_NODES = 200_000
BLOCKED_UND_EDGES = 600_000
BLOCK_ROWS = 4_096
GRAREP_STEPS = 4
# phase 7: scripts/deepwalk_e2e.py's defaults (1M nodes, 5.5M undirected
# edges from default_rng(7), 2 walks of 80 per node, window 5), at D=256
WALK_NODES = 1_000_000
WALK_UND_EDGES = 5_500_000
WALKS_PER_NODE = 2
WALK_LENGTH = 80
WINDOW = 5
# unique pairs the JAX package counted on this corpus shape (RESULTS.md:
# 813-838); the port's walks are another stream, so its count is held to 1 %
JAX_UNIQUE_PAIRS = 810_145_222
WALK_PARITY_LENGTH = 40
WALK_PARITY_DIM = 32
WALK_PARITY_PASSES = 3
# scripts/walk_quality_probe.py's defaults
QUALITY_NODES = 100_000
QUALITY_COMMUNITIES = 50
QUALITY_DEG_IN = 8
QUALITY_DEG_OUT = 2
QUALITY_DIM = 64
QUALITY_WALK_LENGTH = 40


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
    for d in (8, 256, 300, 4096):
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
    check_k5(dev, csr)
    check_k6(dev)
    check_k7(dev)


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


# K5's coefficient sets: (a, b, c, d, takes z, takes acc)
K5_CASES = {
    "randne": (1.0, 0.0, 0.0, 0.25, False, True),
    "chebyshev": (-2.0, 2.0, -1.0, 0.0497, True, True),
    "katz": (0.1, 0.0, 0.0, 1.0, False, True),
}


def k5_pair(csr, x, z, acc, case: str):
    """One K5 call and its plain version on the same inputs; returns
    (out, acc) of each."""
    from cleora_tpu_torch.ops.spmm import spmm_axpy, spmm_axpy_plain

    a, b, c, d, has_z, has_acc = K5_CASES[case]
    got_acc = acc.clone() if has_acc else None
    want_acc = acc.clone() if has_acc else None
    got = spmm_axpy(csr, x, a, b, z=z if has_z else None, c=c, acc=got_acc,
                    d=d)
    want = spmm_axpy_plain(csr, x, a, b, z=z if has_z else None, c=c,
                           acc=want_acc, d=d)
    torch.cuda.synchronize()
    return (got, got_acc), (want, want_acc)


def check_k5(dev: torch.device, csr) -> None:
    gen = torch.Generator(device=dev).manual_seed(5)
    n = csr.n_rows
    for d in (8, 136, 256, 300, 4096):
        x, z, acc = (torch.randn((n, d), device=dev, generator=gen)
                     for _ in range(3))
        for case in K5_CASES:
            got, want = k5_pair(csr, x, z, acc, case)
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
            log(f"K5 d={d} {case}: max |err| out {max_err(got[0], want[0]):.3e}"
                f", acc {max_err(got[1], want[1]):.3e}")


def duplicate_csr(n: int, seed: int):
    """Row-sorted CSR arrays with repeated (row, col) entries and an empty
    row (row 3, where there is one)."""
    rng = np.random.default_rng(seed)
    deg = rng.poisson(6, size=n) + 1
    if n > 3:
        deg[3] = 0
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    cols = rng.integers(0, n, size=int(indptr[-1]), dtype=np.int64)
    for r in range(0, n, 2):  # every other row repeats its first column
        if deg[r] > 1:
            cols[indptr[r] + 1] = cols[indptr[r]]
    vals = rng.random(int(indptr[-1])).astype(np.float32)
    return indptr, cols, vals


def check_dense_markov(csr) -> float:
    """K6 against its plain version on ``csr``; returns the largest error
    of P."""
    from cleora_tpu_torch.ops.dense import dense_markov, dense_markov_plain

    p, deg, vol = dense_markov(csr)
    p_plain, deg_plain, vol_plain = dense_markov_plain(csr)
    torch.cuda.synchronize()
    torch.testing.assert_close(p, p_plain, rtol=0.0, atol=1e-6)
    torch.testing.assert_close(deg, deg_plain, rtol=0.0, atol=1e-6)
    torch.testing.assert_close(vol, vol_plain, rtol=1e-6, atol=0.0)
    return max_err(p, p_plain)


def check_k6(dev: torch.device) -> None:
    from cleora_tpu_torch.ops.spmm import CsrMatrix

    for n in (1, 257, 4096):
        csr = CsrMatrix.from_numpy(*duplicate_csr(n, n), dev)
        err = check_dense_markov(csr)
        log(f"K6 n={n} ({csr.nnz} entries, duplicates, an empty row): "
            f"max |err| P {err:.3e}")


def grarep_mode():
    from cleora_tpu_torch.algorithms import _GRAREP_FLOOR, _GRAREP_OFFSET

    return _GRAREP_FLOOR, _GRAREP_OFFSET


def check_log_clip(x, r, c, floor: float, offset: float) -> float:
    """K7 against its plain version on copies of ``x``; returns the largest
    error."""
    from cleora_tpu_torch.ops.dense import log_clip, log_clip_plain

    got = log_clip(x.clone(), r, c, floor, offset)
    want = log_clip_plain(x.clone(), r, c, floor, offset)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0.0, atol=1e-6)
    return max_err(got, want)


def check_k7(dev: torch.device) -> None:
    gen = torch.Generator(device=dev).manual_seed(7)
    modes = {"netmf": (1.0, 0.0), "grarep": grarep_mode()}
    for n, m in ((4096, 4096), (1000, 300)):
        x = torch.rand((n, m), device=dev, generator=gen) * 4
        x[x < 1.0] = 0.0  # a transition power is mostly zeros
        r = torch.rand(n, device=dev, generator=gen) + 0.5
        c = torch.rand(m, device=dev, generator=gen) + 0.5
        for mode, (floor, offset) in modes.items():
            for scaled in (True, False):
                err = check_log_clip(x, r if scaled else None,
                                     c if scaled else None, floor, offset)
                log(f"K7 ({n}, {m}) {mode} scales={scaled}: max |err| "
                    f"{err:.3e}")


def random_graph(n_nodes: int, n_und_edges: int, seed: int,
                 cover: bool = False):
    """bench.py's synthetic_coo edge draw, as a SparseMatrix.  ``cover``
    makes node i the source of edge i, so that every node appears and the
    graph has exactly ``n_nodes`` entities."""
    import cleora_tpu_torch as ctt

    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, size=n_und_edges, dtype=np.int64)
    dst = rng.integers(0, n_nodes, size=n_und_edges, dtype=np.int64)
    if cover:
        src[:n_nodes] = np.arange(n_nodes)
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
    spectral_parity(dev, g, rows)


def spectral_parity(dev: torch.device, g, rows: np.ndarray) -> None:
    """The spectral siblings on the card against device="cpu"."""
    import cleora_tpu_torch.algorithms as alg

    cpu = torch.device("cpu")
    a = alg._prone_chebyshev_core(g, DIM, 0.2, 0.5, 0, dev).cpu().numpy()
    b = alg._prone_chebyshev_core(g, DIM, 0.2, 0.5, 0, cpu).numpy()
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    log(f"parity _prone_chebyshev_core: max |err| {np.abs(a - b).max():.3e}")
    R = np.random.default_rng(0).standard_normal((g.num_entities, DIM))
    w = [1.0 / 2**i for i in range(ITERATIONS + 1)]
    a = alg._device_spmm_weighted_sum(g, R, w, True, dev)
    b = alg._device_spmm_weighted_sum(g, R, w, True, cpu)
    np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    log(f"parity _device_spmm_weighted_sum ({ITERATIONS} it): max |err| "
        f"{np.abs(a - b).max():.3e}")
    kw = dict(feature_dim=32, backend="device")
    a = alg.embed_hope(g, device=dev, **kw)
    b = alg.embed_hope(g, device=cpu, **kw)
    err, scale = gram_err(a, b, rows)
    log(f"parity embed_hope Gram ({PARITY_SAMPLE} rows): max |err| {err:.3e} "
        f"of max |G| {scale:.3e}")
    assert np.isfinite(a).all() and err <= 5e-3, err

    small = random_graph(SMALL_PARITY_NODES, SMALL_PARITY_EDGES, seed=4)
    every = np.arange(small.num_entities)
    for name in ("netmf", "grarep"):
        fn = getattr(alg, f"embed_{name}")
        for block_rows in (None, 256):
            kw = dict(feature_dim=DIM, backend="device",
                      block_rows=block_rows)
            a = fn(small, device=dev, **kw)
            b = fn(small, device=cpu, **kw)
            err, scale = gram_err(a, b, every)
            log(f"parity embed_{name} block_rows={block_rows} Gram "
                f"({small.num_entities} rows): max |err| {err:.3e} of max "
                f"|G| {scale:.3e}")
            assert np.isfinite(a).all() and err <= 5e-3, err


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


def kernel_row(name, source, replaces, ms, plain_ms, lib_ms, err, nbytes,
               flops, launches) -> dict:
    """One entry of the kernels line; the bound is the larger of the bytes
    (each input read once, each output written once) over the memory rate
    and the flops over the float32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib_ms,
    }


def full_width(dev: torch.device, card: str) -> tuple:
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
    none = dict.fromkeys(launches, 0)
    assert launches == none | {
        "spmm_csr": ITERATIONS, "row_normalize": ITERATIONS,
        "hash_init": 1}, launches
    check_covariance(out, dev)
    del out

    # ---- the attention path, through the user's entry point
    att_out, att_launches = run_main_path(
        "embed_with_attention()", lambda: ctt.embed_with_attention(
            g, feature_dim=DIM, num_iterations=ITERATIONS, whiten=True))
    assert att_launches == none | {
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

    return [
        kernel_row("spmm_csr", "cleora_tpu_torch/kernels/spmm_csr.cu",
                   "cleora_tpu/ops/spmm_ell.py:437", k1_ms, k1_plain_ms,
                   k1_lib_ms, k1_err, k1_bytes, k1_flops,
                   launches["spmm_csr"]),
        kernel_row("row_normalize",
                   "cleora_tpu_torch/kernels/row_normalize.cu",
                   "cleora_tpu/ops/normalize.py:15", k2_ms, k2_plain_ms,
                   k2_lib_ms, k2_err, k2_bytes, k2_flops,
                   launches["row_normalize"]),
        # no single PyTorch call computes K3's or K4's function
        kernel_row("hash_init", "cleora_tpu_torch/kernels/hash_init.cu",
                   "cleora_tpu/ops/init.py:60", k3_ms, k3_plain_ms, None, 0.0,
                   k3_bytes, k3_flops, launches["hash_init"]),
        kernel_row("edge_attention",
                   "cleora_tpu_torch/kernels/edge_attention.cu",
                   "cleora_tpu/__init__.py:502", k4_ms, k4_plain_ms, None,
                   k4_err, k4_bytes, k4_flops,
                   att_launches["edge_attention"]),
    ], g


@contextlib.contextmanager
def stopwatch(*targets):
    """Wall seconds spent inside each ``(owner, name)`` function while the
    block runs (the device is synchronised around every call); yields the
    dict that collects them."""
    seconds = {}
    saved = []

    def timed(real, key):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*args, **kwargs)
            torch.cuda.synchronize()
            seconds[key] = seconds.get(key, 0.0) + time.perf_counter() - t0
            return out
        return call

    for owner, name in targets:
        real = getattr(owner, name)
        saved.append((owner, name, real))
        setattr(owner, name, timed(real, name))
    try:
        yield seconds
    finally:
        for owner, name, real in saved:
            setattr(owner, name, real)


def run_spectral(name: str, call, expected=None) -> dict:
    """One spectral entry point as a main path, called as a user calls it
    (nothing wrapped, no synchronisation inside): launch counts asserted
    (kernels not named in ``expected`` must not launch; None leaves the
    assertion to the caller), output finite with unit rows (an all-zero
    row of the factorised matrix stays zero)."""
    from cleora_tpu_torch import kernels

    out, launches = run_main_path(name, call)
    if expected is not None:
        want = dict.fromkeys(kernels.LAUNCHES, 0) | expected
        assert launches == want, (launches, want)
    assert out.dtype == np.float32 and np.isfinite(out).all()
    norms = np.linalg.norm(out, axis=1)
    zero = norms < 1e-6
    assert np.all((np.abs(norms - 1.0) <= 1e-3) | zero), (norms.min(),
                                                          norms.max())
    assert zero.mean() <= 0.01, zero.mean()
    log(f"  {name}: output {out.shape}, unit rows ({int(zero.sum())} zero "
        "rows)")
    return launches


def stage_split(name: str, call, *targets) -> None:
    """A second run of ``call`` with ``targets`` under the stopwatch.  The
    forced synchronisations serialise host and device, so its total is not
    the entry point's time: run_spectral's is."""
    with stopwatch(*targets) as stages:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    log(f"  {name}: second run under the stopwatch {wall_s:.3f} s; seconds "
        "by stage " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))


def staged_spectral(name: str, call, expected, *targets) -> dict:
    """One run of a spectral entry point with ``targets`` under the
    stopwatch: launch counts, peak memory and the end-to-end seconds of
    that run (the stopwatch's synchronisations included), and the seconds
    by stage."""
    with stopwatch(*targets) as stages:
        launches = run_spectral(name, call, expected)
    log(f"  {name}: seconds by stage " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items()))
    return launches


def check_blocked_block(alg, graph, dev: torch.device) -> dict:
    """The kernels of the blocked NetMF and GraRep paths against their
    plain versions at the shapes and on the states those paths give them:
    the first row block of ``graph``, walked step by step as
    algorithms.py's block bodies walk it, each kernel call beside its plain
    version on the same input.  Returns the largest error of each kernel."""
    from cleora_tpu_torch.ops.spmm import (
        spmm,
        spmm_axpy,
        spmm_axpy_plain,
        spmm_plain,
    )

    rows, cols, vals, n = alg._coo_f32(graph)
    csr_pt, deg, vol = alg._pt_csr(rows, cols, vals, n, dev)
    defaults = inspect.signature(alg.embed_netmf).parameters
    window = defaults["window_size"].default
    neg = defaults["negative_samples"].default
    b, max_step = BLOCK_ROWS, GRAREP_STEPS
    deg_dev = torch.from_numpy(deg).to(dev)
    scale = np.float32(vol / (neg * window))
    s_col = (float(scale) / deg_dev)[:b].contiguous()
    errs = {"spmm_axpy": 0.0, "spmm_csr": 0.0, "log_clip": 0.0}
    tol = {"rtol": 1e-5, "atol": 1e-6}

    # NetMF's block: `window` K5 steps that sum the walk, then K7
    y = alg._one_hot_block(n, b, 0, dev)
    acc = torch.zeros_like(y)
    for _ in range(window):
        want_acc = acc.clone()
        want = spmm_axpy_plain(csr_pt, y, 1.0, acc=want_acc, d=1.0)
        got = spmm_axpy(csr_pt, y, 1.0, acc=acc, d=1.0)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **tol)
        torch.testing.assert_close(acc, want_acc, **tol)
        errs["spmm_axpy"] = max(errs["spmm_axpy"], max_err(got, want),
                                max_err(acc, want_acc))
        y = got
        del want, want_acc, got
    errs["log_clip"] = check_log_clip(acc, deg_dev, s_col, 1.0, 0.0)
    del acc

    # GraRep's block: K1 per power, K7 on a copy of each
    y = alg._one_hot_block(n, b, 0, dev)
    for _ in range(max_step):
        want = spmm_plain(csr_pt, y)
        got = spmm(csr_pt, y)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **tol)
        errs["spmm_csr"] = max(errs["spmm_csr"], max_err(got, want))
        y = got
        del want, got
        errs["log_clip"] = max(errs["log_clip"],
                               check_log_clip(y, None, None, *grarep_mode()))
    log(f"  one row block of the blocked paths, ({n}, {b}) on the "
        f"{csr_pt.nnz}-entry transposed transition CSR, each step against "
        f"its plain version: K5 ({window} NetMF walk steps) max |err| "
        f"{errs['spmm_axpy']:.3e}, K1 ({max_step} GraRep powers) "
        f"{errs['spmm_csr']:.3e}, K7 (NetMF's mode on the summed walk, "
        f"GraRep's on each power) {errs['log_clip']:.3e}")
    return errs


def spectral_full_width(dev: torch.device, card: str, g) -> list:
    """Phase 6: the five spectral siblings through their entry points, then
    K5, K6 and K7 at full size against their plain versions and timed."""
    import cleora_tpu_torch.algorithms as alg
    from cleora_tpu_torch.ops import memory
    from cleora_tpu_torch.ops.dense import (
        dense_markov,
        dense_markov_plain,
        log_clip,
        log_clip_plain,
    )
    from cleora_tpu_torch.ops.spmm import (
        CsrMatrix,
        spmm_axpy,
        spmm_axpy_plain,
    )

    n, nnz = g.num_entities, g.num_edges
    log(f"phase 6, sparse siblings on {n} entities, {nnz} nnz")

    def randne():
        return alg.embed_randne(g, feature_dim=DIM, num_iterations=ITERATIONS,
                                backend="device")

    def prone():
        return alg.embed_prone(g, feature_dim=DIM, backend="device")

    def hope():
        return alg.embed_hope(g, feature_dim=DIM, backend="device")

    # one run each, under the stopwatch: on the card its synchronisations
    # cost less than the spread between runs, and ProNE's host SVD alone
    # takes most of a minute
    staged_spectral("embed_randne()", randne, {"spmm_axpy": ITERATIONS},
                    (alg, "_device_weighted_sum_core"), (alg, "_fetch_f64"),
                    (alg, "_finalize"))
    prone_launches = staged_spectral(
        "embed_prone()", prone, {"spmm_axpy": 9},
        (alg, "_prone_chebyshev_core"), (alg, "_fetch_f64"),
        (alg, "_svd_sqrt"), (alg, "_finalize"))

    # HOPE's launch count follows from the series length its code derives:
    # 6 Katz applications (power_iters=2), each `terms` launches, read where
    # the code passes it on
    seen = {}
    real_katz = alg._katz

    def katz(csr, x, beta, terms):
        seen["terms"] = terms
        return real_katz(csr, x, beta, terms)

    alg._katz = katz
    try:
        hope_launches = staged_spectral(
            "embed_hope()", hope, None, (alg, "_katz"), (torch.linalg, "qr"),
            (torch.linalg, "svd"), (alg, "_fetch_f64"), (alg, "_finalize"))
    finally:
        alg._katz = real_katz
    log(f"  embed_hope(): k={DIM // 2}, r={DIM // 2 + 8}, "
        f"terms={seen['terms']}")
    assert seen["terms"] in (12, 13), seen
    assert hope_launches == dict.fromkeys(hope_launches, 0) | {
        "spmm_axpy": 6 * seen["terms"]}, hope_launches

    # ---- K5 at the sparse siblings' shape: error, times, bound
    rows, cols, vals, _, _ = g.to_sparse_csr()
    csr = CsrMatrix.from_coo(
        rows, cols, alg._sym_normalized_vals(rows, cols, vals, n), n, dev)
    del rows, cols, vals
    gen = torch.Generator(device=dev).manual_seed(6)
    x, z, acc = (torch.randn((n, DIM), device=dev, generator=gen)
                 for _ in range(3))
    k5_err = 0.0
    for case in K5_CASES:
        got, want = k5_pair(csr, x, z, acc, case)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
            k5_err = max(k5_err, max_err(a, b))
        del got, want, a, b
    ca, cb, cc, cd = K5_CASES["chebyshev"][:4]
    k5_ms = time_ms(lambda: spmm_axpy(csr, x, ca, cb, z=z, c=cc, acc=acc,
                                      d=cd))
    k5_plain_ms = time_ms(lambda: spmm_axpy_plain(csr, x, ca, cb, z=z, c=cc,
                                                  acc=acc, d=cd),
                          reps=3, warmup=1)
    k5_randne_ms = time_ms(lambda: spmm_axpy(csr, x, 1.0, acc=acc, d=0.25))
    k5_bare_ms = time_ms(lambda: spmm_axpy(csr, x, -1.0, 1.0))
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore", UserWarning)
        a_lib = torch.sparse_csr_tensor(csr.indptr.int(), csr.indices,
                                        csr.vals, size=(n, n),
                                        check_invariants=False)

        def k5_library():
            out = torch.sparse.mm(a_lib, x).mul_(ca)
            out.add_(x, alpha=cb).add_(z, alpha=cc)
            acc.add_(out, alpha=cd)
            return out

        k5_lib_ms = time_ms(k5_library)
    x136, acc136 = (torch.randn((n, 136), device=dev, generator=gen)
                    for _ in range(2))
    got, want = k5_pair(csr, x136, None, acc136, "katz")
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        k5_err = max(k5_err, max_err(a, b))
    del got, want, a, b
    k5_katz_ms = time_ms(lambda: spmm_axpy(csr, x136, 0.1, acc=acc136, d=1.0))
    del a_lib, x136, acc136
    # x, z and out move once, acc is read and written
    k5_bytes = 8 * (n + 1) + 8 * nnz + 3 * 4 * n * DIM + 8 * n * DIM
    k5_flops = 2 * nnz * DIM + 7 * n * DIM
    log(f"K5 D={DIM}: Chebyshev step (z, acc) {k5_ms:.3f} ms (plain "
        f"{k5_plain_ms:.3f}, torch.sparse.mm + 4 elementwise calls "
        f"{k5_lib_ms:.3f}); RandNE step (acc) {k5_randne_ms:.3f} ms; "
        f"x - N x alone {k5_bare_ms:.3f} ms; Katz step at D=136 "
        f"{k5_katz_ms:.3f} ms; max |err| {k5_err:.3e}; [{card}]")
    del csr, x, z, acc
    torch.cuda.empty_cache()

    # ---- the dense two
    t0 = time.perf_counter()
    gd = random_graph(DENSE_NODES, DENSE_UND_EDGES, seed=11, cover=True)
    nd, nnzd = gd.num_entities, gd.num_edges
    assert nd == DENSE_NODES
    log(f"phase 6, dense siblings on {nd} entities, {nnzd} nnz (ingest "
        f"{time.perf_counter() - t0:.3f} s); six (n, n) float32 buffers = "
        f"{6 * 4 * nd * nd / 1e9:.1f} GB")
    limit = memory.device_memory_limit(dev)
    gate_rows = int(np.sqrt(0.9 * limit / (6 * 4)))
    assert alg._dense_fits(gate_rows, device=dev)
    assert not alg._dense_fits(int(gate_rows * 1.01) + 1, device=dev)
    log(f"  dense gate on this card: {limit / 2**30:.3f} GiB free -> the "
        f"dense path takes n <= {gate_rows}; past it block_rows is "
        f"{alg._auto_block_rows(BLOCKED_NODES, DIM + 10, device=dev)} at "
        f"n={BLOCKED_NODES}; [{card}]")
    dense_targets = ((alg, "dense_markov"), (torch, "matmul"),
                     (alg, "log_clip"), (torch.linalg, "qr"),
                     (torch.linalg, "svd"), (alg, "_fetch_f64"))

    def netmf_dense():
        return alg.embed_netmf(gd, feature_dim=DIM, backend="device")

    def grarep_dense():
        return alg.embed_grarep(gd, feature_dim=DIM, max_step=GRAREP_STEPS,
                                backend="device")

    netmf = run_spectral("embed_netmf() dense", netmf_dense,
                         {"dense_markov": 1, "log_clip": 1})
    stage_split("embed_netmf() dense", netmf_dense, *dense_targets)
    run_spectral("embed_grarep() dense", grarep_dense,
                 {"dense_markov": 1, "log_clip": GRAREP_STEPS})
    stage_split("embed_grarep() dense", grarep_dense, *dense_targets)

    # ---- K6 and K7 at the dense siblings' shape
    rows, cols, vals, _ = alg._coo_f32(gd)
    csrd = CsrMatrix.from_coo(rows, cols, vals, nd, dev)
    k6_err = check_dense_markov(csrd)
    k6_ms = time_ms(lambda: dense_markov(csrd))
    k6_plain_ms = time_ms(lambda: dense_markov_plain(csrd), reps=3, warmup=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        a_lib = torch.sparse_csr_tensor(csrd.indptr.int(), csrd.indices,
                                        csrd.vals, size=(nd, nd),
                                        check_invariants=False)

        def k6_library():
            p = a_lib.to_dense()
            return p.div_(p.sum(dim=1).clamp_min_(1e-10)[:, None])

        torch.testing.assert_close(k6_library(), dense_markov(csrd)[0],
                                   rtol=0.0, atol=1e-6)
        k6_lib_ms = time_ms(k6_library)
    del a_lib
    k6_bytes = 8 * (nd + 1) + 8 * nnzd + 4 * nd * nd + 4 * nd + 8
    k6_flops = 2 * nnzd
    log(f"K6 n={nd}: {k6_ms:.3f} ms (plain {k6_plain_ms:.3f}, to_dense + row "
        f"divide {k6_lib_ms:.3f}); max |err| {k6_err:.3e}; [{card}]")

    p, deg, vol = dense_markov(csrd)
    xk7 = torch.matmul(p, p)  # a transition power, as the entry points clip
    row_scale = (vol.float() / 5.0) / deg
    k7_err = max(
        check_log_clip(xk7, row_scale, deg, 1.0, 0.0),
        check_log_clip(xk7, None, None, *grarep_mode()))
    del p
    k7_ms = time_ms(lambda: log_clip(xk7, row_scale, deg, 1.0, 0.0))
    k7_grarep_ms = time_ms(lambda: log_clip(xk7, None, None, *grarep_mode()))
    k7_plain_ms = time_ms(
        lambda: log_clip_plain(xk7, row_scale, deg, 1.0, 0.0))
    k7_lib_ms = time_ms(lambda: torch.log(torch.clamp_min(
        xk7 * row_scale[:, None] * deg[None, :], 1.0)))
    k7_bytes = 2 * 4 * nd * nd + 4 * 2 * nd
    k7_flops = 5 * nd * nd
    log(f"K7 ({nd}, {nd}): NetMF mode {k7_ms:.3f} ms (plain "
        f"{k7_plain_ms:.3f}, torch.log(clamp_min(x*r*c)) {k7_lib_ms:.3f}); "
        f"GraRep mode {k7_grarep_ms:.3f} ms; max |err| {k7_err:.3e}; "
        f"[{card}]")
    del xk7, csrd, gd
    torch.cuda.empty_cache()

    # ---- the blocked paths
    t0 = time.perf_counter()
    gb = random_graph(BLOCKED_NODES, BLOCKED_UND_EDGES, seed=12, cover=True)
    nb = gb.num_entities
    blocks = -(-nb // BLOCK_ROWS)
    sweeps = 2 + 2 * 1  # power_iters=1
    log(f"phase 6, blocked paths on {nb} entities, {gb.num_edges} nnz "
        f"(ingest {time.perf_counter() - t0:.3f} s): block_rows={BLOCK_ROWS},"
        f" {blocks} blocks, {sweeps} sweeps")
    blocked_targets = ((alg, "spmm_axpy"), (alg, "spmm"), (alg, "log_clip"),
                       (torch, "matmul"), (torch.linalg, "qr"),
                       (torch.linalg, "svd"), (alg, "_fetch_f64"))

    def netmf_blocked():
        return alg.embed_netmf(gb, feature_dim=DIM, backend="device",
                               block_rows=BLOCK_ROWS, power_iters=1)

    def grarep_blocked():
        return alg.embed_grarep(gb, feature_dim=DIM, max_step=GRAREP_STEPS,
                                backend="device", block_rows=BLOCK_ROWS,
                                power_iters=1)

    blocked_errs = check_blocked_block(alg, gb, dev)
    torch.cuda.empty_cache()
    run_spectral("embed_netmf() blocked", netmf_blocked,
                 {"spmm_axpy": blocks * sweeps * 5,
                  "log_clip": blocks * sweeps})
    stage_split("embed_netmf() blocked", netmf_blocked, *blocked_targets)
    run_spectral("embed_grarep() blocked", grarep_blocked,
                 {"spmm_csr": blocks * sweeps * GRAREP_STEPS,
                  "log_clip": blocks * sweeps * GRAREP_STEPS})
    stage_split("embed_grarep() blocked", grarep_blocked, *blocked_targets)
    k5_err = max(k5_err, blocked_errs["spmm_axpy"])
    k7_err = max(k7_err, blocked_errs["log_clip"])

    src = "cleora_tpu_torch/kernels/"
    return [
        kernel_row("spmm_axpy", src + "spmm_axpy.cu",
                   "cleora_tpu/algorithms.py:186", k5_ms, k5_plain_ms,
                   k5_lib_ms, k5_err, k5_bytes, k5_flops,
                   prone_launches["spmm_axpy"]),
        kernel_row("dense_markov", src + "dense_markov.cu",
                   "cleora_tpu/algorithms.py:397", k6_ms, k6_plain_ms,
                   k6_lib_ms, k6_err, k6_bytes, k6_flops,
                   netmf["dense_markov"]),
        kernel_row("log_clip", src + "log_clip.cu",
                   "cleora_tpu/algorithms.py:429", k7_ms, k7_plain_ms,
                   k7_lib_ms, k7_err, k7_bytes, k7_flops, netmf["log_clip"]),
    ]


# ------------------------------------------------------ phase 7: DeepWalk
def planted_edges(n, communities, deg_in, deg_out, rng):
    """scripts/walk_quality_probe.py's planted-partition generator (a copy:
    the script imports nothing of the JAX package)."""
    size = -(-n // communities)
    comm = np.arange(n) // size
    m_in = n * deg_in
    src_in = rng.integers(0, n, m_in)
    dst_in = np.minimum(
        comm[src_in] * size + rng.integers(0, size, m_in), n - 1)
    m_out = n * deg_out
    src_out = rng.integers(0, n, m_out)
    dst_out = rng.integers(0, n, m_out)
    return (np.concatenate([src_in, src_out]),
            np.concatenate([dst_in, dst_out]), comm)


def centroid_accuracy(emb, labels, rng, train_frac=0.5):
    """scripts/walk_quality_probe.py's nearest-centroid accuracy."""
    n = emb.shape[0]
    normed = emb / np.maximum(
        np.linalg.norm(emb, axis=1, keepdims=True), 1e-10)
    perm = rng.permutation(n)
    tr, te = perm[: int(n * train_frac)], perm[int(n * train_frac):]
    k = labels.max() + 1
    cents = np.zeros((k, emb.shape[1]), dtype=np.float64)
    for c in range(k):
        rows = tr[labels[tr] == c]
        if rows.size:
            cents[c] = normed[rows].mean(axis=0)
    cents /= np.maximum(np.linalg.norm(cents, axis=1, keepdims=True), 1e-10)
    pred = np.argmax(normed[te] @ cents.T, axis=1)
    return float(np.mean(pred == labels[te]))


def merge_plain(a, b, n: int):
    """ops/cooccur.py:_merge with K10's plain version."""
    from cleora_tpu_torch.ops.cooccur import run_length_plain

    keys = torch.cat([a[0].long() * n + a[1], b[0].long() * n + b[1]])
    keys, order = torch.sort(keys)
    cen, ctx, cnt, _ = run_length_plain(keys, torch.cat([a[2], b[2]])[order],
                                        n, 1)
    return cen, ctx, cnt, int(cen.shape[0])


def partition(r, s: int):
    """Partition ``s``'s segment of a sweep reduce's (cen, ctx, cnt, m_per)."""
    start = sum(r[3][:s])
    end = start + r[3][s]
    return r[0][start:end], r[1][start:end], r[2][start:end], end - start


def walk_kernels_vs_plain(g, dev: torch.device, passes: int, label: str):
    """K8, K9 and K10 against their plain versions on ``g``'s first walk
    batch at the main path's batch size (K10 after the sweep and after a
    merge of the batch's two halves' partition 0).  Returns the tensors
    the timings reuse."""
    import cleora_tpu_torch.algorithms as alg
    from cleora_tpu_torch.ops import cooccur
    from cleora_tpu_torch.ops.walk import (
        WalkTables,
        walk_uniform,
        walk_uniform_plain,
    )

    indptr, cols, deg, n = alg._walk_csr(g)
    tables = WalkTables(indptr, cols, deg, n, dev)
    starts = np.tile(np.nonzero(deg > 0)[0].astype(np.int32), WALKS_PER_NODE)
    starts = torch.from_numpy(starts[:alg._WALK_BATCH // 2]).to(dev)
    b = starts.shape[0]
    args = (tables.indptr, tables.cols, tables.deg, starts, WALK_LENGTH, 0, 0,
            n)
    walks = walk_uniform(*args)
    assert torch.equal(walks, walk_uniform_plain(*args))
    keys = cooccur.pair_keys(walks, b, n, WINDOW, passes)
    assert torch.equal(keys, cooccur.pair_keys_plain(walks, b, n, WINDOW,
                                                     passes))
    sorted_keys = torch.sort(keys).values
    del keys
    got = cooccur.run_length(sorted_keys, None, n, passes)
    want = cooccur.run_length_plain(sorted_keys, None, n, passes)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    del want
    h = b // 2
    halves = [cooccur._reduce_sweep(walks[lo:hi], 0, n, WINDOW, passes)
              for lo, hi in ((0, h), (h, b))]
    a0, b0 = (partition(r, 0) for r in halves)
    merged = cooccur._merge(a0, b0, n)
    plain = merge_plain(a0, b0, n)
    assert all(torch.equal(x, y) for x, y in zip(merged[:3], plain[:3]))
    torch.cuda.synchronize()
    log(f"{label}: K8 walks ({b}, {WALK_LENGTH}), K9 keys "
        f"({sorted_keys.shape[0]}), K10 runs ({got[0].shape[0]}, {passes} "
        f"partitions) and K10 after a merge ({a0[3]} + {b0[3]} -> "
        f"{merged[3]} runs) bitwise equal to their plain versions")
    return tables, args, walks, sorted_keys, got


def ppmi_vs_plain(ranges, n: int, dev: torch.device, label: str):
    """K11's two passes against their plain versions on every range;
    returns the column sums, the total and the largest absolute error."""
    from cleora_tpu_torch.ops import cooccur

    zeros = lambda: (torch.zeros(n, dtype=torch.int64, device=dev),
                     torch.zeros(1, dtype=torch.int64, device=dev))
    col, total = zeros()
    col_p, total_p = zeros()
    for _, ctx, cnt, _ in ranges:
        cooccur.ppmi_colsum_(ctx, cnt, col, total)
        cooccur.ppmi_colsum_plain(ctx, cnt, col_p, total_p)
    torch.cuda.synchronize()
    assert torch.equal(col, col_p) and torch.equal(total, total_p)
    rel = err = 0.0
    for cen, ctx, cnt, _ in ranges:
        vals, indptr = cooccur.ppmi_values(cen, ctx, cnt, col, total, n)
        want, want_indptr = cooccur.ppmi_values_plain(cen, ctx, cnt, col,
                                                      total, n)
        torch.cuda.synchronize()
        assert torch.equal(indptr, want_indptr)
        torch.testing.assert_close(vals, want, rtol=1e-6, atol=0.0)
        err = max(err, max_err(vals, want))
        big = want != 0
        if bool(big.any()):
            rel = max(rel, float(((vals[big] - want[big]).abs()
                                  / want[big].abs()).max()))
        assert torch.equal(vals[~big], want[~big])
    log(f"{label}: K11 column sums and total bitwise, row pointers bitwise, "
        f"values max |err| {err:.3e}, max relative err {rel:.3e} over "
        f"{len(ranges)} ranges")
    return col, total, err


def ring_graph(n_nodes: int, n_und_edges: int, seed: int):
    """A ring through every node plus uniformly drawn edges, as a
    SparseMatrix: connected, so that no node sits in a small component.
    A small component's rows of the PPMI matrix lie outside the top-k
    singular subspace of the large one, so their factor rows are rounding
    noise that the finalize scales to unit length, on any backend: no
    comparison can hold them."""
    import cleora_tpu_torch as ctt

    rng = np.random.default_rng(seed)
    m = n_und_edges - n_nodes
    src = np.concatenate([np.arange(n_nodes), rng.integers(0, n_nodes, m)])
    dst = np.concatenate([(np.arange(n_nodes) + 1) % n_nodes,
                          rng.integers(0, n_nodes, m)])
    return ctt.SparseMatrix.from_edge_arrays(src, dst)


def walk_parity(dev: torch.device) -> None:
    """The card against device="cpu" on a connected 20,000-node graph:
    walks and counts bitwise, embeddings by their Gram matrix."""
    import cleora_tpu_torch.algorithms as alg
    from cleora_tpu_torch.ops import cooccur

    g = ring_graph(PARITY_NODES, PARITY_EDGES, seed=3)
    n = g.num_entities
    cpu = torch.device("cpu")
    walk_kernels_vs_plain(g, dev, WALK_PARITY_PASSES, "phase 7 parity size")

    def walks(d):
        return np.concatenate(list(alg._device_walks(
            g, WALKS_PER_NODE, WALK_PARITY_LENGTH, 0, device=d)))

    wa, wb = walks(dev), walks(cpu)
    assert np.array_equal(wa, wb)

    def counts(d):
        return cooccur.device_pair_counts(
            lambda: alg._device_walks(g, WALKS_PER_NODE, WALK_PARITY_LENGTH,
                                      0, batch=alg._WALK_BATCH // 2,
                                      resident=True, device=d),
            n, WINDOW, passes=WALK_PARITY_PASSES, device=d)

    (ra, ma), (rb, mb) = counts(dev), counts(cpu)
    assert ma == mb and len(ra) == len(rb) == WALK_PARITY_PASSES
    for x, y in zip(ra, rb):
        assert x[3] == y[3] and all(torch.equal(p.cpu(), q)
                                    for p, q in zip(x[:3], y[:3]))
    log(f"phase 7 parity ({n} nodes, {wa.shape[0]} walks of "
        f"{WALK_PARITY_LENGTH}): walks bitwise equal on the card and the "
        f"CPU; {ma} unique pairs in {WALK_PARITY_PASSES} partitions, ranges "
        "bitwise equal")
    ppmi_vs_plain(ra, n, dev, "phase 7 parity size")
    del ra, rb

    rows = np.random.default_rng(0).choice(n, PARITY_SAMPLE, replace=False)
    base = dict(feature_dim=WALK_PARITY_DIM, num_walks=WALKS_PER_NODE,
                walk_length=WALK_PARITY_LENGTH, window_size=WINDOW,
                backend="device")
    for kw in (dict(cooccurrence="device"),
               dict(cooccurrence="host", factorization="device"),
               dict(cooccurrence="host", factorization="host")):
        a = alg.embed_deepwalk(g, device=dev, **base, **kw)
        b = alg.embed_deepwalk(g, device=cpu, **base, **kw)
        err, scale = gram_err(a, b, rows)
        log(f"parity embed_deepwalk({kw}) Gram ({PARITY_SAMPLE} rows): max "
            f"|err| {err:.3e} of max |G| {scale:.3e}")
        assert np.isfinite(a).all() and err <= 1e-3, err


def walk_full_width(dev: torch.device, card: str) -> list:
    """Phase 7 at full width: embed_deepwalk through its entry point on
    scripts/deepwalk_e2e.py's corpus, its stages, K8-K11 at the main path's
    shapes, and the planted-partition quality check."""
    import cleora_tpu_torch.algorithms as alg
    import cleora_tpu_torch.ops.cooccur as cooccur
    import cleora_tpu_torch.ops.dense as dense
    import cleora_tpu_torch.ops.walk as walk

    t0 = time.perf_counter()
    g = random_graph(WALK_NODES, WALK_UND_EDGES, seed=7)
    ingest_s = time.perf_counter() - t0
    n = g.num_entities
    passes = alg._cooc_passes(g, WALKS_PER_NODE, WALK_LENGTH, WINDOW)
    deg = alg._walk_csr(g)[2]
    n_walks = int((deg > 0).sum()) * WALKS_PER_NODE
    batch = alg._WALK_BATCH // 2
    batches = -(-n_walks // batch)
    power_iters = inspect.signature(
        alg._device_counts_to_embeddings).parameters["power_iters"].default
    applies = 2 + 2 * power_iters
    log(f"phase 7, DeepWalk on {n} entities, {g.num_edges} nnz (ingest "
        f"{ingest_s:.3f} s): {n_walks} walks of {WALK_LENGTH} in {batches} "
        f"batches, window {WINDOW}, {passes} hash partitions, D={DIM}")

    def deepwalk():
        return alg.embed_deepwalk(
            g, feature_dim=DIM, num_walks=WALKS_PER_NODE,
            walk_length=WALK_LENGTH, window_size=WINDOW, backend="device",
            cooccurrence="device")

    expected = {"walk_uniform": batches, "pair_enum": batches,
                "run_length": batches + (batches - 1) * passes,
                "ppmi": passes, "spmm_csr": applies,
                "spmm_axpy": applies * (passes - 1)}
    launches = run_spectral("embed_deepwalk()", deepwalk, expected)
    targets = ((walk, "walk_uniform"), (cooccur, "pair_keys"),
               (torch, "sort"), (cooccur, "run_length"),
               (cooccur, "ppmi_colsum_"), (cooccur, "ppmi_values"),
               (dense, "spmm"), (dense, "spmm_axpy"), (torch.linalg, "qr"),
               (torch.linalg, "svd"), (alg, "_finalize_factor"))
    staged_spectral("embed_deepwalk() stopwatch run", deepwalk, expected,
                    *targets)
    torch.cuda.empty_cache()

    # ---- the counts alone: pairs, unique pairs, K11 at full size
    def batches_fn():
        return alg._device_walks(g, WALKS_PER_NODE, WALK_LENGTH, 0,
                                 batch=batch, resident=True, device=dev)

    t0 = time.perf_counter()
    ranges, m_total = cooccur.device_pair_counts(batches_fn, n, WINDOW,
                                                 passes=passes, device=dev)
    torch.cuda.synchronize()
    count_s = time.perf_counter() - t0
    pairs = cooccur.pair_total(ranges, n)
    log(f"  counting alone {count_s:.3f} s: {pairs} pairs -> {m_total} "
        f"unique ({m_total / JAX_UNIQUE_PAIRS - 1:+.4%} against the JAX "
        f"package's {JAX_UNIQUE_PAIRS} on this corpus shape); per partition "
        + ", ".join(str(r[3]) for r in ranges))
    assert abs(m_total / JAX_UNIQUE_PAIRS - 1) <= 0.01, m_total
    col, total, k11_err = ppmi_vs_plain(ranges, n, dev, "phase 7 full size")
    cen, ctx, cnt, m0 = ranges[0]
    k11_ms = time_ms(lambda: cooccur.ppmi_values(cen, ctx, cnt, col, total,
                                                 n))
    k11_plain_ms = time_ms(lambda: cooccur.ppmi_values_plain(
        cen, ctx, cnt, col, total, n), reps=3, warmup=1)
    k11_bytes = 12 * m0 + 8 * n + 8 + 4 * m0 + 8 * (n + 1)
    del ranges, cen, ctx, cnt, col, total
    torch.cuda.empty_cache()

    # ---- K8-K10 at the main path's batch, against plain, and timed
    tables, args, walks, sorted_keys, runs = walk_kernels_vs_plain(
        g, dev, passes, "phase 7 full size")
    b = walks.shape[0]
    k8_ms = time_ms(lambda: walk.walk_uniform(*args))
    k8_plain_ms = time_ms(lambda: walk.walk_uniform_plain(*args), reps=3,
                          warmup=1)
    # each hop reads deg of its node and, when it moves, indptr and cols:
    # one 32-byte sector per random read; walks written, starts read once
    reads = int((walks[:, :-1] < n).sum())
    moves = int((walks[:, 1:] < n).sum())
    k8_bytes = 32 * (reads + 2 * moves) + 4 * b * WALK_LENGTH + 4 * b
    k9_ms = time_ms(lambda: cooccur.pair_keys(walks, b, n, WINDOW, passes))
    k9_plain_ms = time_ms(lambda: cooccur.pair_keys_plain(
        walks, b, n, WINDOW, passes), reps=3, warmup=1)
    lanes = sorted_keys.shape[0]
    k9_bytes = 4 * b * WALK_LENGTH + 8 * lanes
    keys = cooccur.pair_keys(walks, b, n, WINDOW, passes)
    sort_ms = time_ms(lambda: torch.sort(keys), reps=5)
    del keys
    k10_ms = time_ms(lambda: cooccur.run_length(sorted_keys, None, n,
                                                passes))
    k10_plain_ms = time_ms(lambda: cooccur.run_length_plain(
        sorted_keys, None, n, passes), reps=3, warmup=1)
    k10_lib_ms = time_ms(lambda: torch.unique_consecutive(
        sorted_keys, return_counts=True))
    m = runs[0].shape[0]
    k10_bytes = 8 * lanes + 12 * m + 4 * passes
    log(f"K8 ({b} walks of {WALK_LENGTH}) {k8_ms:.3f} ms (plain "
        f"{k8_plain_ms:.3f}); K9 ({lanes} keys) {k9_ms:.3f} ms (plain "
        f"{k9_plain_ms:.3f}); torch.sort of the keys {sort_ms:.3f} ms; K10 "
        f"({m} runs) {k10_ms:.3f} ms (plain {k10_plain_ms:.3f}, "
        f"torch.unique_consecutive {k10_lib_ms:.3f}); K11 (range 0, {m0} "
        f"entries) {k11_ms:.3f} ms (plain {k11_plain_ms:.3f}); [{card}]")
    del tables, walks, sorted_keys, runs
    torch.cuda.empty_cache()

    # ---- quality: the planted partition of scripts/walk_quality_probe.py
    t0 = time.perf_counter()
    import cleora_tpu_torch as ctt

    src, dst, comm = planted_edges(QUALITY_NODES, QUALITY_COMMUNITIES,
                                   QUALITY_DEG_IN, QUALITY_DEG_OUT,
                                   np.random.default_rng(3))
    gq = ctt.SparseMatrix.from_edge_arrays(src, dst)
    labels = comm[np.array([int(e) for e in gq.entity_ids])]
    emb = alg.embed_deepwalk(gq, QUALITY_DIM, num_walks=WALKS_PER_NODE,
                             walk_length=QUALITY_WALK_LENGTH,
                             backend="device", cooccurrence="device")
    acc = centroid_accuracy(emb, labels, np.random.default_rng(1))
    log(f"quality: planted partition, {gq.num_entities} nodes, "
        f"{QUALITY_COMMUNITIES} communities, D={QUALITY_DIM}: centroid "
        f"accuracy {acc:.4f} ({time.perf_counter() - t0:.3f} s with ingest)")
    assert acc >= 0.99, acc

    src = "cleora_tpu_torch/kernels/"
    return [
        kernel_row("walk_uniform", src + "walk_uniform.cu",
                   "cleora_tpu/algorithms.py:1122", k8_ms, k8_plain_ms, None,
                   0.0, k8_bytes, 0, launches["walk_uniform"]),
        kernel_row("pair_enum", src + "pair_enum.cu",
                   "cleora_tpu/ops/cooccur.py:196", k9_ms, k9_plain_ms, None,
                   0.0, k9_bytes, 0, launches["pair_enum"]),
        kernel_row("run_length", src + "run_length.cu",
                   "cleora_tpu/ops/cooccur.py:46", k10_ms, k10_plain_ms,
                   k10_lib_ms, 0.0, k10_bytes, 0, launches["run_length"]),
        kernel_row("ppmi", src + "ppmi.cu", "cleora_tpu/ops/cooccur.py:939",
                   k11_ms, k11_plain_ms, None, k11_err, k11_bytes, 0,
                   launches["ppmi"]),
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
    walk_parity(dev)
    rows, graph = full_width(dev, card)
    rows += spectral_full_width(dev, card, graph)
    del graph
    rows += walk_full_width(dev, card)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
