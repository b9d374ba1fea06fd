"""Multi-card scaling efficiency of the sharded embed loop (the port of
cleora_tpu/scaling.py): edges/s at 1, 2, 4, … ranks up to the number of
cards, each rank one process on its own card (NCCL), gated against the
BASELINE.json target as a hard pass/fail.  Surfaced as
``python -m cleora_tpu_torch scaling``.

Efficiency (BASELINE.md): edges/s at N ranks divided by N × edges/s at one
rank, strong-scaled on a fixed graph (the same problem split N ways).
Each world size is its own set of processes, started here with torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``) and running ``parallel.build_sharded_embed``'s loop on
:func:`synthetic`.  With ``device="cpu"`` the ranks are gloo processes on
the CPU, at most :data:`CPU_MAX_RANKS` of them: a check of the harness,
whose numbers are no device's.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

TARGET_EFFICIENCY = 0.80  # BASELINE.json multi-host scaling target
CPU_MAX_RANKS = 2
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def synthetic(n_nodes, n_und, seed=7):
    """Row-sorted undirected COO with left-Markov values."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_nodes, n_und)
    dst = rng.integers(0, n_nodes, n_und)
    rows = np.concatenate([src, dst])
    cols = np.concatenate([dst, src])
    order = np.argsort(rows, kind="stable")
    rows, cols = rows[order], cols[order]
    deg = np.bincount(rows, minlength=n_nodes).astype(np.float64)
    vals = (1.0 / np.maximum(deg, 1.0))[rows].astype(np.float32)
    return rows, cols, vals


def _shape(smoke: bool, cpu: bool) -> dict:
    """The JAX package's shapes: small on the CPU or in smoke mode, else
    1 M nodes, 5.5 M undirected edges, 40 iterations at D=256."""
    small = cpu or smoke
    return dict(
        n_nodes=(20_000 if smoke else 100_000) if small else 1_000_000,
        n_und=(100_000 if smoke else 500_000) if small else 5_500_000,
        iters=(2 if smoke else 4) if small else 40,
        dim=64 if smoke else 256,
    )


def _rank_main(cfg: dict) -> None:
    """One rank of one world size: time the loop, rank 0 writes the
    result to ``cfg["out"]``."""
    import torch.distributed as dist

    from .parallel import build_sharded_embed, init_distributed, make_mesh
    from .parallel.shard import ShardedCsr, pad_rows

    cpu = cfg["device"] == "cpu"
    init_distributed(device="cpu" if cpu else None)
    mesh = make_mesh(device="cpu" if cpu else None)
    if cpu:  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // mesh.world_size))
    n, iters, dim = cfg["n_nodes"], cfg["iters"], cfg["dim"]
    rows, cols, vals = synthetic(n, cfg["n_und"])
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
    sharded = ShardedCsr(indptr, cols.astype(np.int32), vals, n,
                         mesh.world_size)
    fn, place = build_sharded_embed(mesh, sharded, dim, do_whiten=True)
    rps, k = sharded.rows_per_shard, mesh.rank
    x0 = np.random.default_rng(0).standard_normal((n, dim)).astype(
        np.float32)
    x = place(pad_rows(x0[k * rps:(k + 1) * rps], rps))
    del x0

    def run() -> float:
        mesh.barrier()
        t = time.perf_counter()
        out, _, _ = fn(x, iters)
        if not cpu:
            torch.cuda.synchronize()
        mesh.barrier()
        assert bool(torch.isfinite(out).all())
        return time.perf_counter() - t

    run()  # warm: kernel builds, allocator, communicators
    best = min(run() for _ in range(2))
    if mesh.rank == 0:
        with open(cfg["out"], "w") as f:
            json.dump({"seconds": best, "nnz": int(len(rows))}, f)
    if dist.is_initialized():
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_world(world: int, cfg: dict, timeout: float = 1800.0) -> dict:
    """Start ``world`` rank processes, wait for all of them, return rank
    0's result; kill every one of them if any fails."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "result.json")
        port = _free_port()
        procs = []
        try:
            for r in range(world):
                env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                           LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                           MASTER_ADDR="localhost", MASTER_PORT=str(port),
                           PYTHONPATH=_REPO + os.pathsep
                           + os.environ.get("PYTHONPATH", ""))
                if cfg["device"] == "cpu":
                    env["OMP_NUM_THREADS"] = "1"
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "cleora_tpu_torch.scaling",
                     "--rank", json.dumps(dict(cfg, out=out))],
                    env=env, cwd=_REPO, stdout=subprocess.PIPE,
                    stderr=subprocess.STDOUT, text=True))
            logs = [p.communicate(timeout=timeout)[0] for p in procs]
            for r, (p, log) in enumerate(zip(procs, logs)):
                if p.returncode != 0:
                    raise RuntimeError(
                        f"scaling rank {r} of {world} failed "
                        f"(exit {p.returncode}):\n{log}")
            with open(out) as f:
                return json.load(f)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)


def available_ranks(device=None) -> int:
    """Ranks the ladder may use: one per card, or CPU_MAX_RANKS gloo
    ranks on the CPU."""
    if str(device) == "cpu":
        return CPU_MAX_RANKS
    from ._util import resolve_device

    resolve_device(device)  # no card: raises, never falls back
    return torch.cuda.device_count()


def measure(smoke: bool = False, device=None):
    """Run the rank-count ladder; returns a list of {devices, edges_per_s,
    efficiency}."""
    cpu = str(device) == "cpu"
    cfg = dict(_shape(smoke, cpu), device="cpu" if cpu else "cuda")
    avail = available_ranks(device)
    results = []
    for nd in [c for c in (1, 2, 4, 8, 16, 32, 64) if c <= avail]:
        res = _run_world(nd, cfg)
        eps = res["nnz"] * cfg["iters"] / res["seconds"]
        base = results[0]["edges_per_s"] if results else eps
        eff = eps / (base * nd)
        results.append({"devices": nd, "edges_per_s": eps, "efficiency": eff})
        print(f"devices={nd:3d}  {eps/1e6:9.1f} M edges/s  "
              f"scaling efficiency {eff:6.1%}", flush=True)
    return results


def run_report(smoke: bool = False, check: float | None = None,
               json_path: str | None = None, device=None) -> int:
    """Measure, print, optionally gate (exit code 2 on FAIL) and dump
    JSON."""
    cpu = str(device) == "cpu"
    results = measure(smoke=smoke, device=device)
    report = {
        "backend": "cpu" if cpu else "cuda",
        "device_kind": "cpu" if cpu else torch.cuda.get_device_name(0),
        "devices_available": available_ranks(device),
        "smoke": smoke,
        "target_efficiency": check if check is not None else TARGET_EFFICIENCY,
        "results": results,
    }
    rc = 0
    if check is not None:
        final = results[-1]
        passed = final["efficiency"] >= check
        report["pass"] = passed
        verdict = "PASS" if passed else "FAIL"
        print(f"{verdict}: efficiency {final['efficiency']:.1%} at "
              f"{final['devices']} devices (target >= {check:.0%})")
        if not passed:
            rc = 2
    if json_path:
        with open(json_path, "w") as f:
            json.dump(report, f, indent=1)
    return rc


if __name__ == "__main__" and len(sys.argv) == 3 and sys.argv[1] == "--rank":
    _rank_main(json.loads(sys.argv[2]))
