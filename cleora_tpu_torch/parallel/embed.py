"""The sharded embedding loop: one shard per process over torch.distributed.

The port of cleora_tpu/parallel/embed.py.  Rank k of the process group
owns rows [k·rps, (k+1)·rps) of the state on its own device (one card per
rank with NCCL, the CPU with gloo); without a group the calling process is
the only shard.  Each iteration, on every rank (:func:`_local_step`):

1. exchange: ``all_gather`` of the row shards into the full gather table,
   or the halo exchange — kernel K16 packs the rows each peer reads into
   a (P, M, D) slab and one ``all_to_all_single`` swaps the slabs;
2. kernel K1 over the shard's local CSR, whose column ids point into the
   gather table, with the residual mix taken from the shard's own state;
3. row normalization (kernel K2), or the spectral rescale with an
   all-reduced Gram matrix;
4. whitening with global statistics: the masked column sum and the D×D
   covariance are local full-float32 products, all-reduced, then one
   replicated ``torch.linalg.eigh`` and the projection product.

PyTorch runs eagerly, so the JAX package's single jitted shard_map becomes
a host loop over these launches and collectives.  Rows ≥ n_rows stay zero
through K1 and K2 and are left out of every statistic.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .._util import full_float32_matmul, to_host
from ..ops.halo import halo_pack
from ..ops.loop import effective_residual_weight
from ..ops.memory import check_device_fit
from ..ops.normalize import l1_normalize, l2_normalize
from ..ops.spmm import CsrMatrix, spmm
from . import state as lifecycle
from .mesh import ShardGroup, make_mesh
from .shard import (
    HaloPlan,
    ShardedCsr,
    pad_rows,
    plan_halo_distributed,
    shard_csr,
)

_HALO_NOT_PORTED = (
    'halo="{}" is not ported yet: the overlapped and hierarchical '
    "exchanges belong to the multi-GPU slice of the port (ROADMAP.md, "
    "queue A item 8); use halo=None, True or False"
)

# elements per pinned staging block of the host→device CSR upload
_STAGE_ELEMENTS = 1 << 24


def _to_device(view: np.ndarray, dtype: np.dtype, device: torch.device,
               n_cols: Optional[int] = None) -> torch.Tensor:
    """Copy a (memmapped) host array to ``device`` in blocks through one
    pinned staging buffer, so that the host never holds a second full
    copy.  With ``n_cols`` every value must lie in [0, n_cols)."""
    n = len(view)
    if device.type != "cuda":
        host = np.array(view, dtype=dtype)
        if n_cols is not None and n and (host.min() < 0
                                         or host.max() >= n_cols):
            raise ValueError("malformed CSR: column index out of range")
        return torch.from_numpy(host)
    out = torch.empty(n, dtype=getattr(torch, np.dtype(dtype).name),
                      device=device)
    stage = torch.empty(min(n, _STAGE_ELEMENTS), dtype=out.dtype,
                        pin_memory=True)
    staged = stage.numpy()
    for s in range(0, n, _STAGE_ELEMENTS):
        m = min(_STAGE_ELEMENTS, n - s)
        staged[:m] = view[s:s + m]
        if n_cols is not None and (staged[:m].min() < 0
                                   or staged[:m].max() >= n_cols):
            raise ValueError("malformed CSR: column index out of range")
        out[s:s + m].copy_(stage[:m], non_blocking=True)
        torch.cuda.current_stream(device).synchronize()  # stage is reused
    return out


def _local_csr(sharded: ShardedCsr, k: int, cols: np.ndarray, n_cols: int,
               device: torch.device) -> CsrMatrix:
    """Shard k's local CSR on ``device``: ``cols`` index the gather table
    of ``n_cols`` rows."""
    indptr = sharded.indptr(k)
    if (np.any(np.diff(indptr) < 0) or indptr[-1] != len(cols)
            or len(cols) != len(sharded.vals[k])):
        raise ValueError("malformed CSR: indptr/indices/vals disagree")
    return CsrMatrix(torch.from_numpy(indptr).to(device),
                     _to_device(cols, np.int32, device, n_cols),
                     _to_device(sharded.vals[k], np.float32, device))


def _propagate_local(x: torch.Tensor, csr: CsrMatrix, mesh: ShardGroup,
                     send_idx: Optional[torch.Tensor],
                     residual_weight: float) -> torch.Tensor:
    """Boundary-row exchange + local SpMM (K1) + residual mix, float32."""
    if send_idx is None:
        table = mesh.all_gather(x)  # (n_padded, D); x itself for one shard
    else:
        table = mesh.all_to_all(halo_pack(x, send_idx)).view(-1, x.shape[1])
    return spmm(csr, table, residual_weight,
                residual=None if table is x else x)


@full_float32_matmul()
def _local_step(x: torch.Tensor, csr: CsrMatrix, mesh: ShardGroup, *,
                send_idx: Optional[torch.Tensor], n_rows: int, n_real: int,
                residual_weight: float, normalization: str,
                do_whiten: bool) -> torch.Tensor:
    """One propagate → normalize → whiten step on this shard.  bf16 state
    is exchanged in bf16; everything after the gather computes in float32
    and the result is stored back at x's dtype.  ``n_real`` rows of the
    shard are real (a prefix: the pad rows are the last global rows)."""
    y = _propagate_local(x, csr, mesh, send_idx, residual_weight)
    if normalization == "l2":
        y = l2_normalize(y)
    elif normalization == "l1":
        y = l1_normalize(y)
    elif normalization == "spectral":
        yn = l2_normalize(y)
        yn[n_real:] = 0.0
        g = mesh.all_reduce_(torch.matmul(yn.T, yn))
        _, v = torch.linalg.eigh(g)
        # yn = u s vᵀ  ⇒  u s = yn v, columns by descending singular value
        y = torch.matmul(yn, v.flip(1))
    elif normalization != "none":
        raise ValueError(f"Unknown normalization method: {normalization}")

    if do_whiten and n_rows > 1:  # n <= 1: whitening returns x unchanged
        # the products run over the real rows only, with the shapes of
        # ops/whiten.py's, so one shard equals the single-device loop
        mean = mesh.all_reduce_(y[:n_real].sum(dim=0)) / n_rows
        real = y[:n_real] - mean
        cov = mesh.all_reduce_(torch.matmul(real.T, real)) / (n_rows - 1)
        w, v = torch.linalg.eigh(cov)
        scale = 1.0 / torch.sqrt(torch.clamp_min(w.flip(0), 1e-10))
        y = torch.zeros_like(y)
        torch.matmul(real, v.flip(1) * scale, out=y[:n_real])
    return y.to(x.dtype)


def _rmse(y: torch.Tensor, x: torch.Tensor, mesh: ShardGroup,
          nd: int) -> torch.Tensor:
    """sqrt(Σδ²/(n_rows·D)) over all shards, each step rounded to the
    storage dtype as in the single-device loop (ops/loop.py:rmse)."""
    diff = y - x
    total = torch.sum(diff * diff, dtype=torch.float32).reshape(1)
    total = mesh.all_reduce_(total).to(diff.dtype)
    count = torch.tensor(nd, dtype=diff.dtype, device=diff.device)
    return torch.sqrt(total / count)[0]


def build_sharded_embed(
    mesh: ShardGroup,
    sharded: ShardedCsr,
    feature_dim: int,
    residual_weight: float = 0.0,
    normalization: str = "l2",
    do_whiten: bool = False,
    convergence_threshold: float = 0.0,
    halo: Optional[HaloPlan] = None,
    dtype: str = "float32",
):
    """The loop of this process's shard, ready to run.

    Returns ``(fn, place)``: ``place(x)`` takes this shard's
    (rows_per_shard, D) rows (numpy or a tensor) and returns them on its
    device in the state dtype; ``fn(x, iterations,
    start_iter=0)`` runs up to ``iterations`` steps and returns ``(x,
    iterations_run, converged)``.  The RMSE check skips the GLOBAL
    iteration 0 (``start_iter`` + i), so a run cut into checkpoint
    segments stops where the same run in one piece would.  With a
    ``halo`` plan each step swaps only boundary rows (K16 +
    ``all_to_all_single``) instead of all-gathering the full table."""
    k = mesh.rank
    rps = sharded.rows_per_shard
    n_rows = sharded.n_rows
    lo, hi = lifecycle.shard_rows(mesh, n_rows, rps)
    if halo is not None:
        cols, n_cols = halo.remapped_cols[k], halo.table_rows
        if halo.send_idx.size and (halo.send_idx.min() < 0
                                   or halo.send_idx.max() >= rps):
            raise ValueError("malformed halo plan: send row out of range")
        send_idx = torch.from_numpy(
            np.ascontiguousarray(halo.send_idx[k])).to(mesh.device)
    else:
        cols, n_cols, send_idx = sharded.cols[k], rps * mesh.world_size, None
    separate_table = halo is not None or mesh.group is not None
    check_device_fit(rps + (n_cols if separate_table else 0),
                     int(feature_dim), sharded.nnz(k), dtype, mesh.device)
    csr = _local_csr(sharded, k, cols, n_cols, mesh.device)
    nd = n_rows * int(feature_dim)
    state_dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32

    def step(x):
        return _local_step(
            x, csr, mesh, send_idx=send_idx, n_rows=n_rows, n_real=hi - lo,
            residual_weight=float(residual_weight),
            normalization=normalization, do_whiten=bool(do_whiten))

    def fn(x, iterations: int, start_iter: int = 0):
        for i in range(int(iterations)):
            y = step(x)
            done = (convergence_threshold > 0 and start_iter + i > 0
                    and bool(_rmse(y, x, mesh, nd) < convergence_threshold))
            x = y
            if done:
                return x, i + 1, True
        return x, int(iterations), False

    def place(x):
        if x.shape[1] != feature_dim:
            raise ValueError(
                f"x has feature dim {x.shape[1]} but the loop was built for "
                f"feature_dim={feature_dim}"
            )
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(device=mesh.device, dtype=state_dtype)

    return fn, place


def embed_sharded(
    graph,
    feature_dim: int = 256,
    num_iterations: int = 40,
    propagation: str = "left",
    normalization: str = "l2",
    seed: int = 0,
    whiten: bool = True,
    residual_weight: float = 0.0,
    convergence_threshold: float = 0.0,
    mesh: Optional[ShardGroup] = None,
    n_devices: Optional[int] = None,
    initial_embeddings: Optional[np.ndarray] = None,
    halo=None,
    banded=None,
    ell=None,
    dtype: str = "float32",
    callback: Optional[Callable[[int, np.ndarray], None]] = None,
    out: str = "full",
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 10,
    device=None,
):
    """Multi-process embed(): the same semantics as ``embed``, sharded by
    rows over the process group (one shard per rank, :mod:`.mesh`), or
    one shard in this process without a group.  Every rank calls it with
    the same graph (a SparseMatrix, a DiskGraph, or with a group one
    rank's piece of a sharded build) and the same arguments.

    ``halo=None`` (auto) uses the boundary-row exchange with more than one
    shard whenever its gather table is smaller than the all-gathered full
    table; True/False force the choice (True with one shard exchanges the
    shard's rows with itself); ``"overlap"`` and ``"hier"`` are not
    ported.  ``banded`` and
    ``ell`` are the JAX package's layout choices and are accepted and
    ignored: the local CSR serves them.  ``dtype="bfloat16"`` stores and
    exchanges the state in bf16 (float32 compute).

    The hash init runs on each shard's device (K3).  ``out="full"``
    returns the complete matrix on every rank; ``"shards"`` this rank's
    row block as :class:`~.state.EmbeddingShards`; a path ending in
    ``.npy`` streams every rank's rows into one standard npy file and
    returns a read-only memmap.  ``checkpoint_dir`` saves the sharded
    state every ``checkpoint_every`` iterations (two-phase, per process);
    a call with the same parameters resumes from the last complete
    checkpoint, and runs exactly as many iterations as the call without
    it.  ``device=None`` means CUDA (each NCCL rank's own card).
    """
    from ..graph.stream import DiskGraph, shard_row_bounds

    if dtype not in ("float32", "bfloat16"):
        raise ValueError(
            f"Unknown dtype '{dtype}'. Use 'float32' or 'bfloat16'."
        )
    if out not in ("full", "shards") and not (
        isinstance(out, str) and out.endswith(".npy")
    ):
        raise ValueError(
            f"Unknown out {out!r}. Use 'full', 'shards', or a '.npy' path."
        )
    if callback is not None and (out != "full" or checkpoint_dir is not None):
        raise ValueError(
            "callback requires out='full' and no checkpoint_dir (the "
            "callback contract passes the full host matrix per iteration)"
        )
    # same reference-path semantics as embed (see ops/loop.py)
    residual_weight = effective_residual_weight(
        residual_weight,
        rust_fast_semantics=(initial_embeddings is None and callback is None
                             and normalization == "l2" and not whiten),
    )
    if propagation not in ("left", "symmetric"):
        # the DiskGraph loaders treat any other string as "left", which
        # would silently return wrong numerics
        raise ValueError(
            f"Unknown propagation type: '{propagation}'. "
            "Use 'left' or 'symmetric'."
        )
    if normalization not in ("l2", "l1", "spectral", "none"):
        raise ValueError(f"Unknown normalization method: {normalization}")
    if halo in ("overlap", "hier"):
        raise NotImplementedError(_HALO_NOT_PORTED.format(halo))
    if not (hasattr(graph, "data") or isinstance(graph, DiskGraph)):
        raise TypeError(
            "the sharded embed takes a SparseMatrix or a DiskGraph, got "
            f"{type(graph).__name__}"
        )
    if mesh is None:
        mesh = make_mesh(n_devices, device)
    n_shards = mesh.world_size
    n = graph.num_entities

    # one rank's PIECE of a sharded build holds only its own rows' edges
    meta = getattr(graph, "meta", None)
    piece_range = meta.get("row_range") if meta else None
    if piece_range is not None and (piece_range[0] > 0
                                    or piece_range[1] < n):
        if n_shards == 1:
            raise ValueError(
                "This DiskGraph is one host's piece of a sharded build "
                f"(rows {piece_range}); embedding it needs either the "
                "merged graph (graph.stream.merge_disk_graph_shards) or a "
                "multi-process run where every host holds its own piece."
            )
        bounds = shard_row_bounds(n, n_shards)
        lo, hi = int(piece_range[0]), int(piece_range[1])
        if lo not in bounds or hi not in bounds:
            raise ValueError(
                f"piece row range [{lo}, {hi}) does not align with the "
                f"{n_shards}-device shard cut {bounds}; build pieces with "
                "graph.stream.host_piece_range(n_entities, n_devices, "
                "devices_per_host, host_id)"
            )
        k = mesh.rank
        if not (lo <= bounds[k] and bounds[k + 1] <= hi):
            raise ValueError(
                f"process {k} owns shard {k} (rows [{bounds[k]}, "
                f"{bounds[k + 1]})) but its piece covers only [{lo}, {hi})"
            )

    sharded = shard_csr(graph, propagation, n_shards)
    plan = None
    if halo is True or (halo is None and n_shards > 1):
        # forced with one shard, the exchange is the shard's own (K16 and
        # a one-member all_to_all): NCCL refuses two ranks on one card, so
        # this is how a one-card machine runs a halo deployment's exchange
        # (the JAX package plans no halo for one device)
        candidate = plan_halo_distributed(sharded, mesh)
        if halo or candidate.table_rows < sharded.n_rows_padded:
            plan = candidate
    if initial_embeddings is not None:
        x0 = np.asarray(initial_embeddings, dtype=np.float32)
        if x0.ndim != 2 or x0.shape[0] != n:
            raise ValueError(
                f"initial_embeddings shape {x0.shape} does not match "
                f"number of entities {n}"
            )
        feature_dim = x0.shape[1]
    else:
        x0 = None

    fn, place = build_sharded_embed(
        mesh, sharded, int(feature_dim), residual_weight=residual_weight,
        normalization=normalization, do_whiten=whiten,
        convergence_threshold=convergence_threshold, halo=plan, dtype=dtype,
    )
    rps = sharded.rows_per_shard
    if x0 is None:
        x = lifecycle.make_initial_state(
            mesh, n, rps, lifecycle.entity_hashes(graph), int(feature_dim),
            seed, dtype=(torch.bfloat16 if dtype == "bfloat16"
                         else torch.float32))
    else:
        k = mesh.rank
        x = place(pad_rows(x0[k * rps:(k + 1) * rps], rps))

    def view(x):
        """Host copy of the full matrix, trimmed to the real rows."""
        return to_host(mesh.all_gather(x)[:n])

    if callback is not None:
        host = view(x) if int(num_iterations) == 0 else None
        prev = None
        for i in range(int(num_iterations)):
            x, _, _ = fn(x, 1, i)  # convergence is checked on the host here
            host = view(x)
            callback(i, host)
            if convergence_threshold > 0 and i > 0:
                rmse = float(np.sqrt(np.sum((host - prev) ** 2)
                                     / (host.shape[0] * host.shape[1])))
                if rmse < convergence_threshold:
                    break
            prev = host
        return host.copy()

    if checkpoint_dir is not None:
        x = _run_checkpointed(
            fn, x, mesh, sharded, int(feature_dim), int(num_iterations),
            residual_weight=residual_weight, normalization=normalization,
            whiten=whiten, convergence_threshold=convergence_threshold,
            mode="halo" if plan is not None else "flat", dtype=dtype,
            seed=seed, propagation=propagation, user_init=x0 is not None,
            content=lifecycle.content_digest(sharded, mesh, x0=x0),
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=int(checkpoint_every),
        )
    else:
        x, _, _ = fn(x, int(num_iterations))
    if out == "shards":
        return lifecycle.collect_shards(x, mesh, n, rps)
    if out != "full":
        return lifecycle.write_memmap(out, x, mesh, n, rps)
    return view(x)


def _run_checkpointed(fn, x, mesh, sharded, feature_dim, num_iterations, *,
                      residual_weight, normalization, whiten,
                      convergence_threshold, mode, dtype, seed, propagation,
                      user_init, content, checkpoint_dir, checkpoint_every):
    """Run the loop in checkpoint_every-iteration segments, saving the
    per-shard state after each and resuming from the last complete
    checkpoint when the parameters match.  Convergence is checked per
    iteration with the global iteration index, so a checkpointed run runs
    exactly the iterations of the same call without checkpoint_dir."""
    seg = max(1, checkpoint_every)
    fp = lifecycle.fingerprint(dict(
        n_rows=sharded.n_rows, n_rows_padded=sharded.n_rows_padded,
        rows_per_shard=sharded.rows_per_shard, feature_dim=feature_dim,
        dtype=dtype, normalization=normalization, whiten=bool(whiten),
        residual_weight=float(residual_weight), propagation=propagation,
        seed=seed, num_iterations=num_iterations, seg=seg, mode=mode,
        user_init=bool(user_init), content=content,
        convergence=float(convergence_threshold),
        n_shards=int(mesh.world_size),
    ))
    ck = lifecycle.ShardedCheckpoint(checkpoint_dir, fp, mesh)
    converging = convergence_threshold > 0
    meta = ck.latest()
    done = 0
    if meta is not None:
        done = min(int(meta["iteration"]), num_iterations)
        if done > 0:
            x = ck.load(meta)
        if meta.get("converged") and done > 0:
            return x
    while done < num_iterations:
        x, ran, conv = fn(x, min(seg, num_iterations - done), done)
        done += ran
        ck.save(x, done, extra={"converged": conv} if converging else None)
        if conv:
            break
    return x
