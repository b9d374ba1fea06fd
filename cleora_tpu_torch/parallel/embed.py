"""The sharded embedding loop: one shard per process over torch.distributed.

The port of cleora_tpu/parallel/embed.py.  Rank k of the process group
owns rows [k·rps, (k+1)·rps) of the state on its own device (one card per
rank with NCCL, the CPU with gloo); without a group the calling process is
the only shard.  Each iteration, on every rank (:func:`_local_step`):

1. exchange: ``all_gather`` of the row shards into the full gather table,
   or the halo exchange — kernel K16 packs the rows each peer reads into
   a (P, M, D) slab and one ``all_to_all_single`` swaps the slabs — or its
   two-level form on a ("host", "chip") grid (``halo="hier"``: K16 twice,
   a chip-axis and a host-axis ``all_to_all_single`` and a chip-axis
   ``all_gather_into_tensor``);
2. kernel K1 over the shard's local CSR, whose column ids point into the
   gather table, with the residual mix taken from the shard's own state
   and the l2/l1 row normalisation in its epilogue (the same kernel as
   the single-device loop's, so one shard is bitwise ``embed()``).
   ``halo="overlap"`` fuses 1 and 2: P-1 point-to-point rounds, each
   slab packed by K16 and sent with ``batch_isend_irecv`` while kernel
   K19 adds the previous round's edges into a float32 accumulator;
3. the row normalization of the overlap rounds' sum (kernel K2), or the
   spectral rescale with an all-reduced Gram matrix;
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
from ..ops.spmm import CsrMatrix, spmm, spmm_acc
from . import state as lifecycle
from .mesh import ShardGroup, make_mesh
from .shard import (
    HaloPlan,
    HierHaloPlan,
    OverlapPlan,
    ShardedCsr,
    pad_rows,
    plan_halo_distributed,
    plan_halo_hier,
    plan_overlap,
    shard_csr,
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
               device: torch.device,
               vals: Optional[np.ndarray] = None) -> CsrMatrix:
    """Shard k's local CSR on ``device``: ``cols`` index the gather table
    of ``n_cols`` rows; ``vals`` replaces the shard's values."""
    indptr = sharded.indptr(k)
    vals = sharded.vals[k] if vals is None else vals
    if (np.any(np.diff(indptr) < 0) or indptr[-1] != len(cols)
            or len(cols) != len(vals)):
        raise ValueError("malformed CSR: indptr/indices/vals disagree")
    return CsrMatrix(torch.from_numpy(indptr).to(device),
                     _to_device(cols, np.int32, device, n_cols),
                     _to_device(vals, np.float32, device))


def shard_operator(mesh: ShardGroup, sharded: ShardedCsr,
                   halo: Optional[HaloPlan], width: int,
                   dtype: str = "float32",
                   vals: Optional[np.ndarray] = None):
    """This process's shard of the operator, ready for
    :func:`gather_table`: ``(csr, send_idx)``, the shard's local CSR on its
    device (column ids into the gather table; ``vals`` replaces the
    shard's values) and its halo send indices (None: the all-gather).
    Refuses a shape whose loop at ``width`` cannot fit the device."""
    k = mesh.rank
    rps = sharded.rows_per_shard
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
    check_device_fit(rps + (n_cols if separate_table else 0), int(width),
                     sharded.nnz(k), dtype, mesh.device)
    return _local_csr(sharded, k, cols, n_cols, mesh.device, vals), send_idx


def check_piece_range(lo: int, hi: int, n: int, mesh: ShardGroup) -> None:
    """A piece of a sharded build covering rows [lo, hi) of n must lie on
    the group's shard cut and hold the calling rank's whole shard."""
    from ..graph.stream import shard_row_bounds

    bounds = shard_row_bounds(n, mesh.world_size)
    if lo not in bounds or hi not in bounds:
        raise ValueError(
            f"piece row range [{lo}, {hi}) does not align with the "
            f"{mesh.world_size}-device shard cut {bounds}; build pieces with "
            "graph.stream.host_piece_range(n_entities, n_devices, "
            "devices_per_host, host_id)"
        )
    k = mesh.rank
    if not (lo <= bounds[k] and bounds[k + 1] <= hi):
        raise ValueError(
            f"process {k} owns shard {k} (rows [{bounds[k]}, "
            f"{bounds[k + 1]})) but its piece covers only [{lo}, {hi})"
        )


def gather_table(x: torch.Tensor, mesh: ShardGroup,
                 send_idx: Optional[torch.Tensor]) -> torch.Tensor:
    """The rows the shard's local CSR gathers from: the all-gathered
    (n_padded, D) state (``x`` itself for one shard without a group), or
    the received (P·M, D) halo slab."""
    if send_idx is None:
        return mesh.all_gather(x)
    return mesh.all_to_all(halo_pack(x, send_idx)).view(-1, x.shape[1])


def _propagate_local(x: torch.Tensor, csr: CsrMatrix, mesh: ShardGroup,
                     send_idx: Optional[torch.Tensor],
                     residual_weight: float,
                     normalization: str = "none") -> torch.Tensor:
    """Boundary-row exchange + local SpMM (K1) + residual mix + the
    ``"l2"``/``"l1"`` row normalisation, float32."""
    table = gather_table(x, mesh, send_idx)
    return spmm(csr, table, residual_weight,
                residual=None if table is x else x,
                normalization=normalization)


def _check_rows(name: str, a: np.ndarray, n: int) -> None:
    """Every entry of a plan's index array lies in [0, n)."""
    if a.size and (a.min() < 0 or a.max() >= n):
        raise ValueError(f"malformed {name} plan: row out of range")


class OverlapExchange:
    """``halo="overlap"`` on this shard (cleora_tpu/parallel/embed.py:
    _overlap_propagate): calling it with the shard's state returns the
    float32 local SpMM.  In round r the shard sends the slab its peer
    (me + r) mod P reads, packed by K16, and receives the one from
    (me - r) mod P with one ``batch_isend_irecv``; K19 adds round 0's
    edges (the shard's own rows) while round 1 is in flight, and each
    later round's edges once its slab has arrived, while the next one is
    in flight.  Two send and two receive slabs alternate, so a slab is
    repacked only after the send that read it has completed; on NCCL the
    transfers wait for the packs on the compute stream, and ``wait()``
    makes the compute stream wait for the transfers.  One shard runs round
    0 alone."""

    def __init__(self, mesh: ShardGroup, sharded: ShardedCsr,
                 plan: OverlapPlan, width: int, dtype: str = "float32"):
        k, P = mesh.rank, mesh.world_size
        rps, M = sharded.rows_per_shard, plan.M
        if len(plan.rounds) != P:
            raise ValueError(
                f"overlap plan of {len(plan.rounds)} shards but the process "
                f"group has {P} ranks")
        _check_rows("overlap", plan.send_idx, rps)
        dev = mesh.device
        self.rounds = []
        for r, rc in enumerate(plan.rounds[k]):
            _check_rows("overlap", rc.row_ids, rps)
            _check_rows("overlap", rc.cols, rps if r == 0 else M)
            self.rounds.append(tuple(torch.from_numpy(a).to(dev) for a in (
                rc.row_ids, rc.indptr, rc.cols, rc.vals)))
        # round r packs what peer (k + r) mod P reads of my rows
        self.send = [torch.from_numpy(np.ascontiguousarray(
            plan.send_idx[k, (k + r) % P][None])).to(dev) for r in range(P)]
        state_dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        n_slabs = 2 if P > 1 else 0
        check_device_fit(rps + 2 * n_slabs * M, int(width), sharded.nnz(k),
                         dtype, dev)
        self.slabs = [torch.empty((1, M, int(width)), dtype=state_dtype,
                                  device=dev) for _ in range(2 * n_slabs)]
        self.mesh, self.rps, self.M = mesh, rps, M

    def _post(self, x: torch.Tensor, r: int):
        """Pack round r's slab and start its transfer; returns (works,
        receive slab)."""
        mesh, P = self.mesh, self.mesh.world_size
        send = halo_pack(x, self.send[r], out=self.slabs[r % 2])
        recv = self.slabs[2 + r % 2]
        import torch.distributed as dist

        works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, (mesh.rank + r) % P, mesh.group),
            dist.P2POp(dist.irecv, recv, (mesh.rank - r) % P, mesh.group),
        ])
        return works, recv

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        P = self.mesh.world_size
        acc = torch.zeros((self.rps, x.shape[1]), dtype=torch.float32,
                          device=x.device)
        pending = self._post(x, 1) if P > 1 else None
        spmm_acc(acc, *self.rounds[0], x)
        for r in range(1, P):
            works, recv = pending
            for w in works:
                w.wait()
            if r + 1 < P:
                pending = self._post(x, r + 1)
            spmm_acc(acc, *self.rounds[r], recv.view(self.M, x.shape[1]))
        return acc


class HierExchange:
    """``halo="hier"`` on this shard (cleora_tpu/parallel/embed.py:
    _hier_exchange): calling it with the shard's state returns the gather
    table in the plan's receive layout [intra C·Mc | cross C·H·Mh].  K16
    packs the intra-host slabs, one chip-axis ``all_to_all_single`` puts
    them straight into the table's first rows; K16 packs the cross-host
    union slabs, one host-axis ``all_to_all_single`` swaps them, and one
    chip-axis ``all_gather_into_tensor`` fans them out into the rest of
    the table, with no concatenation copy.  The table and slabs are
    allocated once.  ``csr`` is the shard's local CSR over the table."""

    def __init__(self, mesh: ShardGroup, sharded: ShardedCsr,
                 plan: HierHaloPlan, width: int, dtype: str = "float32"):
        k, rps = mesh.rank, sharded.rows_per_shard
        H, C = plan.n_hosts, plan.chips_per_host
        if H * C != mesh.world_size:
            raise ValueError(
                f"a {H}x{C} hier plan but the process group has "
                f"{mesh.world_size} ranks")
        _check_rows("hier", plan.send_intra, rps)
        _check_rows("hier", plan.send_cross, rps)
        dev, d = mesh.device, int(width)
        check_device_fit(rps + plan.table_rows, d, sharded.nnz(k), dtype, dev)
        self.csr = _local_csr(sharded, k, plan.remapped_cols[k],
                              plan.table_rows, dev)
        self.send_intra, self.send_cross = (
            torch.from_numpy(np.ascontiguousarray(a[k])).to(dev)
            for a in (plan.send_intra, plan.send_cross))
        sdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        self.table = torch.empty((plan.table_rows, d), dtype=sdt, device=dev)
        self.intra = torch.empty((C, plan.Mc, d), dtype=sdt, device=dev)
        self.cross = torch.empty((H, plan.Mh, d), dtype=sdt, device=dev)
        self.cross_recv = torch.empty((H * plan.Mh, d), dtype=sdt,
                                      device=dev)
        self.mesh, self.split = mesh, C * plan.Mc

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        mesh, d, s = self.mesh, x.shape[1], self.split
        halo_pack(x, self.send_intra, out=self.intra)
        mesh.sub_all_to_all_(self.table[:s], self.intra.view(-1, d), "chip")
        halo_pack(x, self.send_cross, out=self.cross)
        mesh.sub_all_to_all_(self.cross_recv, self.cross.view(-1, d), "host")
        mesh.sub_all_gather_(self.table[s:], self.cross_recv, "chip")
        return self.table


@full_float32_matmul()
def _local_step(x: torch.Tensor, propagate: Callable, mesh: ShardGroup, *,
                n_rows: int, n_real: int, normalization: str,
                do_whiten: bool) -> torch.Tensor:
    """One propagate → normalize → whiten step on this shard;
    ``propagate(x)`` is the exchange, the local SpMM and the residual mix
    in float32.  bf16 state is exchanged in bf16; everything after the
    gather computes in float32 and the result is stored back at x's dtype.
    ``n_real`` rows of the shard are real (a prefix: the pad rows are the
    last global rows)."""
    y = propagate(x)
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
    overlap: Optional[OverlapPlan] = None,
    hier: Optional[HierHaloPlan] = None,
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
    ``all_to_all_single``) instead of all-gathering the full table; with
    an ``overlap`` plan (:func:`.shard.plan_overlap`) it runs the
    pipelined rounds of :class:`OverlapExchange`, with a ``hier`` plan
    (:func:`.shard.plan_halo_hier`, a :func:`.mesh.make_hier_mesh` group
    of more than one rank) the two-level :class:`HierExchange`.  As in
    the JAX package, ``hier`` wins over ``overlap``, and either over
    ``halo``."""
    n_rows = sharded.n_rows
    lo, hi = lifecycle.shard_rows(mesh, n_rows, sharded.rows_per_shard)
    nd = n_rows * int(feature_dim)
    state_dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    w = float(residual_weight)
    # K1 normalises l2/l1 rows in its epilogue; the overlap rounds' sum
    # (K19) is normalised after it
    fused = ("none" if overlap is not None and hier is None
             or normalization not in ("l2", "l1") else normalization)
    if hier is not None:
        exchange = HierExchange(mesh, sharded, hier, feature_dim, dtype)

        def propagate(x):
            return spmm(exchange.csr, exchange(x), w, residual=x,
                        normalization=fused)
    elif overlap is not None:
        exchange = OverlapExchange(mesh, sharded, overlap, feature_dim, dtype)

        def propagate(x):
            y = exchange(x)
            if w > 0.0:  # the residual mix of cleora_tpu/parallel/embed.py:193
                y = (1.0 - w) * y + w * x.float()
            return y
    else:
        csr, send_idx = shard_operator(mesh, sharded, halo, feature_dim,
                                       dtype)

        def propagate(x):
            return _propagate_local(x, csr, mesh, send_idx, w, fused)

    def step(x):
        return _local_step(
            x, propagate, mesh, n_rows=n_rows, n_real=hi - lo,
            normalization="none" if fused != "none" else normalization,
            do_whiten=bool(do_whiten))

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
    shard's rows with itself).  ``"overlap"`` pipelines the exchange as
    P-1 point-to-point rounds against the local SpMM (kernel K19);
    ``"hier"`` runs the two-level exchange of a ("host", "chip") grid
    and needs ``mesh=make_hier_mesh(...)`` with more than one rank.  With
    one shard both exchange with the shard itself: ``"overlap"`` is round
    0 alone, ``"hier"`` a 1×1 grid.  Both need every shard's edges (not
    one rank's piece of a sharded build).  ``banded`` and
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
    from ..graph.stream import DiskGraph

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
        if halo in ("overlap", "hier"):
            raise ValueError(
                "banded/overlap/hier/ell-split layouts need global edge "
                "data; a sharded-build piece supports the flat, halo and "
                "ELL layouts (merge the pieces for the others)."
            )
        check_piece_range(int(piece_range[0]), int(piece_range[1]), n, mesh)

    sharded = shard_csr(graph, propagation, n_shards)
    plan = overlap_plan = hier_plan = None
    if halo == "hier":
        if n_shards > 1 and not mesh.is_hier:
            raise ValueError(
                'halo="hier" needs a ("host", "chip") mesh — build it '
                "with make_hier_mesh"
            )
        # one shard without a hier group is the 1×1 grid (both axes the
        # whole group): the exchange with the shard itself, as halo=True
        hier_plan = plan_halo_hier(
            sharded, *((mesh.n_hosts, mesh.chips_per_host) if mesh.is_hier
                       else (1, 1)))
    elif halo == "overlap":
        overlap_plan = plan_overlap(sharded)
    elif halo is True or (halo is None and n_shards > 1):
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
        overlap=overlap_plan, hier=hier_plan,
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
            mode=("hier" if hier_plan is not None else
                  "overlap" if overlap_plan is not None else
                  "halo" if plan is not None else "flat"), dtype=dtype,
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
