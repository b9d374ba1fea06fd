"""The overlapped and hierarchical halo exchanges of the port's sharded
loop (cleora_tpu_torch/parallel) against the JAX package's
(cleora_tpu/parallel) on the CPU.

* ``plan_overlap`` and ``plan_halo_hier`` bitwise equal to
  cleora_tpu.parallel.shard's, on tests/test_hier_halo.py's graph (500
  nodes, 5,000 edges, seed 17); the per-round compact CSRs hold exactly
  the padded groups' edges.
* K19's plain version (``spmm_acc_plain``) against a float64 dense
  reference (rtol=1e-5, atol=1e-6: float32 sums in another order).
* One shard in this process: both modes bitwise the port's flat loop
  (hier: K1 over the same rows in the same order; overlap: round 0 over
  every row, written, mixed and normalised in the flat loop's order) and
  against the JAX package's one-device run
  (unwhitened rtol=1e-4, atol=1e-5; whitened by row Gram matrices within
  atol=2e-5, eigenvector signs being arbitrary; bf16 storage atol=2e-2).
* Several ranks: one spawned run of 4 gloo ranks (overlap, and hier on a
  2×2 grid) and one of 2 (overlap), held against
  cleora_tpu.parallel.embed_sharded(n_devices=4 or 2, halo="overlap") and
  against make_hier_mesh(2, 2) with halo="hier" on the suite's 8-device
  CPU mesh, with the tolerances above; hier bitwise equal to the port's
  all-gather run, and its checkpoint resumed.
* Checkpoint/resume under hier, the argument errors, a one-rank group.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import cleora_tpu as ct
import cleora_tpu.parallel.shard as jshard
from cleora_tpu.parallel import embed_sharded as jax_embed_sharded
from cleora_tpu.parallel.mesh import make_hier_mesh as jax_make_hier_mesh

import cleora_tpu_torch as ctt
from cleora_tpu_torch.graph.stream import DiskGraph
from cleora_tpu_torch.ops.spmm import spmm_acc, spmm_acc_plain
from cleora_tpu_torch.parallel import embed_sharded, make_hier_mesh, shard
from cleora_tpu_torch.parallel import state as lifecycle
from cleora_tpu_torch.parallel.mesh import ShardGroup

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = 8
ITERS = 4
TOL = dict(rtol=1e-4, atol=1e-5)
GRAM_ATOL = 2e-5
CPU = dict(device="cpu")


def _gram_close(a, b, atol=GRAM_ATOL):
    np.testing.assert_allclose(a @ a.T, b @ b.T, atol=atol, rtol=0)


def _edges():
    rng = np.random.default_rng(17)
    return rng.integers(0, 500, size=5000), rng.integers(0, 500, size=5000)


@pytest.fixture(scope="module")
def graphs():
    src, dst = _edges()
    return (ct.SparseMatrix.from_edge_arrays(src, dst),
            ctt.SparseMatrix.from_edge_arrays(src, dst))


# ------------------------------------------------------------ the plans
@pytest.mark.parametrize("p", [2, 4, 8])
def test_plan_overlap_bitwise(graphs, p):
    jg, tg = graphs
    ours = shard.plan_overlap(shard.shard_graph(tg, "left", p))
    ref = jshard.plan_overlap(jshard.shard_graph(jg, "left", p))
    assert ours.M == ref.M
    assert ours.send_idx.dtype == ref.send_idx.dtype
    assert np.array_equal(ours.send_idx, ref.send_idx)
    assert len(ours.groups) == len(ref.groups) == p
    for a, b in zip(ours.groups, ref.groups):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("hc", [(2, 4), (4, 2), (2, 2)])
def test_plan_halo_hier_bitwise(graphs, hc):
    jg, tg = graphs
    h, c = hc
    ours = shard.plan_halo_hier(shard.shard_graph(tg, "left", h * c), h, c)
    ref = jshard.plan_halo_hier(jshard.shard_graph(jg, "left", h * c), h, c)
    for name in ("send_intra", "send_cross", "remapped_cols"):
        a, b = getattr(ours, name), getattr(ref, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for name in ("Mc", "Mh", "n_hosts", "chips_per_host", "table_rows"):
        assert getattr(ours, name) == getattr(ref, name), name


@pytest.mark.parametrize("p", [2, 4])
def test_round_csrs_hold_the_groups_edges(graphs, p):
    """Each round's compact CSR is its padded group without the padding,
    and the local CSR view plans the same rounds as the padded COO."""
    _, tg = graphs
    coo = shard.shard_graph(tg, "left", p)
    plan = shard.plan_overlap(coo)
    csr_plan = shard.plan_overlap(shard.shard_csr(tg, "left", p))
    for j in range(p):
        for r in range(p):
            rc = plan.rounds[j][r]
            e = rc.cols.shape[0]
            lrows, cols, vals = (g[j] for g in plan.groups[r])
            rows = np.repeat(rc.row_ids, np.diff(rc.indptr))
            assert np.array_equal(rows, lrows[:e])
            assert np.array_equal(rc.cols, cols[:e])
            assert np.array_equal(rc.vals, vals[:e])
            assert np.all(vals[e:] == 0) and np.all(np.diff(rc.row_ids) > 0)
            other = csr_plan.rounds[j][r]
            if r == 0:  # later rounds' slots follow each plan's own M
                assert np.array_equal(other.cols, rc.cols)
            assert np.array_equal(other.row_ids, rc.row_ids)
            assert np.array_equal(other.vals, rc.vals)


# ------------------------------------------------- K19's plain version
def _round(rng, n_rows, n_table, n_compact, max_deg):
    row_ids = np.sort(rng.choice(n_rows, size=n_compact, replace=False))
    deg = rng.integers(1, max_deg + 1, size=n_compact)
    indptr = np.zeros(n_compact + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    cols = rng.integers(0, n_table, size=int(indptr[-1]))
    vals = rng.random(int(indptr[-1]))
    return (row_ids.astype(np.int32), indptr, cols.astype(np.int32),
            vals.astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spmm_acc_plain_matches_dense(dtype):
    rng = np.random.default_rng(3)
    row_ids, indptr, cols, vals = _round(rng, 300, 120, 97, 9)
    table = torch.from_numpy(
        rng.standard_normal((120, 12)).astype(np.float32)).to(dtype)
    acc0 = rng.standard_normal((300, 12)).astype(np.float32)
    want = acc0.astype(np.float64)
    t64 = table.double().numpy()
    for i, row in enumerate(row_ids):
        for e in range(indptr[i], indptr[i + 1]):
            want[row] += float(vals[e]) * t64[cols[e]]
    acc = torch.from_numpy(acc0.copy())
    args = [torch.from_numpy(a) for a in (row_ids, indptr, cols, vals)]
    got = spmm_acc(acc, *args, table)
    assert got is acc and acc.dtype == torch.float32
    np.testing.assert_allclose(acc.numpy(), want, rtol=1e-5, atol=1e-6)
    # rows the round does not name are untouched
    others = np.setdiff1d(np.arange(300), row_ids)
    assert np.array_equal(acc.numpy()[others], acc0[others])
    again = spmm_acc_plain(torch.from_numpy(acc0.copy()), *args, table)
    assert torch.equal(again, acc)


def test_spmm_acc_of_an_empty_round_changes_nothing():
    acc = torch.randn(5, 4)
    before = acc.clone()
    empty = (torch.zeros(0, dtype=torch.int32), torch.zeros(1, dtype=torch.int64),
             torch.zeros(0, dtype=torch.int32), torch.zeros(0))
    spmm_acc(acc, *empty, torch.randn(3, 4))
    assert torch.equal(acc, before)


# ------------------------------------------------- one shard in process
_ONE = {
    "unwhitened": dict(whiten=False),
    "whitened_residual": dict(whiten=True, residual_weight=0.3),
    "bf16": dict(whiten=False, dtype="bfloat16"),
}


@pytest.fixture(scope="module")
def one_shard_refs(graphs):
    jg, _ = graphs
    return {case: jax_embed_sharded(jg, feature_dim=D, num_iterations=ITERS,
                                    n_devices=1, **kw)
            for case, kw in _ONE.items()}


@pytest.mark.parametrize("mode", ["overlap", "hier"])
@pytest.mark.parametrize("case", sorted(_ONE))
def test_one_shard_modes(graphs, one_shard_refs, mode, case):
    """With one shard "overlap" is round 0 alone (K19 over every edge,
    with the residual mix and the normalisation) and "hier" the 1×1 grid:
    the port's flat loop, bit for bit, and the JAX package's."""
    _, tg = graphs
    kw = dict(feature_dim=D, num_iterations=ITERS, **_ONE[case], **CPU)
    flat = embed_sharded(tg, halo=False, **kw)
    ours = embed_sharded(tg, halo=mode, **kw)
    assert ours.shape == flat.shape and ours.dtype == np.float32
    assert np.array_equal(ours, flat)
    ref = one_shard_refs[case]
    if case == "bf16":
        np.testing.assert_allclose(ours, ref, rtol=0, atol=2e-2)
    elif kw["whiten"]:
        _gram_close(ours, ref)
    else:
        np.testing.assert_allclose(ours, ref, **TOL)


@pytest.mark.parametrize("mode", ["overlap", "hier"])
def test_one_shard_checkpoint_resume(graphs, tmp_path, mode):
    """A run cut after its second save and resumed equals the
    uninterrupted one, bitwise."""
    _, tg = graphs
    kw = dict(feature_dim=D, num_iterations=6, checkpoint_every=2,
              halo=mode, **CPU)
    whole = embed_sharded(tg, checkpoint_dir=str(tmp_path / "a"), **kw)
    assert np.array_equal(whole, embed_sharded(
        tg, feature_dim=D, num_iterations=6, halo=mode, **CPU))
    orig = lifecycle.ShardedCheckpoint.save
    calls = []

    def crashing(self, x, it, extra=None):
        orig(self, x, it, extra)
        calls.append(it)
        if len(calls) == 2:
            raise RuntimeError("simulated crash")

    lifecycle.ShardedCheckpoint.save = crashing
    try:
        with pytest.raises(RuntimeError, match="simulated crash"):
            embed_sharded(tg, checkpoint_dir=str(tmp_path / "b"), **kw)
    finally:
        lifecycle.ShardedCheckpoint.save = orig
    with open(tmp_path / "b" / "checkpoint.json") as f:
        assert json.load(f)["iteration"] == 4
    resumed = embed_sharded(tg, checkpoint_dir=str(tmp_path / "b"), **kw)
    assert np.array_equal(resumed, whole)


def test_argument_errors(graphs, tmp_path):
    _, tg = graphs
    two = ShardGroup(0, 2, torch.device("cpu"))  # raises before a collective
    with pytest.raises(ValueError, match="build it with make_hier_mesh"):
        embed_sharded(tg, halo="hier", mesh=two, **CPU)
    piece = ct.graph.stream.build_graph_streaming_sharded(
        [f"n{i} n{(7 * i) % 50}" for i in range(50)],
        "complex::reflexive::n", str(tmp_path / "p"), 0, 2)
    for mode in ("overlap", "hier"):
        with pytest.raises(ValueError, match="need global edge data"):
            embed_sharded(DiskGraph(piece.path), halo=mode, mesh=two, **CPU)
    with pytest.raises(ValueError, match=r"a 2x1 \(host, chip\) mesh needs 2"):
        make_hier_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="mesh 2x2 != 3 shards"):
        shard.plan_halo_hier(shard.shard_graph(tg, "left", 3), 2, 2)
    mesh = make_hier_mesh(device="cpu")
    assert (mesh.n_hosts, mesh.chips_per_host, mesh.is_hier) == (1, 1, True)
    assert mesh.chip_group is None and mesh.host_group is None


def test_hier_mesh_in_a_one_rank_group(graphs):
    """make_hier_mesh in a process group makes both subgroups; one rank's
    collectives over them are copies, so both modes equal the run without
    a group."""
    import torch.distributed as dist

    _, tg = graphs
    kw = dict(feature_dim=D, num_iterations=3, whiten=True, **CPU)
    alone = embed_sharded(tg, **kw)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_hier_mesh(device="cpu")
        assert mesh.chip_group is not None and mesh.host_group is not None
        t = torch.arange(6, dtype=torch.float32).view(3, 2)
        assert torch.equal(mesh.sub_all_to_all_(torch.empty(3, 2), t,
                                                "host"), t)
        assert torch.equal(mesh.sub_all_gather_(torch.empty(3, 2), t,
                                                "chip"), t)
        assert np.array_equal(embed_sharded(tg, halo="hier", mesh=mesh, **kw),
                              alone)
        np.testing.assert_allclose(embed_sharded(tg, halo="overlap", **kw),
                                   alone, **TOL)
    finally:
        dist.destroy_process_group()


# ----------------------------------------------------------- several ranks
_RANK = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
import cleora_tpu_torch as ctt
from cleora_tpu_torch.parallel import embed_sharded, init_distributed
from cleora_tpu_torch.parallel.mesh import make_hier_mesh

out, kw = sys.argv[1], json.loads(sys.argv[2])
assert init_distributed(device="cpu")
rng = np.random.default_rng(17)
src, dst = rng.integers(0, 500, size=5000), rng.integers(0, 500, size=5000)
g = ctt.SparseMatrix.from_edge_arrays(src, dst)
torch.set_num_threads(1)  # the native builder raised the OpenMP count
world, rank = dist.get_world_size(), dist.get_rank()
hier = make_hier_mesh(2, 2, device="cpu") if world == 4 else None
res = {}
for whiten in (False, True):
    tag = "_w" if whiten else "_u"
    res["overlap" + tag] = embed_sharded(g, halo="overlap", whiten=whiten,
                                         device="cpu", **kw)
    if hier is not None:
        res["hier" + tag] = embed_sharded(g, halo="hier", mesh=hier,
                                          whiten=whiten, **kw)
        res["all_gather" + tag] = embed_sharded(g, halo=False, whiten=whiten,
                                                device="cpu", **kw)
if hier is not None:
    ck = dict(halo="hier", mesh=hier, whiten=True, checkpoint_every=2,
              checkpoint_dir=out + ".ck", **kw)
    res["hier_ck"] = embed_sharded(g, **ck)
    res["hier_resumed"] = embed_sharded(g, **ck)  # loads the last save
np.savez(f"{out}.{rank}.npz", **res)
# every rank leaves the group together, then exits without the
# interpreter's teardown, where a gloo rank can abort once its results
# are on disk
dist.barrier()
dist.destroy_process_group()
sys.stdout.flush()
os._exit(0)
"""
_RANK_KW = dict(feature_dim=D, num_iterations=ITERS)
_WORLDS = (2, 4)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(graphs, tmp_path_factory):
    """Both runs start at once; the JAX references are computed while
    they run.  Returns {world: ([per-rank npz], {key: JAX output})}."""
    jg, _ = graphs
    out_dir = tmp_path_factory.mktemp("halo_modes")
    procs = {}
    for world in _WORLDS:
        port = _free_port()
        procs[world] = []
        for r in range(world):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                       LOCAL_RANK=str(r), MASTER_ADDR="localhost",
                       MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                       PYTHONPATH=REPO + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
            procs[world].append(subprocess.Popen(
                [sys.executable, "-c", _RANK, str(out_dir / f"w{world}"),
                 json.dumps(_RANK_KW)],
                env=env, cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    refs = {world: {} for world in _WORLDS}
    for whiten in (False, True):
        tag = "_w" if whiten else "_u"
        for world in _WORLDS:
            refs[world]["overlap" + tag] = jax_embed_sharded(
                jg, n_devices=world, halo="overlap", whiten=whiten,
                **_RANK_KW)
        refs[4]["hier" + tag] = jax_embed_sharded(
            jg, mesh=jax_make_hier_mesh(n_hosts=2, chips_per_host=2),
            halo="hier", whiten=whiten, **_RANK_KW)
    results = {}
    try:
        for world, ps in procs.items():
            for r, p in enumerate(ps):
                log, _ = p.communicate(timeout=240)
                assert p.returncode == 0, f"world {world} rank {r}:\n{log}"
            results[world] = [np.load(str(out_dir / f"w{world}.{r}.npz"))
                              for r in range(world)]
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)
    return {world: (results[world], refs[world]) for world in _WORLDS}


@pytest.mark.parametrize("world,mode", [(2, "overlap"), (4, "overlap"),
                                        (4, "hier")])
@pytest.mark.parametrize("whiten", [False, True])
def test_ranks_match_jax_mesh(ranks, world, mode, whiten):
    per_rank, refs = ranks[world]
    key = mode + ("_w" if whiten else "_u")
    ours = per_rank[0][key]
    for other in per_rank[1:]:  # every rank holds the full result
        assert np.array_equal(other[key], ours)
    if whiten:
        _gram_close(ours, refs[key])
    else:
        np.testing.assert_allclose(ours, refs[key], **TOL)


@pytest.mark.parametrize("whiten", [False, True])
def test_ranks_hier_is_the_all_gather_run(ranks, whiten):
    """The two-level exchange hands K1 the same rows as the all-gather, in
    the same edge order: bitwise."""
    per_rank, _ = ranks[4]
    tag = "_w" if whiten else "_u"
    for res in per_rank:
        assert np.array_equal(res["hier" + tag], res["all_gather" + tag])


def test_ranks_hier_checkpoint_resume(ranks):
    per_rank, _ = ranks[4]
    for res in per_rank:
        assert np.array_equal(res["hier_ck"], res["hier_w"])
        assert np.array_equal(res["hier_resumed"], res["hier_ck"])
