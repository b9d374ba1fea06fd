"""The port's sharded loop (cleora_tpu_torch/parallel) against the JAX
package's (cleora_tpu/parallel) on the CPU.

* The host planning — shard_coo, shard_graph, shard_disk_graph, plan_halo —
  bitwise equal to cleora_tpu.parallel.shard's.
* The per-shard init (K3's plain version) bitwise equal to the host init.
* One shard in this process: embed_sharded, embed(DiskGraph) and
  embed_dim_sharded(DiskGraph) against the JAX package's same calls (which
  run its sharded loop on a one-device mesh).  Unwhitened outputs within
  rtol=1e-4, atol=1e-5 (tests/test_torch_embed.py's float32 tolerance);
  bf16 storage atol=2e-2 (bf16 rounds at other places in the two
  frameworks); whitened and spectral outputs by their row Gram matrices
  (eigenvector signs are arbitrary) within atol=2e-5.
* Output forms, checkpoint/resume, the content digest, the halo step's
  residual with a gather table smaller than the shard.
* Several ranks: one spawned run of 2 gloo ranks and one of 4, each
  rank a fresh process that imports only the port, held by Gram against
  cleora_tpu.parallel.embed_sharded(n_devices=2/4, halo=False/True) on the
  suite's 8-device CPU mesh.
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
import jax.numpy as jnp
import cleora_tpu.parallel.shard as jshard
import cleora_tpu.parallel.state as jstate
from cleora_tpu.graph.stream import build_graph_streaming as jbuild
from cleora_tpu.parallel import embed_sharded as jax_embed_sharded

import cleora_tpu_torch as ctt
from cleora_tpu_torch.graph.hashing import init_embeddings
import cleora_tpu_torch.graph.stream as tstream
from cleora_tpu_torch.graph.stream import DiskGraph
from cleora_tpu_torch.ops.halo import halo_pack_plain
from cleora_tpu_torch.parallel import embed_sharded, make_mesh, shard
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


def _lines(seed, n_nodes, n_lines):
    rng = np.random.default_rng(seed)
    return [f"n{rng.integers(0, n_nodes)} n{rng.integers(0, n_nodes)}"
            for _ in range(n_lines)]


def _graph_lines():
    return _lines(5, 301, 1500) + [f"n{i} n{i + 1}" for i in range(300)]


@pytest.fixture(scope="module")
def graphs(tmp_path_factory):
    """One streamed build (301 entities: the padded row count 304 leaves
    pad rows, and a halo table of at most 301 rows) opened by both
    packages."""
    path = str(tmp_path_factory.mktemp("sharded") / "g")
    jdg = jbuild(_graph_lines(), "complex::reflexive::n", path)
    assert jdg.num_entities == 301
    return jdg, DiskGraph(path)


# ------------------------------------------------------------ host planning
@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_shards_and_halo_plan_bitwise(graphs, p):
    jdg, tdg = graphs
    jsm, tsm = jdg.to_sparse_matrix(), tdg.to_sparse_matrix()
    for ours, ref in ((shard.shard_graph(tsm, "left", p),
                       jshard.shard_graph(jsm, "left", p)),
                      (shard.shard_disk_graph(tdg, "symmetric", p),
                       jshard.shard_disk_graph(jdg, "symmetric", p)),
                      (shard.shard_coo(np.arange(10) // 3, np.arange(10),
                                       np.ones(10), 4, p),
                       jshard.shard_coo(np.arange(10) // 3, np.arange(10),
                                        np.ones(10), 4, p))):
        for name in ("local_rows", "cols", "vals"):
            a, b = getattr(ours, name), getattr(ref, name)
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        assert ((ours.n_rows, ours.n_rows_padded, ours.rows_per_shard)
                == (ref.n_rows, ref.n_rows_padded, ref.rows_per_shard))
        assert np.array_equal(shard.local_shard_degrees(ours),
                              jshard.local_shard_degrees(ref))
        plan, jplan = shard.plan_halo(ours), jshard.plan_halo(ref)
        assert plan.M == jplan.M
        assert np.array_equal(plan.send_idx, jplan.send_idx)
        assert np.array_equal(plan.remapped_cols, jplan.remapped_cols)
    x = np.ones((5, 3), np.float32)
    assert np.array_equal(shard.pad_rows(x, 8), jshard.pad_rows(x, 8))


def test_sharded_csr_views_the_graph(graphs):
    """The loop's local CSRs cut the graph at the same rows, padding-free,
    and the plan over them gathers every edge's column."""
    _, tdg = graphs
    ref = shard.shard_disk_graph(tdg, "left", 4)
    sc = shard.shard_csr(tdg, "left", 4)
    plan = shard.plan_halo(sc)
    for k in range(4):
        ip = sc.indptr(k)
        assert ip.shape == (sc.rows_per_shard + 1,) and ip[-1] == sc.nnz(k)
        rows = np.repeat(np.arange(sc.rows_per_shard), np.diff(ip))
        e = sc.nnz(k)
        assert np.array_equal(rows, ref.local_rows[k, :e])
        assert np.array_equal(sc.cols[k], ref.cols[k, :e])
        assert np.array_equal(sc.vals[k], ref.vals[k, :e])
        slots = plan.remapped_cols[k]
        owner, slot = slots // plan.M, slots % plan.M
        assert np.array_equal(
            owner * sc.rows_per_shard + plan.send_idx[owner, k, slot],
            sc.cols[k])
    mesh = make_mesh(device="cpu")
    one = shard.shard_csr(tdg, "left", 1)
    dist_plan = shard.plan_halo_distributed(one, mesh)
    full = shard.plan_halo(one)
    assert dist_plan.M == full.M
    assert np.array_equal(dist_plan.send_idx, full.send_idx)
    assert np.array_equal(dist_plan.remapped_cols[0], full.remapped_cols[0])


def test_halo_pack_plain_is_a_gather():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((50, 6)).astype(np.float32)
    idx = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    for dtype in (torch.float32, torch.bfloat16):
        t = torch.from_numpy(x).to(dtype)
        got = halo_pack_plain(t, torch.from_numpy(idx))
        assert got.shape == (3, 7, 6) and got.dtype == dtype
        assert torch.equal(got, t[torch.from_numpy(idx).long()])


# ------------------------------------------------------------- device init
@pytest.mark.parametrize("p", [1, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_per_shard_init_is_the_host_init(graphs, p, dtype):
    _, tdg = graphs
    n = tdg.num_entities
    n_padded, rps = ct.graph.stream.shard_row_params(n, p)
    for seed in (0, 13, -5):
        host = jshard.pad_rows(init_embeddings(
            np.asarray(tdg.entity_hashes), 24, seed), n_padded)
        for k in range(p):
            mesh = ShardGroup(k, p, torch.device("cpu"))
            got = lifecycle.make_initial_state(
                mesh, n, rps, lifecycle.entity_hashes(tdg), 24, seed, dtype)
            want = torch.from_numpy(host[k * rps:(k + 1) * rps]).to(dtype)
            assert torch.equal(got, want)


# ------------------------------------------------- one shard against JAX
_CASES = {
    "l2_whitened_residual_symmetric": dict(
        whiten=True, residual_weight=0.3, propagation="symmetric"),
    "l1_convergence": dict(whiten=False, normalization="l1",
                           convergence_threshold=0.02, num_iterations=40),
    "spectral": dict(whiten=False, normalization="spectral"),
    "none_initial_embeddings": dict(whiten=False, normalization="none"),
    "bf16": dict(whiten=False, dtype="bfloat16"),
    "dim_sharded": dict(whiten=False),
}


@pytest.fixture(scope="module")
def jax_refs(graphs):
    """Each case through the JAX package once: embed(DiskGraph) runs its
    sharded loop on a one-device mesh."""
    jdg, _ = graphs
    x0 = np.random.default_rng(2).standard_normal(
        (jdg.num_entities, D)).astype(np.float32)
    out = {}
    for name, kw in _CASES.items():
        kw = dict(dict(feature_dim=D, num_iterations=ITERS), **kw)
        if name == "dim_sharded":
            out[name] = ct.embed_dim_sharded(jdg, slice_dim=D // 2, **kw)
        elif name == "none_initial_embeddings":
            out[name] = ct.embed(jdg, initial_embeddings=x0, **kw)
        else:
            out[name] = ct.embed(jdg, **kw)
    calls = []
    out["callback"] = ct.embed(
        jdg, feature_dim=D, num_iterations=ITERS, whiten=False,
        normalization="spectral", callback=lambda i, e: calls.append(i))
    out["callback_calls"] = calls
    return out, x0


@pytest.mark.parametrize("case", sorted(_CASES))
def test_one_shard_matches_jax(graphs, jax_refs, case):
    _, tdg = graphs
    refs, x0 = jax_refs
    kw = dict(dict(feature_dim=D, num_iterations=ITERS), **_CASES[case])
    if case == "dim_sharded":
        ours = ctt.embed_dim_sharded(tdg, slice_dim=D // 2, **kw, **CPU)
    elif case == "none_initial_embeddings":
        ours = ctt.embed(tdg, initial_embeddings=x0, **kw, **CPU)
    else:
        ours = ctt.embed(tdg, **kw, **CPU)
        # embed(DiskGraph) is embed_sharded without a group
        assert np.array_equal(ours, embed_sharded(tdg, **kw, **CPU))
    ref = refs[case]
    assert ours.shape == ref.shape and ours.dtype == np.float32
    if case == "bf16":
        np.testing.assert_allclose(ours, ref, rtol=0, atol=2e-2)
    elif kw["whiten"] or case == "spectral":
        _gram_close(ours, ref)
    else:
        np.testing.assert_allclose(ours, ref, **TOL)


def test_callback_and_convergence_like_jax(graphs, jax_refs):
    _, tdg = graphs
    refs, _ = jax_refs
    calls = []
    ours = ctt.embed(tdg, feature_dim=D, num_iterations=ITERS, whiten=False,
                     normalization="spectral",
                     callback=lambda i, e: calls.append(i), **CPU)
    assert calls == refs["callback_calls"] == list(range(ITERS))
    _gram_close(ours, refs["callback"])
    # the loose threshold stops the l1 run before its 40 iterations, at
    # the iteration the JAX package stops at (same output within TOL)
    its = []
    embed_sharded(tdg, feature_dim=D, num_iterations=40, whiten=False,
                  normalization="l1", convergence_threshold=0.02,
                  callback=lambda i, e: its.append(i), **CPU)
    assert 1 < len(its) < 40


def test_one_shard_equals_the_single_device_embed(graphs):
    """With one shard the sharded loop runs the single-device loop's
    arithmetic on the same rows: bitwise equal, whitened too."""
    _, tdg = graphs
    sm = tdg.to_sparse_matrix()
    for kw in (dict(whiten=True), dict(whiten=True, residual_weight=0.3),
               dict(dtype="bfloat16")):
        a = ctt.embed(tdg, feature_dim=D, num_iterations=ITERS, **kw, **CPU)
        b = ctt.embed(sm, feature_dim=D, num_iterations=ITERS, **kw, **CPU)
        assert np.array_equal(a, b), kw


def test_halo_residual_with_a_table_smaller_than_the_shard(graphs):
    """halo=True with one shard: the gather table is the halo slab of the
    301 columns read, fewer than the shard's 304 rows, and K1's residual
    must come from the shard's state, not from the table."""
    _, tdg = graphs
    sc = shard.shard_csr(tdg, "left", 1)
    plan = shard.plan_halo(sc)
    assert plan.table_rows < sc.rows_per_shard
    kw = dict(feature_dim=D, num_iterations=ITERS, whiten=True,
              residual_weight=0.3, **CPU)
    assert np.array_equal(embed_sharded(tdg, halo=True, **kw),
                          embed_sharded(tdg, halo=False, **kw))


def test_argument_checks(graphs, tmp_path):
    _, tdg = graphs
    with pytest.raises(ValueError, match="full"):
        embed_sharded(tdg, out="bogus", **CPU)
    with pytest.raises(ValueError, match="callback"):
        embed_sharded(tdg, out="shards", callback=lambda i, x: None, **CPU)
    with pytest.raises(ValueError, match="Unknown propagation"):
        embed_sharded(tdg, propagation="banana", **CPU)
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        embed_sharded(tdg, n_devices=2, **CPU)
    # several shards: the hierarchical exchange needs make_hier_mesh's grid
    with pytest.raises(ValueError, match="build it with make_hier_mesh"):
        embed_sharded(tdg, halo="hier",
                      mesh=ShardGroup(0, 2, torch.device("cpu")), **CPU)
    with pytest.raises(TypeError, match="SparseMatrix or a DiskGraph"):
        embed_sharded(object(), **CPU)
    # a piece of a sharded build needs its other ranks
    piece = ct.graph.stream.build_graph_streaming_sharded(
        _lines(5, 301, 300), "complex::reflexive::n", str(tmp_path / "p"),
        0, 2)
    with pytest.raises(ValueError, match="one host's piece"):
        embed_sharded(DiskGraph(piece.path), **CPU)


def test_a_gloo_group_runs_on_the_cpu_only_when_asked():
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        # device=None is CUDA, whatever the group's backend: without a card
        # it raises, and with one the gloo group refuses it
        with pytest.raises((RuntimeError, ValueError), match="device='cpu'"):
            make_mesh()
        mesh = make_mesh(device="cpu")
        assert (mesh.rank, mesh.world_size, mesh.device.type) == (0, 1, "cpu")
        assert mesh.group is not None
        t = torch.arange(6, dtype=torch.float32).view(3, 2)
        assert torch.equal(mesh.all_gather(t), t)
        assert torch.equal(mesh.all_to_all(t), t)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------- outputs and checkpoints
def test_output_forms(graphs, tmp_path, monkeypatch):
    _, tdg = graphs
    kw = dict(feature_dim=D, num_iterations=3, **CPU)
    full = embed_sharded(tdg, **kw)
    sh = embed_sharded(tdg, out="shards", **kw)
    assert isinstance(sh, lifecycle.EmbeddingShards)
    assert (sh.lo, sh.hi) == (0, tdg.num_entities) and sh.shape == full.shape
    assert sh.bounds == (0, tdg.num_entities)
    assert np.array_equal(sh.rows, full)
    monkeypatch.setenv("CLEORA_TPU_FETCH_MB", "0.0001")  # 3 rows a chunk
    mm = embed_sharded(tdg, out=str(tmp_path / "e.npy"), **kw)
    assert isinstance(mm, np.memmap) and np.array_equal(np.asarray(mm), full)
    assert np.array_equal(np.load(str(tmp_path / "e.npy")), full)


def test_checkpoint_resume_bitwise(graphs, tmp_path):
    _, tdg = graphs
    kw = dict(feature_dim=D, num_iterations=6, checkpoint_every=2, **CPU)
    for extra in (dict(), dict(dtype="bfloat16", whiten=False)):
        whole = embed_sharded(tdg, checkpoint_dir=str(tmp_path / "a"),
                              **kw, **extra)
        assert np.array_equal(whole, embed_sharded(tdg, feature_dim=D,
                                                   num_iterations=6, **CPU,
                                                   **extra))
        d = str(tmp_path / "b")
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
                embed_sharded(tdg, checkpoint_dir=d, **kw, **extra)
        finally:
            lifecycle.ShardedCheckpoint.save = orig
        with open(os.path.join(d, "checkpoint.json")) as f:
            assert json.load(f)["iteration"] == 4
        resumed = embed_sharded(tdg, checkpoint_dir=d, **kw, **extra)
        assert np.array_equal(resumed, whole)
        assert not [f for f in os.listdir(d) if f.startswith("state_i2_")]
        for sub in ("a", "b"):
            for f in os.listdir(tmp_path / sub):
                os.remove(tmp_path / sub / f)


def test_checkpoint_restarts_on_another_input(graphs, tmp_path):
    """A checkpoint of other parameters, of another graph, or in the JAX
    package's format is ignored: the run starts afresh."""
    _, tdg = graphs
    d = str(tmp_path / "ck")
    kw = dict(num_iterations=4, checkpoint_every=2, checkpoint_dir=d, **CPU)
    embed_sharded(tdg, feature_dim=D, **kw)
    assert embed_sharded(tdg, feature_dim=4, **kw).shape == (301, 4)
    x0 = np.ones((301, D), np.float32)
    a = embed_sharded(tdg, feature_dim=D, initial_embeddings=x0, **kw)
    x0[5, 1] = 2.0
    b = embed_sharded(tdg, feature_dim=D, initial_embeddings=x0, **kw)
    fresh = embed_sharded(tdg, feature_dim=D, initial_embeddings=x0,
                          num_iterations=4, **CPU)
    assert np.array_equal(b, fresh) and not np.array_equal(a, b)
    # the JAX package's sharded checkpoint under the port's fingerprint, at
    # the last iteration: read, it would end the run with its zero state
    with open(os.path.join(d, "checkpoint.json")) as f:
        fp = json.load(f)["fingerprint"]
    for name in os.listdir(d):
        os.remove(os.path.join(d, name))
    jstate.ShardedCheckpoint(d, fp).save(jnp.zeros((304, D), jnp.float32), 4)
    with open(os.path.join(d, "checkpoint.json")) as f:
        assert json.load(f)["fingerprint"] == fp
    again = embed_sharded(tdg, feature_dim=D, initial_embeddings=x0, **kw)
    assert np.array_equal(again, fresh)


def test_checkpoint_convergence_across_segments(graphs, tmp_path):
    """The RMSE check skips only the global iteration 0: a checkpointed
    run stops where the run without checkpoints stops."""
    _, tdg = graphs
    kw = dict(feature_dim=D, num_iterations=40, whiten=False,
              convergence_threshold=0.02, **CPU)
    plain = embed_sharded(tdg, **kw)
    saves = []
    orig = lifecycle.ShardedCheckpoint.save

    def spy(self, x, it, extra=None):
        saves.append((it, extra))
        orig(self, x, it, extra)

    lifecycle.ShardedCheckpoint.save = spy
    try:
        ck = embed_sharded(tdg, checkpoint_dir=str(tmp_path / "c"),
                           checkpoint_every=1, **kw)
    finally:
        lifecycle.ShardedCheckpoint.save = orig
    assert np.array_equal(ck, plain)
    assert saves[-1][1] == {"converged": True} and saves[-1][0] < 40
    assert [it for it, _ in saves] == list(range(1, saves[-1][0] + 1))


def test_digest_covers_every_byte(graphs):
    _, tdg = graphs
    sm = tdg.to_sparse_matrix()
    data = sm.data
    arrays = {k: np.array(getattr(data, k)) for k in
              ("indptr", "indices", "left_vals")}
    mesh = make_mesh(device="cpu")

    def digest(x0=None):
        sc = shard.ShardedCsr(arrays["indptr"], arrays["indices"],
                              arrays["left_vals"], data.num_entities, 1)
        return lifecycle.content_digest(sc, mesh, x0=x0)

    base = digest()
    for name, idx in (("left_vals", 1), ("left_vals", 777), ("indices", 5),
                      ("indices", -1), ("indptr", 150)):
        a = arrays[name]
        old = a[idx].copy()
        a[idx] = a[idx] + (1 if name != "left_vals" else 0.125)
        assert digest() != base, (name, idx)
        a[idx] = old
    assert digest() == base
    x0 = np.ones((data.num_entities, 4), np.float32)
    d0 = digest(x0)
    x0[17, 3] = 2.0
    assert digest(x0) != d0


# ----------------------------------------------------------- several ranks
_RANK = r"""
import json, os, sys
import numpy as np
from cleora_tpu_torch.graph.stream import DiskGraph
from cleora_tpu_torch.parallel import embed_sharded, init_distributed, shard
from cleora_tpu_torch.parallel.mesh import make_mesh
import torch.distributed as dist

gdir, out, kw = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
assert init_distributed(device="cpu")
mesh = make_mesh(device="cpu")
dg = DiskGraph(gdir)
res = {h: embed_sharded(dg, halo=h, device="cpu", **kw)
       for h in (False, True)}
# this rank's piece of a sharded build holds only its own rows' edges
piece = embed_sharded(DiskGraph(f"{out}.piece{mesh.rank}"), device="cpu",
                      **kw)
npy = embed_sharded(dg, out=out + ".npy", device="cpu", **kw)
sc = shard.shard_csr(dg, "left", mesh.world_size)
mine = shard.plan_halo_distributed(sc, mesh)
full = shard.plan_halo(sc)
plan_ok = (mine.M == full.M and np.array_equal(mine.send_idx, full.send_idx)
           and np.array_equal(mine.remapped_cols[mesh.rank],
                              full.remapped_cols[mesh.rank]))
sh = embed_sharded(dg, out="shards", device="cpu", **kw)
np.savez(f"{out}.{mesh.rank}.npz", all_gather=res[False], halo=res[True],
         piece=piece, npy=np.asarray(npy), plan_ok=plan_ok, lo=sh.lo,
         hi=sh.hi, rows=sh.rows)
# every rank leaves the group together, then exits without the
# interpreter's teardown, where a gloo rank can abort ("terminate called
# without an active exception") once its results are on disk
dist.barrier()
dist.destroy_process_group()
sys.stdout.flush()
os._exit(0)
"""
_RANK_KW = dict(feature_dim=D, num_iterations=ITERS, whiten=True,
                residual_weight=0.3)
_WORLDS = (2, 4)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(graphs, tmp_path_factory):
    """Both runs start at once; the JAX references are computed while
    they run.  Returns {world: ([per-rank npz], {halo: JAX output})}."""
    jdg, tdg = graphs
    out_dir = tmp_path_factory.mktemp("ranks")
    procs = {}
    for world in _WORLDS:
        for k in range(world):
            tstream.build_graph_streaming_sharded(
                _graph_lines(), "complex::reflexive::n",
                str(out_dir / f"w{world}.piece{k}"), k, world)
        port = _free_port()
        procs[world] = []
        for r in range(world):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world),
                       LOCAL_RANK=str(r), MASTER_ADDR="localhost",
                       MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                       PYTHONPATH=REPO + os.pathsep
                       + os.environ.get("PYTHONPATH", ""))
            procs[world].append(subprocess.Popen(
                [sys.executable, "-c", _RANK, tdg.path,
                 str(out_dir / f"w{world}"), json.dumps(_RANK_KW)],
                env=env, cwd=REPO, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    refs = {world: {h: jax_embed_sharded(jdg, n_devices=world, halo=h,
                                         **_RANK_KW)
                    for h in (False, True)}
            for world in _WORLDS}
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


@pytest.mark.parametrize("world", _WORLDS)
@pytest.mark.parametrize("exchange", ["all_gather", "halo"])
def test_ranks_match_jax_mesh(ranks, world, exchange):
    per_rank, refs = ranks[world]
    ours = per_rank[0][exchange]
    for other in per_rank[1:]:  # every rank holds the full result
        assert np.array_equal(other[exchange], ours)
    _gram_close(ours, refs[exchange == "halo"])


@pytest.mark.parametrize("world", _WORLDS)
def test_ranks_outputs_and_plans(ranks, world):
    """The .npy and "shards" outputs tile the full result, every rank's
    halo plan equals plan_halo of the whole graph, and pieces of a sharded
    build (each rank its own) give the whole graph's result bitwise."""
    per_rank, _ = ranks[world]
    full = per_rank[0]["all_gather"]
    assert np.array_equal(per_rank[0]["npy"], full)
    assert all(np.array_equal(r["piece"], full) for r in per_rank)
    bounds = ct.graph.stream.shard_row_bounds(full.shape[0], world)
    for r, res in enumerate(per_rank):
        assert bool(res["plan_ok"])
        assert (int(res["lo"]), int(res["hi"])) == (bounds[r], bounds[r + 1])
        assert np.array_equal(res["rows"], full[bounds[r]:bounds[r + 1]])
