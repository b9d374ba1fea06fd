"""The walk siblings over the shard group (cleora_tpu_torch/ops/walk.py's
owner-routed hops, algorithms.py's group paths, ops/cooccur.py's
rank-parallel counting, parallel/cooccur.py, search.py's ``mesh=``)
against the port's one-card path and the JAX package, on the CPU.

* The row-sharded walk tables, bitwise the JAX package's
  ``_shard_walk_tables``/``_shard_walk_tables2`` slices for P in 1..4.
* The owner-routed hops (the plain versions of K17 and K18), P rank slices
  summed in this process: bitwise ``walk_uniform_plain`` /
  ``walk_p_q_plain`` (the JAX package's sharded second-order engine
  matches its replicated one only below 4,096 lanes; the port's matches at
  any batch, one case is above).
* ``_walk_table_mode``'s decisions and messages, the JAX package's for the
  same budget and device count; the DiskGraph walk CSR, bitwise the JAX
  package's and the in-RAM one, and the refusal of a piece.
* ``sharded_counts_to_embeddings`` on the JAX package's count ranges
  against its own on its 4-device CPU mesh, its sketch patched to the
  port's draw: rtol=atol=2e-4 (the JAX package's tolerance in
  tests/test_cooccur_sharded.py).
* One 2-rank and one 4-rank gloo run, started together once per test
  session (a lock file in the xdist workers' common temporary directory):
  walks and counts bitwise the one-process port's under both table modes,
  every partition on its counting rank, both factorizations (bitwise in
  practice: each row of an all-reduced product has one nonzero term; held
  at 2e-4), a one-process checkpoint resumed on P ranks and a P-rank one in
  one process without counting again, ``ShardedDeviceIndex(mesh=)``
  against the JAX package's on its 2- and 4-device meshes modulo exact
  ties, and the CLI's ``embed --sharded -a deepwalk``.
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import cleora_tpu as ct
import cleora_tpu.algorithms as jalg
import cleora_tpu.parallel.cooccur as jpc
import cleora_tpu.search as jsearch
from cleora_tpu.graph.stream import DiskGraph as JDiskGraph
from cleora_tpu.graph.stream import build_graph_streaming as jbuild
from cleora_tpu.graph.stream import \
    build_graph_streaming_sharded as jbuild_piece
from cleora_tpu.ops import cooccur as jco
from cleora_tpu.parallel.mesh import make_mesh as jax_make_mesh

import cleora_tpu_torch as ctt
import cleora_tpu_torch.algorithms as talg
from cleora_tpu_torch.convert import ranges_from_jax
from cleora_tpu_torch.graph.stream import DiskGraph
from cleora_tpu_torch.graph.stream import build_graph_streaming as tbuild
from cleora_tpu_torch.graph.stream import \
    build_graph_streaming_sharded as tbuild_piece
from cleora_tpu_torch.ops import cooccur as tco
from cleora_tpu_torch.ops import walk as twalk
from cleora_tpu_torch.parallel import make_mesh
from cleora_tpu_torch.parallel.cooccur import sharded_counts_to_embeddings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
COLUMNS = "complex::reflexive::n"
WORLDS = (2, 4)
# 9 hash partitions on the test graph: every rank of 4 counts some
PASS_PAIRS = 2_000
KW = dict(feature_dim=8, num_walks=2, walk_length=12, window_size=3, seed=7,
          backend="device", cooccurrence="device", device="cpu")
N2V = dict(p=0.5, q=2.0)


def _lines():
    rng = np.random.default_rng(11)
    return [f"n{rng.integers(0, 150)} n{rng.integers(0, 150)}"
            for _ in range(900)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The plain versions on these shapes run as fast on one thread; the
    native graph builders set the process's OpenMP count to eight."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def graph():
    return ctt.SparseMatrix.from_iterator(iter(_lines()), COLUMNS)


def _weighted(n, seed, hub=60):
    """A weighted walk CSR (indptr, cols, deg, vals, wmax, wsum) with
    (row, col)-sorted rows, a hub (node 1), a row of zero weights (node 2)
    and an isolated node (n - 1)."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([rng.integers(0, n - 1, 3 * n), np.ones(hub, int)])
    dst = np.concatenate([rng.integers(0, n - 1, 3 * n),
                          rng.choice(n - 1, hub, replace=False)])
    keys = np.unique(np.concatenate([src * n + dst, dst * n + src]))
    rows, cols = keys // n, keys % n
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    vals = rng.uniform(0.05, 3.0, rows.shape[0]).astype(np.float32)
    vals[rows == 2] = 0.0
    deg = np.bincount(rows, minlength=n)
    indptr = np.concatenate([[0], np.cumsum(deg)[:-1]])
    wmax = np.zeros(n, np.float32)
    np.maximum.at(wmax, rows, vals)
    wsum = np.zeros(n, np.float64)
    np.add.at(wsum, rows, vals.astype(np.float64))
    return (indptr.astype(np.int32), cols.astype(np.int32),
            deg.astype(np.int32), vals, wmax, wsum.astype(np.float32))


# ------------------------------------------------------------ the tables
@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_sharded_tables_are_the_jax_layout(world):
    n = 301  # no P of 2..4 divides it
    indptr, cols, deg, vals, wmax, wsum = _weighted(n, 1)
    mesh = jax_make_mesh(world)
    ip_sh, cols_sh, deg_sh, rps = jalg._shard_walk_tables(indptr, cols, deg,
                                                          n, mesh)
    want2 = jalg._shard_walk_tables2(indptr, cols, vals, deg, wmax, wsum, n,
                                     mesh)
    names = ("indptr", "cols", "vals", "deg", "wmax", "wsum")
    assert rps == want2[-1] == twalk.walk_rows(n, world)
    for r in range(world):
        got = twalk.walk_table_slice(indptr, cols, deg, n, r, world)
        for name, want in (("indptr", ip_sh), ("cols", cols_sh),
                           ("deg", deg_sh)):
            want = np.asarray(want)[r]
            assert got[name].dtype == want.dtype
            assert np.array_equal(got[name], want), (world, r, name)
        got = twalk.walk_table_slice(indptr, cols, deg, n, r, world, vals,
                                     wmax, wsum)
        for name, want in zip(names, want2[:-1]):
            assert np.array_equal(got[name], np.asarray(want)[r]), (
                world, r, name)


# ------------------------------------------------------- owner-routed hops
@pytest.mark.parametrize("world", [1, 2, 3, 4])
@pytest.mark.parametrize("pq", [None, (1.0, 1.0), (0.5, 2.0), (2.0, 0.5)])
def test_owned_hops_are_the_one_card_walks(world, pq):
    """P rank slices, their shares summed in this process, give the walks
    of the one-card plain versions bit for bit (a hub, a dead row, an
    isolated node, pad lanes)."""
    n = 301
    arrays = _weighted(n, 2)
    starts = torch.from_numpy(np.random.default_rng(world).integers(
        0, n + 1, 300).astype(np.int32))
    starts[:4] = torch.tensor([1, 2, n - 1, n], dtype=torch.int32)
    length, seed, base = 8, 2**40 + 9, 17
    if pq is None:
        slices = [twalk.ShardedWalkTables(*arrays[:3], n, r, world, CPU)
                  for r in range(world)]
        want = twalk.walk_uniform_plain(*(torch.from_numpy(a)
                                          for a in (arrays[0], arrays[1],
                                                    arrays[2])),
                                        starts, length, seed, base, n)
        got = twalk.walk_uniform_sharded(slices, starts, length, seed, base)
    else:
        slices = [twalk.ShardedWalkTables(*arrays[:3], n, r, world, CPU,
                                          *arrays[3:]) for r in range(world)]
        t = twalk.WalkTables2(*arrays[:3], n, *arrays[3:], CPU)
        args = (length, float(np.float32(1 / pq[0])),
                float(np.float32(1 / pq[1])), twalk.walk2_tries(pq[1]), seed,
                base)
        want = twalk.walk_p_q_plain(t.indptr, t.cols, t.vals, t.deg, t.wmax,
                                    t.wsum, starts, *args, n)
        got = twalk.walk_p_q_sharded(slices, starts, *args)
    assert got.dtype == torch.int32 and torch.equal(got, want)


def test_owned_p_q_hops_above_4096_lanes():
    """One batch of 4,100 lanes over 3 rank slices: bitwise K12's plain
    version (the JAX package's sharded engine is bitwise its replicated one
    only below 4,096 lanes)."""
    n = 301
    arrays = _weighted(n, 3)
    t = twalk.WalkTables2(*arrays[:3], n, *arrays[3:], CPU)
    slices = [twalk.ShardedWalkTables(*arrays[:3], n, r, 3, CPU, *arrays[3:])
              for r in range(3)]
    starts = torch.from_numpy(np.random.default_rng(4).integers(
        0, n, 4100).astype(np.int32))
    args = (3, 2.0, 0.5, twalk.walk2_tries(2.0), 5, 0)
    assert torch.equal(
        twalk.walk_p_q_sharded(slices, starts, *args),
        twalk.walk_p_q_plain(t.indptr, t.cols, t.vals, t.deg, t.wmax, t.wsum,
                             starts, *args, n))


# ---------------------------------------------------- placement and input
def test_walk_table_mode_is_the_jax_chain(monkeypatch):
    """With the JAX package's batch sizes (the port's own differ by
    design), the same budget and device count give the same placement or
    the same message."""
    monkeypatch.setattr(talg, "_WALK_BATCH", jalg._WALK_BATCH)
    monkeypatch.setattr(talg, "_WALK2_BATCH", jalg._WALK2_BATCH)
    n, nnz = 1_000_000, 11_000_000
    seen = set()
    for second in (False, True):
        for world in (1, 2, 4):
            for gib in (0.05, 0.1, 0.2, 0.3, 0.5, 1.0, 2.0):
                limit = int(gib * (1 << 30))
                try:
                    want = jalg._walk_table_mode("auto", None, n, nnz, second,
                                                 limit=limit,
                                                 n_devices=world)
                except ValueError as e:
                    want = str(e)
                try:
                    got = talg._walk_table_mode("auto", n, nnz, CPU,
                                                second_order=second,
                                                world=world, limit=limit)
                except ValueError as e:
                    got = str(e)
                assert got == want, (second, world, gib)
                seen.add(want if len(want) < 12 else "error")
    assert seen == {"replicated", "sharded", "error"}
    for mode in ("replicated", "sharded"):
        assert talg._walk_table_mode(mode, n, nnz, CPU) == mode
    with pytest.raises(ValueError) as want:
        jalg._walk_table_mode("bogus", None, n, nnz, False)
    with pytest.raises(ValueError) as got:
        talg._walk_table_mode("bogus", n, nnz, CPU)
    assert str(got.value) == str(want.value)
    assert talg._walk_table_mode("auto", n, nnz, CPU) == "replicated"


def test_disk_graph_walk_csr_is_the_jax_one(tmp_path, graph):
    lines = _lines()
    tbuild(lines, COLUMNS, str(tmp_path / "t"))
    jbuild(lines, COLUMNS, str(tmp_path / "j"))
    ours, theirs = DiskGraph(str(tmp_path / "t")), JDiskGraph(
        str(tmp_path / "j"))
    for with_vals in (False, True):
        want = jalg._walk_csr_build_disk(theirs, with_vals, chunk_rows=40)
        got = talg._walk_csr_build_disk(ours, with_vals, chunk_rows=40)
        ram = talg._walk_csr_build(graph, with_vals)
        assert len(got) == len(want) == len(ram)
        for a, b, c in zip(got, want, ram):
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype == c.dtype
                assert np.array_equal(a, b) and np.array_equal(a, c)
            else:
                assert a == b == c
    tbuild_piece(lines, COLUMNS, str(tmp_path / "tp"), 1, 2)
    jbuild_piece(lines, COLUMNS, str(tmp_path / "jp"), 1, 2)
    with pytest.raises(ValueError) as want:
        jalg._walk_csr_build_disk(JDiskGraph(str(tmp_path / "jp")), False)
    with pytest.raises(ValueError) as got:
        talg.embed_deepwalk(DiskGraph(str(tmp_path / "tp")), **KW)
    assert str(got.value) == str(want.value)


def test_sharded_factorization_matches_jax_on_its_ranges(graph, monkeypatch):
    """The JAX package's counts, counted with 4 of its devices and left
    where its counting put them, factorized by both packages' sharded
    factorizations with one sketch."""
    import jax
    import jax.numpy as jnp

    ref = ct.SparseMatrix.from_iterator(iter(_lines()), COLUMNS)
    n, k, seed, oversample = ref.num_entities, 8, 7, 16
    ranges, m = jco.device_pair_counts(
        lambda: jalg._device_walks(ref, 2, 12, seed, resident=True), n, 3,
        passes=5, devices=jax.devices()[:4], gather_home=False)
    ours = ranges_from_jax(ranges)
    omega = np.random.default_rng(seed ^ 0x5EED).standard_normal(
        (n, k + oversample)).astype(np.float32)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype: jnp.asarray(omega))
    want = jpc.sharded_counts_to_embeddings(ranges, m, n, k, seed,
                                            oversample=oversample)
    got = sharded_counts_to_embeddings(ours, m, n, k, seed,
                                       oversample=oversample,
                                       group=make_mesh(device="cpu"))
    assert got.shape == (n, k) and ours == []  # the ranges are consumed
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-4)


# ------------------------------------------------------------ gloo ranks
def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(**extra):
    return dict(os.environ, OMP_NUM_THREADS="1",
                PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""),
                **extra)


_RANK = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
import cleora_tpu_torch as ctt
import cleora_tpu_torch.algorithms as talg
import cleora_tpu_torch.cli as tcli
from cleora_tpu_torch.ops import cooccur as tco
from cleora_tpu_torch.parallel import init_distributed, make_mesh
from cleora_tpu_torch.search import ShardedDeviceIndex

out, work = sys.argv[1], sys.argv[2]
kw, n2v, pass_pairs, lines = json.loads(sys.argv[3])
assert init_distributed(device="cpu")
mesh = make_mesh(device="cpu")
world = mesh.world_size
g = ctt.SparseMatrix.from_iterator(iter(lines), "complex::reflexive::n")
n = g.num_entities
# the native graph builder sets the process's OpenMP thread count
torch.set_num_threads(1)
talg._COOC_PASS_PAIRS = pass_pairs
res = {}
for wt in ("replicated", "sharded"):
    res["w1_" + wt] = np.concatenate(list(talg._device_walks(
        g, 2, 12, 7, batch=64, walk_tables=wt, mesh=mesh)))
    res["w2_" + wt] = np.concatenate(list(talg._device_walks2(
        g, 2, 12, n2v["p"], n2v["q"], 7, batch=64, walk_tables=wt,
        mesh=mesh)))
    for fz in ("device", "sharded"):
        res[f"dw_{wt}_{fz}"] = talg.embed_deepwalk(
            g, n_devices=world, walk_tables=wt, factorization=fz, **kw)
        res[f"n2v_{wt}_{fz}"] = talg.embed_node2vec(
            g, mesh=mesh, walk_tables=wt, factorization=fz, **n2v, **kw)
passes = talg._cooc_passes(g, 2, 12, 3)
ranges, m = tco.device_pair_counts(
    lambda: talg._device_walks(g, 2, 12, 7, batch=64, resident=True,
                               walk_tables="sharded", mesh=mesh),
    n, 3, passes=passes, group=mesh)
res["m_total"] = np.asarray(m)
for s, r in zip(range(mesh.rank, passes, world), ranges):
    res[f"range{s}"] = np.stack([t.numpy() for t in r[:3]])
# a one-process checkpoint resumed here, and this run's own for the parent
real_sweep = tco._run_sweep
def no_sweep(*a, **k):
    raise AssertionError("the counts are on disk: no sweep")
tco._run_sweep = no_sweep
res["resumed"] = np.asarray(talg.embed_deepwalk(
    g, mesh=mesh, checkpoint_dir=f"{work}/from1", factorization="sharded",
    **kw))
tco._run_sweep = real_sweep
res["ckpt"] = np.asarray(talg.embed_deepwalk(
    g, mesh=mesh, checkpoint_dir=f"{work}/w{world}", **kw))
index = ShardedDeviceIndex(g, np.load(f"{work}/table.npy"), mesh=mesh)
res["index"] = np.asarray([[[r["index"], r["similarity"]] for r in row]
                           for row in index.query_batch(
                               np.load(f"{work}/table.npy")[:20], top_k=5)])
res["row"] = np.asarray([[r["index"], r["similarity"]]
                         for r in index.query("n3", top_k=4)])
talg._COOC_PASS_PAIRS = 200_000_000
tcli.main(["embed", "-i", f"{work}/edges.txt", "-o", f"{out}.cli.npz",
           "-d", "8", "-a", "deepwalk", "--sharded", "--backend", "device",
           "--cooccurrence", "device", "--device", "cpu", "--seed", "7"])
np.savez(f"{out}.{mesh.rank}.npz", **res)
# every rank leaves the group together, then exits without the
# interpreter's teardown (a gloo rank can abort there)
dist.barrier()
dist.destroy_process_group()
sys.stdout.flush()
os._exit(0)
"""


def _produce(out_dir):
    """The one-process checkpoint the ranks resume, the retrieval table
    and the CLI's edges, then the 2- and 4-rank runs; the JAX package's
    2- and 4-device indexes meanwhile."""
    g = ctt.SparseMatrix.from_iterator(iter(_lines()), COLUMNS)
    table = np.random.default_rng(3).standard_normal(
        (g.num_entities, 6)).astype(np.float32)
    table[[5, 9]] = table[7]  # exact ties
    talg._COOC_PASS_PAIRS, real = PASS_PAIRS, talg._COOC_PASS_PAIRS
    try:
        ck = out_dir / "ck1"
        talg.embed_deepwalk(g, checkpoint_dir=str(ck), **KW)
    finally:
        talg._COOC_PASS_PAIRS = real
    procs = []
    for world in WORLDS:
        work = out_dir / f"work{world}"
        work.mkdir()
        shutil.copytree(ck, work / "from1")
        np.save(work / "table.npy", table)
        (work / "edges.txt").write_text("\n".join(
            f"a{i % 37} b{(7 * i) % 23}" for i in range(120)) + "\n")
        port = _free_port()
        procs += [subprocess.Popen(
            [sys.executable, "-c", _RANK, str(out_dir / f"w{world}"),
             str(work), json.dumps([KW, N2V, PASS_PAIRS, _lines()])],
            env=_env(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                     MASTER_ADDR="localhost", MASTER_PORT=str(port)),
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(world)]
    try:
        ref = ct.SparseMatrix.from_iterator(iter(_lines()), COLUMNS)
        jax_index = {}
        for world in WORLDS:
            idx = jsearch.ShardedDeviceIndex(ref, table,
                                             mesh=jax_make_mesh(world))
            jax_index[f"index{world}"] = np.asarray(
                [[[r["index"], r["similarity"]] for r in row]
                 for row in idx.query_batch(table[:20], top_k=5)])
            jax_index[f"row{world}"] = np.asarray(
                [[r["index"], r["similarity"]]
                 for r in idx.query("n3", top_k=4)])
        np.savez(str(out_dir / "jax.npz"), **jax_index)
        for p in procs:
            log, _ = p.communicate(timeout=240)
            assert p.returncode == 0, f"rank:\n{log}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)


_WAIT_S = 600


def _once(tmp_path_factory, name, produce):
    """The directory ``produce`` wrote into, made once per test session:
    the first xdist worker to ask makes it, the others wait for it."""
    if "PYTEST_XDIST_WORKER" not in os.environ:
        out = tmp_path_factory.mktemp(name)
        produce(out)
        return out
    out = tmp_path_factory.getbasetemp().parent / name
    try:
        os.close(os.open(f"{out}.lock", os.O_CREAT | os.O_EXCL))
    except FileExistsError:
        deadline = time.monotonic() + _WAIT_S
        while not (out / "done").exists():
            if (out / "failed").exists():
                pytest.fail(f"{name} failed in another worker:\n"
                            + (out / "failed").read_text())
            assert time.monotonic() < deadline, f"{name}: no result"
            time.sleep(0.2)
        return out
    out.mkdir()
    try:
        produce(out)
    except BaseException as err:
        (out / "failed").write_text(repr(err))
        raise
    (out / "done").touch()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = _once(tmp_path_factory, "walks_sharded_runs", _produce)
    ranks = {w: [dict(np.load(str(out / f"w{w}.{r}.npz"))) for r in range(w)]
             for w in WORLDS}
    return out, ranks, dict(np.load(str(out / "jax.npz")))


@pytest.fixture(scope="module")
def one_process(graph):
    """The one-process port's walks, ranges and embeddings."""
    talg._COOC_PASS_PAIRS, real = PASS_PAIRS, talg._COOC_PASS_PAIRS
    try:
        n = graph.num_entities
        passes = talg._cooc_passes(graph, 2, 12, 3)
        ranges, m = tco.device_pair_counts(
            lambda: talg._device_walks(graph, 2, 12, 7, batch=64,
                                       resident=True, device=CPU),
            n, 3, passes=passes)
        return {
            "w1": np.concatenate(list(talg._device_walks(
                graph, 2, 12, 7, batch=64, device=CPU))),
            "w2": np.concatenate(list(talg._device_walks2(
                graph, 2, 12, N2V["p"], N2V["q"], 7, batch=64,
                device=CPU))),
            "dw": talg.embed_deepwalk(graph, **KW),
            "n2v": talg.embed_node2vec(graph, **N2V, **KW),
            "ranges": [np.stack([t.numpy() for t in r[:3]]) for r in ranges],
            "m": m, "passes": passes}
    finally:
        talg._COOC_PASS_PAIRS = real


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_walk_the_one_card_walks(runs, one_process, world):
    for res in runs[1][world]:
        for wt in ("replicated", "sharded"):
            assert np.array_equal(res["w1_" + wt], one_process["w1"]), wt
            assert np.array_equal(res["w2_" + wt], one_process["w2"]), wt


@pytest.mark.parametrize("world", WORLDS)
def test_ranges_stay_on_their_counting_rank(runs, one_process, world):
    """Rank r holds exactly the partitions s with s % P == r, each bitwise
    the one-process range; the unique count is every rank's."""
    passes = one_process["passes"]
    assert passes >= 2 * max(WORLDS)
    for r, res in enumerate(runs[1][world]):
        mine = sorted(int(k[5:]) for k in res if k.startswith("range"))
        assert mine == list(range(r, passes, world))
        for s in mine:
            assert np.array_equal(res[f"range{s}"],
                                  one_process["ranges"][s]), (r, s)
        assert int(res["m_total"]) == one_process["m"]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["dw", "n2v"])
def test_rank_factorizations_match_one_process(runs, one_process, world,
                                               name):
    for res in runs[1][world]:
        for wt in ("replicated", "sharded"):
            for fz in ("device", "sharded"):
                np.testing.assert_allclose(res[f"{name}_{wt}_{fz}"],
                                           one_process[name], rtol=2e-4,
                                           atol=2e-4)


@pytest.mark.parametrize("world", WORLDS)
def test_checkpoints_resume_under_another_rank_count(runs, one_process,
                                                     graph, world,
                                                     monkeypatch):
    """A one-process checkpoint resumes on P ranks, and a P-rank one in
    one process, without counting again."""
    out, ranks, _ = runs
    for res in ranks[world]:
        np.testing.assert_allclose(res["resumed"], one_process["dw"],
                                   rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(res["ckpt"], one_process["dw"],
                                   rtol=2e-4, atol=2e-4)

    def no_sweep(*a, **k):
        raise AssertionError("the counts are on disk: no sweep")

    monkeypatch.setattr(tco, "_run_sweep", no_sweep)
    monkeypatch.setattr(talg, "_COOC_PASS_PAIRS", PASS_PAIRS)
    ck = out / f"work{world}" / f"w{world}"
    got = talg.embed_deepwalk(graph, checkpoint_dir=str(ck),
                              factorization="sharded", **KW)
    np.testing.assert_allclose(got, one_process["dw"], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_index_matches_the_jax_mesh(runs, world):
    """Scores equal to float32 rounding; an index may differ only on a
    score tied within the list."""
    _, ranks, jax_res = runs
    for key in ("index", "row"):
        want = jax_res[f"{key}{world}"]
        for res in ranks[world]:
            got = res[key]
            np.testing.assert_allclose(got[..., 1], want[..., 1], rtol=0,
                                       atol=1e-6)
            for g_row, w_row in zip(got.reshape(-1, *got.shape[-2:]),
                                    want.reshape(-1, *want.shape[-2:])):
                for (gi, gs), (wi, _) in zip(g_row, w_row):
                    assert gi == wi or np.sum(
                        np.abs(w_row[:, 1] - gs) <= 1e-6) > 1, (g_row, w_row)


def test_cli_sharded_deepwalk_runs(runs):
    out, _, _ = runs
    lines = (out / "work2" / "edges.txt").read_text().split("\n")[:-1]
    g = ctt.SparseMatrix.from_iterator(iter(lines),
                                       "complex::reflexive::node")
    want = talg.embed_deepwalk(g, 8, seed=7, backend="device",
                               cooccurrence="device", device="cpu")
    for world in WORLDS:
        got = np.load(str(out / f"w{world}.cli.npz"))
        assert list(got["entity_ids"]) == list(g.entity_ids)
        np.testing.assert_allclose(got["embeddings"], want, rtol=2e-4,
                                   atol=2e-4)
