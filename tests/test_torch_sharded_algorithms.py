"""The port's sharded spectral siblings (cleora_tpu_torch/parallel/
algorithms.py) against the JAX package's, on the CPU.

The graph is tests/test_parallel_algorithms.py's (default_rng(11), 400
nodes, 4,000 edges), with its keyword arguments and its tolerances
(``_assert_matches``: Gram of the rows atol=1e-3, sign-aligned columns
atol=5e-3; the Gram-eigh epilogues match an SVD only up to per-column
signs):

* one shard in this process (``device="cpu"``, no group): each sharded
  function against the JAX package's — ProNE, RandNE and HOPE against
  ``cleora_tpu.algorithms.embed_*(backend="device", n_devices=1)``, NetMF
  and GraRep against its single-device blocked backend with the same
  ``block_rows`` (the JAX package's own tests hold that backend equal to
  its sharded NetMF/GraRep; those abort XLA:CPU workers under six xdist
  workers, ROADMAP.md §C) — and against the port's own single-device
  ``backend="device"`` (RandNE bitwise: the same K5 steps over the same
  values);
* several ranks: one spawned run of 2 gloo ranks and one of 4, each rank a
  fresh process that imports only the port, held against the same JAX
  results (the JAX package's tests hold its 2- and 8-device results to its
  one-device ones at these tolerances; its per-mesh programs compile for
  10-20 s each here, so the JAX side runs each program once, in two helper
  processes and this one at the same time as the ranks, and once per test
  session: under pytest-xdist the first worker to need them makes them
  for all).  The exchange
  each rank takes is the one the JAX package's ``ShardedOp`` chooses on its
  own 2- and 4-device mesh.  ProNE and RandNE also run on a 300-node ring
  from the in-RAM graph, a full DiskGraph and each rank's own piece of a
  sharded build (all bitwise equal), and on a 7-node ring, whose halo
  exchange the JAX package takes, each held against one shard; and
  ``out=`` writes the finalized result bitwise;
* the error strings against the JAX package's, and K5's plain version with
  a separate ``self_`` operand against a numpy restatement.
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import cleora_tpu as ct
import cleora_tpu.algorithms as jalg
import cleora_tpu.parallel.algorithms as jpalg
from cleora_tpu.graph.stream import build_graph_streaming as jbuild
from cleora_tpu.parallel.mesh import make_mesh as jax_make_mesh

import cleora_tpu_torch as ctt
import cleora_tpu_torch.algorithms as talg
import cleora_tpu_torch.graph.stream as tstream
from cleora_tpu_torch.ops.spmm import CsrMatrix, spmm_axpy_plain
from cleora_tpu_torch.parallel import algorithms as palg
from cleora_tpu_torch.parallel import make_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(device="cpu")
NAMES = ("prone", "randne", "hope", "netmf", "grarep")
KW = {
    "prone": dict(feature_dim=16),
    "randne": dict(feature_dim=16, num_iterations=6),
    "hope": dict(feature_dim=16),
    "netmf": dict(feature_dim=16, oversample=24, power_iters=4, seed=3,
                  block_rows=96),
    "grarep": dict(feature_dim=16, max_step=2, oversample=24, power_iters=4,
                   seed=3, block_rows=96),
}
# the JAX references: the sharded program on one device, or the blocked
# single-device backend (block_rows is in KW)
JAX_KW = {name: dict(kw, n_devices=1) if name in ("prone", "randne", "hope")
          else kw for name, kw in KW.items()}
WORLDS = (2, 4)
RING_COLUMNS = "complex::reflexive::n"


def _edges():
    rng = np.random.default_rng(11)
    return rng.integers(0, 400, size=4000), rng.integers(0, 400, size=4000)


def _ring_lines(n=300):
    """An n-node ring with chords of 3."""
    return ([f"n{i} n{(i + 1) % n}" for i in range(n)]
            + [f"n{i} n{(i + 3) % n}" for i in range(0, n, 2)])


# Every row of these graphs reads itself (the clique expansion's self
# loops), so the halo table (P·M rows, M at least the real rows of a full
# shard) is smaller than the all-gathered one only when the first shard is
# not full: n < 8 rows.  The 7-node ring takes the halo exchange on 2 and
# on 4 ranks.
TINY = 7
TINY_KW = {"prone": dict(feature_dim=4), "randne": dict(feature_dim=4,
                                                        num_iterations=6)}


def _sign_align(ref, got):
    s = np.sign(np.sum(ref * got, axis=0))
    s[s == 0] = 1.0
    return got * s


def _assert_matches(ref, got, label, atol=5e-3):
    assert got.shape == ref.shape, label
    assert np.isfinite(got).all(), label
    got = _sign_align(ref, got)
    gr, gg = ref @ ref.T, got @ got.T
    assert np.allclose(gr, gg, atol=1e-3), (
        f"{label}: Gram geometry diverges (max {np.abs(gr - gg).max():.2e})")
    assert np.allclose(ref, got, atol=atol), (
        f"{label}: max delta {np.abs(ref - got).max():.2e}")


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env(**extra):
    return dict(os.environ, OMP_NUM_THREADS="1",
                PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""),
                **extra)


def _wait(procs, label):
    try:
        for p in procs:
            log, _ = p.communicate(timeout=240)
            assert p.returncode == 0, f"{label}:\n{log}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)


# ------------------------------------------------------------ JAX helpers
_JAX = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import cleora_tpu as ct
import cleora_tpu.algorithms as jalg

out, spec = sys.argv[1], json.loads(sys.argv[2])
rng = np.random.default_rng(11)
g = ct.SparseMatrix.from_edge_arrays(rng.integers(0, 400, size=4000),
                                     rng.integers(0, 400, size=4000))
np.savez(out, **{name: getattr(jalg, "embed_" + name)(g, backend="device",
                                                      **kw)
                 for name, kw in spec.items()})
"""


@pytest.fixture(autouse=True)
def _one_torch_thread(request):
    """The port's plain versions on these small shapes run as fast on one
    thread; eight OpenMP threads in each of several xdist workers slowed
    them a hundredfold.  Set per test, after the module's fixtures: the
    native graph builders set the process's OpenMP thread count."""
    request.getfixturevalue("graph")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def graph():
    """The port's graph, CSR equal to the JAX package's."""
    g = ctt.SparseMatrix.from_edge_arrays(*_edges())
    ref = ct.SparseMatrix.from_edge_arrays(*_edges())
    for a, b in zip(g.to_sparse_csr(), ref.to_sparse_csr()):
        assert np.array_equal(a, b)
    return g


# ----------------------------------------------------------- several ranks
_RANK = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist
import cleora_tpu_torch as ctt
import cleora_tpu_torch.algorithms as talg
from cleora_tpu_torch.graph.stream import DiskGraph
from cleora_tpu_torch.parallel import init_distributed, make_mesh
from cleora_tpu_torch.parallel import algorithms as palg

out, ring_dir = sys.argv[1], sys.argv[2]
kw, tiny_kw, tiny_lines = json.loads(sys.argv[3])
assert init_distributed(device="cpu")
mesh = make_mesh(device="cpu")
world = mesh.world_size
rng = np.random.default_rng(11)
g = ctt.SparseMatrix.from_edge_arrays(rng.integers(0, 400, size=4000),
                                      rng.integers(0, 400, size=4000))
lines = [l.rstrip("\n") for l in open(f"{ring_dir}/lines.txt")]
ring = ctt.SparseMatrix.from_iterator(iter(lines), "complex::reflexive::n")
tiny = ctt.SparseMatrix.from_iterator(iter(tiny_lines),
                                      "complex::reflexive::n")
disk = DiskGraph(f"{ring_dir}/full")
piece = DiskGraph(f"{ring_dir}/w{world}.piece{mesh.rank}")
# the native graph builder sets the process's OpenMP thread count; six
# ranks of eight spinning threads each would share the test host's cores
torch.set_num_threads(1)
res = {name: getattr(talg, "embed_" + name)(
    g, backend="device", device="cpu", n_devices=world, **kw[name])
    for name in kw}
res["npy"] = np.asarray(talg.embed_prone(
    g, backend="device", mesh=mesh, out=f"{out}.npy", **kw["prone"]))
# the 300-node ring from the in-RAM graph, the full DiskGraph and this
# rank's piece; the 7-node ring over the halo exchange
for name in ("prone", "randne"):
    for label, source in (("mem", ring), ("disk", disk), ("piece", piece)):
        res[f"ring_{name}_{label}"] = getattr(talg, "embed_" + name)(
            source, backend="device", mesh=mesh, **kw[name])
    res[f"tiny_{name}"] = getattr(talg, "embed_" + name)(
        tiny, backend="device", mesh=mesh, **tiny_kw[name])
res["halo"] = np.array([palg._sharded_op_sym(x, mesh, 4).plan is not None
                        for x in (g, ring, tiny)])
np.savez(f"{out}.{mesh.rank}.npz", **res)
# every rank leaves the group together, then exits without the
# interpreter's teardown, where a gloo rank can abort ("terminate called
# without an active exception") once its results are on disk
dist.barrier()
dist.destroy_process_group()
sys.stdout.flush()
os._exit(0)
"""


def _start_ranks(out_dir):
    """The 2- and 4-rank runs, started at once, writing into ``out_dir``
    (the 300-node ring's DiskGraph and pieces are built here first)."""
    ring_dir = out_dir / "ring"
    ring_dir.mkdir()
    (ring_dir / "lines.txt").write_text("\n".join(_ring_lines()) + "\n")
    tstream.build_graph_streaming(_ring_lines(), RING_COLUMNS,
                                  str(ring_dir / "full"))
    procs = []
    for world in WORLDS:
        for k in range(world):
            tstream.build_graph_streaming_sharded(
                _ring_lines(), RING_COLUMNS,
                str(ring_dir / f"w{world}.piece{k}"), k, world)
        port = _free_port()
        procs += [subprocess.Popen(
            [sys.executable, "-c", _RANK, str(out_dir / f"w{world}"),
             str(ring_dir), json.dumps([KW, TINY_KW, _ring_lines(TINY)])],
            env=_env(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                     MASTER_ADDR="localhost", MASTER_PORT=str(port)),
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(world)]
    return procs


def _produce(out_dir):
    """Everything the comparisons read, at once: the rank runs, HOPE's
    JAX reference in one helper process, NetMF's and GraRep's in another,
    and ProNE's and RandNE's here."""
    procs = _start_ranks(out_dir)
    groups = (("hope",), ("netmf", "grarep"))
    procs += [subprocess.Popen(
        [sys.executable, "-c", _JAX, str(out_dir / f"jax{i}.npz"),
         json.dumps({name: JAX_KW[name] for name in names})],
        env=_env(JAX_PLATFORMS="cpu"), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
        for i, names in enumerate(groups)]
    try:
        g = ct.SparseMatrix.from_edge_arrays(*_edges())
        np.savez(str(out_dir / "jax.npz"), **{
            name: getattr(jalg, f"embed_{name}")(g, backend="device",
                                                 **JAX_KW[name])
            for name in ("prone", "randne")})
    finally:
        _wait(procs, "rank or JAX helper")


_WAIT_S = 600


def _once(tmp_path_factory, name, produce):
    """The directory into which ``produce`` wrote, run once per test
    session: under pytest-xdist every worker that runs a test of this
    module would otherwise repeat the runs, so the first worker to ask
    runs it and the others wait for its result (pytest-xdist's recipe for
    a session fixture: a lock file in the workers' common temporary
    directory)."""
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
    """{"jax": {name: the JAX package's result}, "ranks": {world:
    [per-rank npz]}}."""
    out = _once(tmp_path_factory, "sharded_algorithms_runs", _produce)
    jax = dict(np.load(str(out / "jax.npz")))
    for i in range(2):
        jax.update(np.load(str(out / f"jax{i}.npz")))
    return {"jax": jax,
            "ranks": {world: [np.load(str(out / f"w{world}.{r}.npz"))
                              for r in range(world)] for world in WORLDS}}


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", NAMES)
def test_ranks_match_jax(runs, world, name):
    per_rank = runs["ranks"][world]
    ours = per_rank[0][name]
    for other in per_rank[1:]:  # every rank holds the full result
        assert np.array_equal(other[name], ours)
    _assert_matches(runs["jax"][name], ours, f"{name} world={world}")


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_take_the_jax_exchange(runs, world):
    """Each rank plans the exchange the JAX package's ShardedOp plans on
    its own mesh of as many devices: the all-gather on the random graph
    and the 300-node ring, the halo on the 7-node ring."""
    mesh = jax_make_mesh(world)
    graphs = (ct.SparseMatrix.from_edge_arrays(*_edges()),
              ct.SparseMatrix.from_iterator(iter(_ring_lines()),
                                            RING_COLUMNS),
              ct.SparseMatrix.from_iterator(iter(_ring_lines(TINY)),
                                            RING_COLUMNS))
    want = [jpalg._sharded_op_sym(x, mesh, 4).plan is not None
            for x in graphs]
    assert want == [False, False, True]
    for res in runs["ranks"][world]:
        assert res["halo"].tolist() == want


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_ring_from_disk_pieces_and_halo(runs, world):
    """ProNE and RandNE on the 300-node ring: the in-RAM graph, the full
    DiskGraph and each rank's piece give the same bits on every rank, and
    match one shard; on the 7-node ring, over the halo exchange, too."""
    per_rank = runs["ranks"][world]
    for name in ("prone", "randne"):
        fn = getattr(talg, f"embed_{name}")
        ours = per_rank[0][f"ring_{name}_mem"]
        for res in per_rank:
            for label in ("mem", "disk", "piece"):
                assert np.array_equal(res[f"ring_{name}_{label}"], ours), (
                    name, label)
            assert np.array_equal(res[f"tiny_{name}"],
                                  per_rank[0][f"tiny_{name}"])
        for lines, kw, got in (
                (_ring_lines(), KW[name], ours),
                (_ring_lines(TINY), TINY_KW[name],
                 per_rank[0][f"tiny_{name}"])):
            g = ctt.SparseMatrix.from_iterator(iter(lines), RING_COLUMNS)
            torch.set_num_threads(1)  # the builder set it back
            one = fn(g, backend="device", n_devices=1, **CPU, **kw)
            _assert_matches(one, got, f"{name} world={world} n={len(lines)}")


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_out_npy_is_the_finalized_result(runs, world):
    per_rank = runs["ranks"][world]
    assert all(np.array_equal(res["npy"], per_rank[0]["prone"])
               for res in per_rank)


# ---------------------------------------------------------------- one shard
@pytest.mark.parametrize("name", NAMES)
def test_one_shard_matches_jax(graph, runs, name):
    got = getattr(talg, f"embed_{name}")(graph, backend="device",
                                         n_devices=1, **CPU, **KW[name])
    _assert_matches(runs["jax"][name], got, name)


@pytest.mark.parametrize("name", NAMES)
def test_one_shard_matches_single_device(graph, name):
    fn = getattr(talg, f"embed_{name}")
    single = fn(graph, backend="device", **CPU, **KW[name])
    sharded = fn(graph, backend="device", n_devices=1, **CPU, **KW[name])
    if name == "randne":  # the same K5 steps over the same values
        assert np.array_equal(single, sharded)
    else:
        _assert_matches(single, sharded, name)


def test_one_shard_out_and_mesh(graph, tmp_path):
    """``out=`` streams the finalized result; ``mesh=`` takes a
    ShardGroup and equals ``n_devices=1``."""
    mesh = make_mesh(device="cpu")
    for name in NAMES:
        fn = getattr(talg, f"embed_{name}")
        ref = fn(graph, backend="device", n_devices=1, **CPU, **KW[name])
        path = str(tmp_path / f"{name}.npy")
        got = fn(graph, backend="device", mesh=mesh, out=path, **KW[name])
        assert isinstance(got, np.memmap), name
        assert np.array_equal(np.asarray(got), ref), name


# ------------------------------------------------------------ error strings
def _message(fn, *args, **kw):
    with pytest.raises(ValueError) as info:
        fn(*args, **kw)
    return str(info.value)


def test_hope_beta_check_says_what_jax_says(graph):
    jg = ct.SparseMatrix.from_edge_arrays(*_edges())
    want = _message(jpalg.hope_sharded, jg, 16, beta=50.0, seed=0,
                    oversample=8, power_iters=2, n_devices=2)
    got = _message(talg.embed_hope, graph, feature_dim=16, beta=50.0,
                   backend="device", n_devices=1, **CPU)
    assert got == want and "Neumann" in got


@pytest.fixture(scope="module")
def pieces(tmp_path_factory):
    """One piece (the first half of the rows) of the ring's sharded build,
    by each package."""
    out = tmp_path_factory.mktemp("pieces")
    n = tstream.count_entities_streaming(_ring_lines(), RING_COLUMNS)
    kw = dict(row_range=(0, n // 2))
    return (jbuild(_ring_lines(), RING_COLUMNS, str(out / "jax"), **kw),
            tstream.build_graph_streaming(_ring_lines(), RING_COLUMNS,
                                          str(out / "port"), **kw))


@pytest.mark.parametrize("name", ["hope", "netmf", "grarep"])
def test_transposed_operators_reject_pieces_as_jax_does(pieces, name):
    jpiece, piece = pieces
    args = {"hope": (16, 0.01, 3, 8, 2), "netmf": (16, 5, 1.0, 3, 8, 2),
            "grarep": (16, 2, 3, 8, 2)}[name]
    want = _message(getattr(jpalg, f"{name}_sharded"), jpiece, *args,
                    n_devices=2)
    got = _message(getattr(palg, f"{name}_sharded"), piece, *args,
                   n_devices=1, **CPU)
    assert got == want and "TRANSPOSED" in got


@pytest.mark.parametrize("name", ["prone", "randne"])
def test_piece_without_a_group_says_what_jax_says(pieces, name):
    jpiece, piece = pieces
    args = {"prone": (16, 0.2, 0.5, 3), "randne": (16, [1.0, 0.5], 3)}[name]
    want = _message(getattr(jpalg, f"{name}_sharded"), jpiece, *args,
                    n_devices=2)
    got = _message(getattr(palg, f"{name}_sharded"), piece, *args, **CPU)
    assert got == want and "piece" in got


# ------------------------------------------------------- K5 with self_
@pytest.mark.parametrize("d", [8, 256, 300])
@pytest.mark.parametrize("case", ["chebyshev", "bare", "randne"])
def test_spmm_axpy_plain_with_self_matches_numpy(d, case):
    """A 300-row gather table under a 200-row CSR, as the sharded siblings
    give K5: the SpMM gathers from the table, ``b·self_`` reads the
    shard's own rows (cleora_tpu/parallel/algorithms.py:440-449)."""
    n, n_table = 200, 300
    rng = np.random.default_rng(d)
    deg = rng.poisson(5, size=n)
    deg[3] = 0
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    rows = np.repeat(np.arange(n), deg)
    cols = rng.integers(0, n_table, size=rows.size)
    vals = (rng.random(rows.size) / 4).astype(np.float32)
    table, own, z, acc = (rng.standard_normal((m, d)).astype(np.float32)
                          for m in (n_table, n, n, n))
    nx = np.zeros((n, d), np.float32)
    np.add.at(nx, rows, vals[:, None] * table[cols])
    csr = CsrMatrix(torch.from_numpy(indptr),
                    torch.from_numpy(cols.astype(np.int32)),
                    torch.from_numpy(vals))
    t_table, t_own, tz, tacc = (torch.from_numpy(a.copy())
                                for a in (table, own, z, acc))
    if case == "chebyshev":  # parallel/algorithms.py:449, :451
        coeff = np.float32(0.07)
        out = spmm_axpy_plain(csr, t_table, -2.0, 2.0, z=tz, c=-1.0,
                              acc=tacc, d=float(coeff), self_=t_own)
        want = np.float32(2.0) * (own - nx) - z
        want_acc = acc + coeff * want
    elif case == "bare":  # L·R = R − N·R, parallel/algorithms.py:441
        out = spmm_axpy_plain(csr, t_table, -1.0, 1.0, self_=t_own)
        want, want_acc = own - nx, acc
    else:  # b = 0: self_ is not read
        out = spmm_axpy_plain(csr, t_table, 1.0, acc=tacc, d=0.25,
                              self_=t_own)
        want, want_acc = nx, acc + np.float32(0.25) * nx
    assert out.shape == (n, d)
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tacc.numpy(), want_acc, rtol=0, atol=1e-6)
    assert np.array_equal(t_table.numpy(), table)
    assert np.array_equal(t_own.numpy(), own)
