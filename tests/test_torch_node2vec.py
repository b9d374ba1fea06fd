"""The port's second-order (Node2Vec p/q) walk pipeline against the JAX
package's, on the CPU.

The port runs ``backend="device", device="cpu"``: kernel K12's plain
version, ``ops/walk.py:walk_p_q_plain``, then the counting and
factorization that DeepWalk uses.  The JAX package runs its device programs
on its CPU platform.  The port's walks draw from Philox and the JAX
package's from jax.random, so the two are matched in law: a χ² test holds
both samplers' second hops to the exact transition probabilities of the
reference's host walker (``w·α / Σ w·α`` in float64), and on a corpus of
more than 5 M pairs the unique pair counts agree within 1 %.

Tolerances: walks, counts and fingerprints exact; χ² p-value ≥ 1e-3 at
fixed seeds; community recovery within 0.05 of the JAX package's.
"""

import os

import numpy as np
import pytest
import torch
from scipy.stats import chisquare

import cleora_tpu as ct
import cleora_tpu.algorithms as jalg
import cleora_tpu_torch.algorithms as talg
from cleora_tpu_torch import kernels
from cleora_tpu_torch.convert import from_jax_state
from cleora_tpu_torch.kernels import build
from cleora_tpu_torch.ops import cooccur as tco
from cleora_tpu_torch.ops import memory
from cleora_tpu_torch.ops import walk as twalk

CPU = torch.device("cpu")
PQ = [(0.25, 4.0), (4.0, 0.25), (0.5, 2.0), (1.0, 100.0)]


@pytest.fixture(scope="module")
def graphs():
    rng = np.random.default_rng(11)
    lines = [f"n{rng.integers(0, 150)} n{rng.integers(0, 150)}"
             for _ in range(900)]
    ref = ct.SparseMatrix.from_iterator(iter(lines), "complex::reflexive::n")
    return ref, from_jax_state(ref.__getstate__())


def _walks2(g, p=0.5, q=2.0, num_walks=3, walk_length=10, seed=5,
            batch=64):
    return np.concatenate(list(talg._device_walks2(
        g, num_walks, walk_length, p, q, seed, batch=batch, device="cpu")))


# ------------------------------------------------------------- the sampler
def _triangle_graph():
    """A weighted undirected graph with the triangles (0, 1, 2), (1, 2, 3)
    and (2, 3, 4) and a path 0-5-6-4: as a neighbour dict and as the walk
    CSR (rows (row, col)-sorted)."""
    edges = [(0, 1, 1.0), (0, 2, 2.0), (1, 2, 0.5), (1, 3, 3.0), (2, 3, 1.0),
             (2, 4, 1.5), (3, 4, 2.0), (0, 5, 1.0), (5, 6, 0.7), (4, 6, 1.2)]
    n = 7
    adj = {i: {} for i in range(n)}
    for a, b, w in edges:
        adj[a][b] = adj[b][a] = w
    rows = np.array([r for r in range(n) for _ in adj[r]])
    cols = np.array([c for r in range(n) for c in sorted(adj[r])], np.int32)
    vals = np.array([adj[r][c] for r in range(n) for c in sorted(adj[r])],
                    np.float32)
    deg = np.bincount(rows, minlength=n).astype(np.int32)
    indptr = np.concatenate([[0], np.cumsum(deg)[:-1]]).astype(np.int32)
    wmax = np.zeros(n, np.float32)
    np.maximum.at(wmax, rows, vals)
    wsum = np.zeros(n)
    np.add.at(wsum, rows, vals.astype(np.float64))
    return adj, (indptr, cols, vals, deg, wmax, wsum.astype(np.float32)), n


def _second_hop_law(adj, s, p, q):
    """P(first hop = cur, second hop = x) from ``s``: a uniform first hop,
    then the reference's ``w·α / Σ w·α`` (algorithms.py:_random_walks)."""
    law = {}
    for cur in sorted(adj[s]):
        nbrs = sorted(adj[cur])
        w = np.array([adj[cur][x] for x in nbrs])
        alpha = np.array([1.0 / p if x == s else
                          (1.0 if x in adj[s] else 1.0 / q) for x in nbrs])
        probs = w * alpha / np.sum(w * alpha)
        for x, pr in zip(nbrs, probs):
            law[(cur, x)] = pr / len(adj[s])
    return law


def _chi_square(walks, law):
    cells = sorted(law)
    observed = np.array([np.sum((walks[:, 1] == a) & (walks[:, 2] == b))
                         for a, b in cells])
    assert observed.sum() == walks.shape[0]
    expected = np.array([law[c] for c in cells]) * walks.shape[0]
    return chisquare(observed, expected).pvalue


@pytest.mark.parametrize("p,q", PQ)
@pytest.mark.parametrize("start", [2, 5])
def test_second_hops_follow_the_exact_law_chi_square(p, q, start):
    """Both samplers against the exact Node2Vec transition law."""
    import jax
    import jax.numpy as jnp

    adj, tabs, n = _triangle_graph()
    law = _second_hop_law(adj, start, p, q)
    walks = 20_000
    t = twalk.WalkTables2(tabs[0], tabs[1], tabs[3], n, tabs[2], tabs[4],
                          tabs[5], CPU)
    ours = twalk.walk_p_q_plain(
        t.indptr, t.cols, t.vals, t.deg, t.wmax, t.wsum,
        torch.full((walks,), start, dtype=torch.int32), 3, 1.0 / p, 1.0 / q,
        twalk.walk2_tries(q), 5, 0, n).numpy()
    assert _chi_square(ours, law) >= 1e-3
    indptr, cols, vals, deg, wmax, wsum = (jnp.asarray(a) for a in tabs)
    theirs = np.asarray(jalg._device_walk2_jit()(
        indptr, cols, vals, deg, wmax, wsum,
        jnp.full((walks,), start, jnp.int32), jax.random.PRNGKey(5),
        jnp.float32(1.0 / p), jnp.float32(1.0 / q), walk_length=3, n_rows=n,
        tries=twalk.walk2_tries(q), bsteps=3, chunk=1))
    assert _chi_square(theirs, law) >= 1e-3


def test_tries_and_batch_follow_the_jax_rules():
    for q in (0.1, 1.0, 7.9, 8.1, 100.0, 1e4):
        jax_tries = int(min(jalg._WALK2_TRIES_CAP,
                            max(jalg._WALK2_TRIES, np.ceil(8.0 * q))))
        assert twalk.walk2_tries(q) == jax_tries
    assert twalk.WALK2_TRIES == jalg._WALK2_TRIES
    assert twalk.WALK2_TRIES_CAP == jalg._WALK2_TRIES_CAP
    assert talg._WALK2_BATCH == talg._WALK_BATCH // 2


@pytest.mark.parametrize("p,q", PQ)
def test_every_hop_is_an_edge_of_the_walk_csr(graphs, p, q):
    _, g = graphs
    indptr, cols, deg, n = talg._walk_csr(g)
    w = _walks2(g, p, q)
    starts = np.nonzero(deg > 0)[0]
    assert w.dtype == np.int32 and w.shape == (3 * starts.size, 10)
    assert np.array_equal(w[:, 0], np.tile(starts, 3))
    for row in w:
        for a, b in zip(row[:-1], row[1:]):
            if a == n:
                assert b == n  # the sentinel is sticky
            else:
                assert b != n and b in cols[indptr[a]:indptr[a] + deg[a]]


def test_a_dead_row_stops_the_walk_as_in_jax():
    """tests/test_algorithms.py::test_device_walk2_dead_row_terminates's
    graph: 0 → 1 (weight 1), 1 → 2 (weight 0); every walk stops at 1."""
    import jax
    import jax.numpy as jnp

    tabs = (np.array([0, 1, 2]), np.array([1, 2]), np.array([1.0, 0.0]),
            np.array([1, 1, 0]), np.array([1.0, 0.0, 0.0]),
            np.array([1.0, 0.0, 0.0]))
    t = twalk.WalkTables2(tabs[0], tabs[1], tabs[3], 3, tabs[2], tabs[4],
                          tabs[5], CPU)
    starts = torch.zeros(8, dtype=torch.int32)
    ours = twalk.walk_p_q(t.indptr, t.cols, t.vals, t.deg, t.wmax, t.wsum,
                          starts, 4, 1.0, 1.0, 8, 0, 0, 3).numpy()
    ip, cols, vals, deg, wmax, wsum = (
        jnp.asarray(a, dtype=jnp.float32 if a.dtype == np.float64
                    else jnp.int32) for a in tabs)
    theirs = np.asarray(jalg._device_walk2_jit()(
        ip, cols, vals, deg, wmax, wsum, jnp.zeros(8, jnp.int32),
        jax.random.PRNGKey(0), jnp.float32(1.0), jnp.float32(1.0),
        walk_length=4, n_rows=3, tries=8, bsteps=2, chunk=4))
    assert np.array_equal(ours, theirs)
    assert np.array_equal(ours, np.tile([0, 1, 3, 3], (8, 1)))


def test_pad_lanes_and_dead_ends_emit_the_sentinel():
    # 0 -> 1 -> 2 (dead end); a pad lane starts at n = 3
    t = twalk.WalkTables2(np.array([0, 1, 2]), np.array([1, 2]),
                          np.array([1, 1, 0]), 3, np.ones(2), np.ones(3),
                          np.ones(3), CPU)
    starts = torch.tensor([0, 3, 2], dtype=torch.int32)
    w = twalk.walk_p_q(t.indptr, t.cols, t.vals, t.deg, t.wmax, t.wsum,
                       starts, 5, 2.0, 0.5, 64, 1, 0, 3)
    assert w.tolist() == [[0, 1, 2, 3, 3], [3, 3, 3, 3, 3], [2, 3, 3, 3, 3]]


def test_walks_do_not_depend_on_the_batch_size(graphs):
    _, g = graphs
    a = _walks2(g, batch=64)
    b = _walks2(g, batch=1 << 15)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, _walks2(g, seed=6))
    # the second-order stream is apart from the first-order one
    first = np.concatenate(list(talg._device_walks(g, 3, 10, 5, batch=64,
                                                   device="cpu")))
    assert not np.array_equal(_walks2(g, p=1.0, q=1.0), first)


def test_host_and_device_counting_are_integer_equal(graphs):
    _, g = graphs
    n = g.num_entities
    keys, counts = talg._walk_pair_counts(
        talg._device_walks2(g, 3, 10, 0.5, 2.0, 5, batch=64, device="cpu"),
        n, 5)
    ranges, m = tco.device_pair_counts(
        lambda: talg._device_walks2(g, 3, 10, 0.5, 2.0, 5, batch=64,
                                    resident=True, device="cpu"),
        n, 5, passes=3, device=CPU)
    cen = torch.cat([r[0] for r in ranges]).long()
    ctx = torch.cat([r[1] for r in ranges]).long()
    cnt = torch.cat([r[2] for r in ranges]).long()
    dkeys = (cen * n + ctx).numpy()
    order = np.argsort(dkeys)
    assert m == keys.shape[0]
    assert np.array_equal(dkeys[order], keys)
    assert np.array_equal(cnt.numpy()[order], counts)


def test_unique_pairs_match_the_jax_package_on_a_5m_pair_corpus():
    rng = np.random.default_rng(2)
    n = 5000
    ref = ct.SparseMatrix.from_edge_arrays(rng.integers(0, n, 25_000),
                                           rng.integers(0, n, 25_000))
    g = from_jax_state(ref.__getstate__())
    args = (3, 40, 0.5, 2.0, 0)
    ours = talg._walk_pair_counts(
        talg._device_walks2(g, *args, device="cpu"), g.num_entities, 5)
    theirs = talg._walk_pair_counts(
        jalg._device_walks2(ref, *args, batch=16_384), ref.num_entities, 5)
    pairs = int(ours[1].sum())
    assert pairs >= 5_000_000 and pairs == int(theirs[1].sum())
    assert abs(ours[0].shape[0] / theirs[0].shape[0] - 1) <= 0.01


# -------------------------------------------------------------- entry point
def _planted(n, communities, deg_in, deg_out, rng):
    """scripts/walk_quality_probe.py's planted-partition generator."""
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


def _centroid_accuracy(emb, labels, rng, train_frac=0.5):
    """scripts/walk_quality_probe.py's nearest-centroid accuracy."""
    n = emb.shape[0]
    normed = emb / np.maximum(
        np.linalg.norm(emb, axis=1, keepdims=True), 1e-10)
    perm = rng.permutation(n)
    tr, te = perm[: int(n * train_frac)], perm[int(n * train_frac):]
    cents = np.zeros((labels.max() + 1, emb.shape[1]))
    for c in range(cents.shape[0]):
        rows = tr[labels[tr] == c]
        if rows.size:
            cents[c] = normed[rows].mean(axis=0)
    cents /= np.maximum(np.linalg.norm(cents, axis=1, keepdims=True), 1e-10)
    pred = np.argmax(normed[te] @ cents.T, axis=1)
    return float(np.mean(pred == labels[te]))


def test_device_node2vec_recovers_planted_communities_like_jax():
    src, dst, comm = _planted(300, 6, 6, 1, np.random.default_rng(3))
    ref = ct.SparseMatrix.from_edge_arrays(src, dst)
    g = from_jax_state(ref.__getstate__())
    labels = comm[np.array([int(e) for e in ref.entity_ids])]
    kw = dict(feature_dim=16, num_walks=4, walk_length=20, p=0.5, q=2.0,
              backend="device", cooccurrence="device")
    want = _centroid_accuracy(jalg.embed_node2vec(ref, **kw), labels,
                              np.random.default_rng(1))
    got = _centroid_accuracy(talg.embed_node2vec(g, device="cpu", **kw),
                             labels, np.random.default_rng(1))
    assert got >= 0.95 and want >= 0.95 and abs(got - want) <= 0.05


@pytest.mark.parametrize("kw", [
    dict(cooccurrence="device"),
    dict(factorization="device"),
    dict(),
])
def test_every_counting_and_factorization_mode_gives_unit_rows(graphs, kw):
    _, g = graphs
    e = talg.embed_node2vec(g, feature_dim=16, num_walks=2, walk_length=10,
                            p=0.5, q=2.0, backend="device", device="cpu",
                            **kw)
    assert e.shape == (g.num_entities, 16) and e.dtype == np.float32
    norms = np.linalg.norm(e, axis=1)
    assert np.all((np.abs(norms - 1) < 1e-5) | (norms < 1e-6))


def test_wrappers_run_plain_versions_on_cpu_and_launch_nothing(graphs):
    _, g = graphs
    kernels.reset_launches()
    talg.embed_node2vec(g, feature_dim=8, num_walks=1, walk_length=6, p=2.0,
                        backend="device", cooccurrence="device",
                        device="cpu")
    assert kernels.LAUNCHES == dict.fromkeys(build.KERNELS, 0)


@pytest.mark.parametrize("kw", [
    dict(mesh=object()),
    dict(n_devices=2),
    dict(walk_tables="sharded"),
    dict(cooccurrence="device", factorization="sharded"),
])
def test_multi_gpu_arguments_raise_not_implemented(graphs, kw):
    """The multi-GPU arguments of the p/q walk (queue A item 8, ported):
    ``n_devices=2`` without a process group names torchrun, a ``mesh=``
    that is no ``ShardGroup`` is refused, and the sharded tables (K18's
    stages) and the sharded factorization run on one shard, bitwise the
    one-card result."""
    _, g = graphs
    base = dict(feature_dim=8, backend="device", device="cpu", num_walks=1,
                walk_length=5, p=0.5, q=2.0)
    error = {"mesh": (TypeError, "ShardGroup"),
             "n_devices": (ValueError, "torchrun --nproc-per-node 2")}.get(
                 next(iter(kw)))
    if error is not None:
        with pytest.raises(error[0], match=error[1]):
            talg.embed_node2vec(g, **base, **kw)
        return
    want = talg.embed_node2vec(g, **base, cooccurrence=kw.get(
        "cooccurrence", "host"))
    assert np.array_equal(talg.embed_node2vec(g, **base, **kw), want)


# ---------------------------------------------------------------- lifecycle
def test_checkpoint_resumes_and_the_fingerprint_takes_the_weights(
        graphs, tmp_path, monkeypatch):
    ref, g = graphs
    sweeps = []
    real_sweep = tco._run_sweep

    def counting_sweep(*args, **kwargs):
        sweeps.append(1)
        return real_sweep(*args, **kwargs)

    monkeypatch.setattr(tco, "_run_sweep", counting_sweep)
    ckpt = str(tmp_path / "ckpt")
    kw = dict(feature_dim=8, num_walks=2, walk_length=10, p=0.5, q=2.0,
              backend="device", cooccurrence="device", device="cpu",
              checkpoint_dir=ckpt)
    first = np.array(talg.embed_node2vec(g, **kw))
    out = os.path.join(ckpt, "embedding.npy")
    assert len(sweeps) == 1
    os.remove(os.path.join(ckpt, "embedding.json"))
    os.remove(out)
    resumed = talg.embed_node2vec(g, **kw)
    assert len(sweeps) == 1 and np.array_equal(np.asarray(resumed), first)
    # the same edges with other weights: another corpus, counted anew
    rng = np.random.default_rng(11)
    s = rng.integers(0, 150, 900)
    d = rng.integers(0, 150, 900)
    g1 = from_jax_state(ct.SparseMatrix.from_edge_arrays(s, d).__getstate__())
    g2 = from_jax_state(ct.SparseMatrix.from_edge_arrays(
        np.append(s, s[0]), np.append(d, d[0])).__getstate__())
    a, b = talg._walk_csr(g1, True), talg._walk_csr(g2, True)
    assert np.array_equal(a[1], b[1]) and not np.array_equal(a[4], b[4])
    ckpt2 = str(tmp_path / "ckpt2")
    talg.embed_node2vec(g1, **dict(kw, checkpoint_dir=ckpt2))
    os.remove(os.path.join(ckpt2, "embedding.json"))
    talg.embed_node2vec(g2, **dict(kw, checkpoint_dir=ckpt2))
    assert len(sweeps) == 3
    # the fingerprint names the port's second-order engine, never JAX's
    params = dict(window=5, passes=1, n=g.num_entities, seed=0, num_walks=2,
                  walk_length=10, p=0.5, q=2.0)
    ours = talg._walk_fingerprint(g, True,
                                  dict(params, engine=talg._WALK2_ENGINE))
    theirs = jalg._walk_fingerprint(ref, True, dict(params, engine="walk2"))
    assert talg._WALK2_ENGINE not in ("walk2", talg._WALK_ENGINE)
    assert ours != theirs


def _smallest_fitting_limit(refuses) -> int:
    """The least device budget that ``refuses(limit)`` accepts, by
    bisection (every budget below it is refused)."""
    lo, hi = 1, 1 << 50
    assert refuses(lo) and not refuses(hi)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if refuses(mid):
            lo = mid
        else:
            hi = mid
    return hi


def test_fit_check_accepts_and_refuses_at_the_jax_limits(monkeypatch):
    n, nnz = 1_000_000, 11_000_000

    def jax_refuses(second, limit):
        try:
            jalg._walk_table_mode("auto", None, n, nnz, second, limit=limit)
        except ValueError as e:
            assert "walk tables need" in str(e)
            return True
        return False

    def port_refuses(second, limit):
        monkeypatch.setattr(memory, "device_memory_limit",
                            lambda dev: limit)
        try:
            talg._walk_table_mode("auto", n, nnz, CPU, second_order=second)
        except ValueError as e:
            assert "walk tables need" in str(e)
            return True
        return False

    for second in (False, True):
        want = _smallest_fitting_limit(lambda v: jax_refuses(second, v))
        # the port's batch term differs from JAX's by design; with JAX's
        # batches the two checks accept and refuse at the same budget, so
        # the tables (the walk2 weights 4*nnz + 12*n included) are counted
        # alike to the byte
        with monkeypatch.context() as m:
            m.setattr(talg, "_WALK_BATCH", jalg._WALK_BATCH)
            m.setattr(talg, "_WALK2_BATCH", jalg._WALK2_BATCH)
            assert _smallest_fitting_limit(
                lambda v: port_refuses(second, v)) == want
        # with its own batch, the port's need moves by exactly the batch
        # buffers' difference, 3 * (B_port - B_jax) * 4 * 80 bytes
        got = _smallest_fitting_limit(lambda v: port_refuses(second, v))
        ours, theirs = ((talg._WALK2_BATCH, jalg._WALK2_BATCH) if second
                        else (talg._WALK_BATCH, jalg._WALK_BATCH))
        assert abs((got - want) * 0.9 - 3 * (ours - theirs) * 320) <= 2
        # a budget that both refuse: the same message, the same table size
        monkeypatch.setattr(memory, "device_memory_limit",
                            lambda dev: 1 << 20)
        with pytest.raises(ValueError) as got:
            talg._walk_table_mode("auto", n, nnz, CPU, second_order=second)
        with pytest.raises(ValueError) as want:
            jalg._walk_table_mode("auto", None, n, nnz, second,
                                  limit=1 << 20)
        assert str(got.value) == str(want.value)
    # the sharded tables (queue A item 8) are taken as asked for
    assert talg._walk_table_mode("sharded", n, nnz, CPU,
                                 second_order=True) == "sharded"
