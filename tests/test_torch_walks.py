"""The port's walk pipeline (DeepWalk, Node2Vec with p = q = 1) against the
JAX package's, on the CPU (the second-order walk: test_torch_node2vec.py).

A seeded 150-node graph (the fixture of ``tests/test_cooccur_device.py``)
and a planted-partition graph of 300 nodes are built by the JAX package and
carried into the port with ``from_jax_state``.  The port runs
``backend="device", device="cpu"`` (the kernels' plain versions); the JAX
package runs its device programs on its CPU platform.

The port's walks draw from Philox and the JAX package's from jax.random, so
walks are compared with the port's own invariants (every hop an edge,
sentinels, batch independence, a χ² test against uniform hops) and the
counting is compared on one numpy walk matrix fed to both packages.

Tolerances:

- walk CSR, walks, pair counts, ranges, PPMI rows and columns: bitwise;
- PPMI values: rtol=1e-6 (the same float32 operations in the same order;
  the two logf libraries may differ in the last bit);
- the randomized SVD and the factorizations, on the same counts and the
  same numpy omega: the Gram matrix of the unit-row embeddings, atol=1e-4
  (float32 products summed in another order, QR and SVD from other
  libraries; the signs are canonical but a near-degenerate direction may
  rotate); the host factorization (ARPACK, float64, the same code): 1e-6;
- host backends: the same numpy code and RNG stream, exactly equal;
- community recovery on the planted graph: both ≥ 0.95, within 0.05.
"""

import inspect
import os

import numpy as np
import pytest
import torch

import cleora_tpu as ct
import cleora_tpu.algorithms as jalg
import cleora_tpu_torch.algorithms as talg
from cleora_tpu.ops import cooccur as jco
from cleora_tpu_torch import kernels
from cleora_tpu_torch.convert import from_jax_state, ranges_from_jax
from cleora_tpu_torch.ops import cooccur as tco
from cleora_tpu_torch.ops import walk as twalk
from torch_test_support import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def graphs():
    rng = np.random.default_rng(11)
    lines = [f"n{rng.integers(0, 150)} n{rng.integers(0, 150)}"
             for _ in range(900)]
    ref = ct.SparseMatrix.from_iterator(iter(lines), "complex::reflexive::n")
    return ref, from_jax_state(ref.__getstate__())


def planted_edges(n, communities, deg_in, deg_out, rng):
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


def _walk_matrix(g, num_walks=3, walk_length=10, seed=5):
    return np.concatenate(list(talg._device_walks(
        g, num_walks, walk_length, seed, batch=64, device="cpu")))


def _gram(e):
    e = np.asarray(e, dtype=np.float64)
    return e @ e.T


# ------------------------------------------------------------------ walk CSR
@pytest.mark.parametrize("with_vals", [False, True])
def test_walk_csr_is_the_jax_one_bitwise(graphs, with_vals):
    ref, g = graphs
    want = jalg._walk_csr(ref, with_vals=with_vals)
    got = talg._walk_csr(g, with_vals=with_vals)
    assert len(got) == len(want) and got[3] == want[3]
    for a, b in zip(got, want):
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert talg._walk_csr(g, with_vals=with_vals) is got  # cached


# -------------------------------------------------------------------- walks
def test_philox_known_answer():
    """Random123's known-answer vector for Philox4x32-10."""
    z = torch.zeros(1, dtype=torch.int64)
    got = [int(w) for w in twalk.philox4x32(z, z, z, z, 0, 0)]
    assert got == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    m = torch.tensor([0xFFFFFFFF], dtype=torch.int64)
    got = [int(w) for w in twalk.philox4x32(m, m, m, m, 0xFFFFFFFF,
                                            0xFFFFFFFF)]
    assert got == [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]


def test_every_hop_is_an_edge_of_the_walk_csr(graphs):
    _, g = graphs
    indptr, cols, deg, n = talg._walk_csr(g)
    w = _walk_matrix(g)
    starts = np.nonzero(deg > 0)[0]
    assert w.dtype == np.int32 and w.shape == (3 * starts.size, 10)
    assert np.array_equal(w[:, 0], np.tile(starts, 3))
    for row in w:
        for a, b in zip(row[:-1], row[1:]):
            if a == n:
                assert b == n  # the sentinel is sticky
            elif b != n:
                assert b in cols[indptr[a]:indptr[a] + deg[a]]
            else:
                assert deg[a] == 0


def test_walks_do_not_depend_on_the_batch_size(graphs):
    _, g = graphs
    a = np.concatenate(list(talg._device_walks(g, 3, 10, 5, batch=64,
                                               device="cpu")))
    b = np.concatenate(list(talg._device_walks(g, 3, 10, 5, batch=1 << 15,
                                               device="cpu")))
    assert np.array_equal(a, b)
    c = np.concatenate(list(talg._device_walks(g, 3, 10, 6, batch=64,
                                               device="cpu")))
    assert not np.array_equal(a, c)


def test_dead_ends_and_pad_lanes_emit_the_sentinel():
    # 0 -> 1 -> 2 (dead end), 3 -> 0; a pad lane starts at n = 4
    tables = twalk.WalkTables(np.array([0, 1, 2, 2]), np.array([1, 2, 0]),
                              np.array([1, 1, 0, 1]), 4, CPU)
    starts = torch.tensor([0, 3, 2, 4], dtype=torch.int32)
    w = twalk.walk_uniform(tables, starts, 6, seed=1, base=0)
    assert w.tolist() == [[0, 1, 2, 4, 4, 4], [3, 0, 1, 2, 4, 4],
                          [2, 4, 4, 4, 4, 4], [4, 4, 4, 4, 4, 4]]
    with pytest.raises(ValueError, match="column index out of range"):
        twalk.WalkTables(np.array([0]), np.array([1]), np.array([1]), 1, CPU)
    with pytest.raises(ValueError, match="row outside cols"):
        twalk.WalkTables(np.array([0, 1]), np.array([1]), np.array([1, 1]),
                         2, CPU)


def test_next_hop_is_uniform_chi_square():
    from scipy.stats import chisquare

    d, walks = 37, 20_000
    tables = twalk.WalkTables(np.zeros(d + 1, np.int32),
                              np.arange(1, d + 1, dtype=np.int32),
                              np.array([d] + [0] * d), d + 1, CPU)
    starts = torch.zeros(walks, dtype=torch.int32)
    w = twalk.walk_uniform(tables, starts, 2, seed=3, base=0)
    counts = np.bincount(w[:, 1].numpy(), minlength=d + 1)[1:]
    assert counts.sum() == walks
    assert chisquare(counts).pvalue > 1e-3


def test_resident_batches_stay_on_the_device_with_no_pad(graphs):
    _, g = graphs
    got = list(talg._device_walks(g, 3, 10, 5, batch=64, resident=True,
                                  device="cpu"))
    assert all(isinstance(w, torch.Tensor) and pad == 0 for w, pad in got)
    assert np.array_equal(torch.cat([w for w, _ in got]).numpy(),
                          _walk_matrix(g))


# ------------------------------------------------------------------ counting
def _both_counts(graphs, passes, batch):
    """The same numpy walk matrix counted by both packages, fed as
    resident batches (the JAX side padded as its engine pads them)."""
    import jax.numpy as jnp

    _, g = graphs
    n = g.num_entities
    w = _walk_matrix(g)
    chunks = [w[i:i + batch] for i in range(0, w.shape[0], batch)]

    def jax_batches():
        for lo, c in zip(range(0, w.shape[0], batch), chunks):
            pad = jalg._lane_pad(c.shape[0], batch, lo, None)
            c = np.concatenate([c, np.full((pad, c.shape[1]), n, np.int32)])
            yield jnp.asarray(c), pad

    def port_batches():
        for c in chunks:
            yield torch.from_numpy(c), 0

    jr, jm = jco.device_pair_counts(jax_batches, n, 3, passes=passes)
    tr, tm = tco.device_pair_counts(port_batches, n, 3, passes=passes,
                                    device="cpu")
    return w, jr, jm, tr, tm


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("batch", [64, 1 << 15])
def test_device_pair_counts_equal_the_jax_ones(graphs, passes, batch):
    """Partition for partition, key for key, count for count; and equal
    to the host sort-reduce of both packages.  Batch 64 forces pad lanes on
    the JAX side and 7 chain merges per partition."""
    w, jr_raw, jm, tr, tm = _both_counts(graphs, passes, batch)
    n = graphs[1].num_entities
    jr = ranges_from_jax([tuple(np.asarray(a) for a in r[:3]) + (r[3],)
                          for r in jr_raw])
    assert jm == tm and len(jr) == len(tr) == passes
    for s, (a, b) in enumerate(zip(jr, tr)):
        assert a[3] == b[3]
        for x, y in zip(a[:3], b[:3]):
            assert y.dtype == torch.int32 and torch.equal(x, y)
        assert torch.all(b[0] % passes == s)
    keys = np.concatenate([r[0].numpy().astype(np.int64) * n + r[1].numpy()
                           for r in tr])
    counts = np.concatenate([r[2].numpy() for r in tr])
    order = np.argsort(keys)
    hk, hc = talg._walk_pair_counts([w], n, 3)
    jk, jc = jalg._walk_pair_counts([w], n, 3)
    assert np.array_equal(hk, jk) and np.array_equal(hc, jc)
    assert np.array_equal(keys[order], hk) and np.array_equal(counts[order], hc)
    assert tco.pair_total(tr, n) == jco.pair_total(jr_raw, n) == hc.sum()


def test_run_length_and_pair_keys_on_an_empty_or_dead_batch():
    n = 5
    w = torch.full((3, 4), n, dtype=torch.int32)
    keys = tco.pair_keys(w, 3, n, 2, 2)
    assert keys.shape == (2 * 3 * (3 + 2),) and torch.all(keys == tco._DEAD)
    cen, ctx, cnt, m_per = tco.run_length(torch.sort(keys).values, n, 2)
    assert cen.shape == (0,) and m_per.tolist() == [0, 0]
    assert tco.pair_keys(w[:, :1], 3, n, 2, 2).shape == (0,)
    with pytest.raises(ValueError, match="passes \\* n\\^2 < 2\\^63"):
        tco.pair_keys(w, 3, 1 << 31, 2, 4)


def test_counts_wrap_modulo_2_32_and_overflow_raises():
    keys = torch.tensor([7, 7, 9], dtype=torch.int64)  # (1, 3), (2, 1)
    counts = torch.tensor([2**31 - 1, 1, 5], dtype=torch.int32)
    cen, ctx, cnt, m_per = tco.run_length_plain(keys, counts, 4, 1)
    assert cen.tolist() == [1, 2] and ctx.tolist() == [3, 1]
    assert cnt.tolist() == [-2**31, 5] and m_per.tolist() == [2]
    with pytest.raises(ValueError, match="count overflow"):
        tco._check_count_overflow([(cen, ctx, cnt, 2)], 4)


# ---------------------------------------------------------------------- PPMI
@pytest.mark.parametrize("passes", [1, 3])
def test_ppmi_ranges_equal_the_jax_ones(graphs, passes):
    _, jr, _, tr, _ = _both_counts(graphs, passes, 1 << 15)
    n = graphs[1].num_entities
    want = jco.ppmi_ranges(jr, n)
    got = tco.ppmi_ranges(tr, n)
    assert len(got) == len(want) == passes
    for (jrow, jcol, jval), (rows, cols, vals), r in zip(want, got, tr):
        m = r[3]
        assert np.array_equal(np.asarray(jrow)[:m], rows.numpy())
        assert np.array_equal(np.asarray(jcol)[:m], cols.numpy())
        assert vals.dtype == torch.float32
        np.testing.assert_allclose(vals.numpy(), np.asarray(jval)[:m],
                                   rtol=1e-6, atol=0)
    if passes == 1:
        cen, ctx, cnt, _ = tr[0]
        assert all(torch.equal(a, b) for a, b in
                   zip(tco.ppmi_coo(cen, ctx, cnt, n), got[0]))


def test_ppmi_csrs_are_the_ppmi_matrix(graphs):
    _, _, _, tr, _ = _both_counts(graphs, 3, 1 << 15)
    n = graphs[1].num_entities
    coo = tco.ppmi_ranges(list(tr), n)
    dense = torch.zeros((n, n))
    for rows, cols, vals in coo:
        dense[rows.long(), cols.long()] = vals
    pieces = tco.ppmi_csrs(tr, n)
    assert tr == [] and len(pieces) == 3
    eye = torch.eye(n)
    from cleora_tpu_torch.ops.dense import _apply_pieces

    assert torch.equal(_apply_pieces(pieces, eye), dense)


# ------------------------------------------------------------ factorization
@pytest.mark.parametrize("factorization", ["host", "device"])
def test_counts_to_embeddings_match_jax(graphs, factorization):
    """Host counts, both factorizations; the same omega (both draw
    default_rng(seed))."""
    _, g = graphs
    n = g.num_entities
    keys, counts = talg._walk_pair_counts([_walk_matrix(g)], n, 3)
    kw = dict(factorization=factorization, seed=4, oversample=n)
    want = jalg._counts_to_embeddings(keys, counts, n, 16, **kw)
    got = talg._counts_to_embeddings(keys, counts, n, 16, device="cpu", **kw)
    assert got.shape == want.shape == (n, 16) and got.dtype == np.float32
    tol = 1e-6 if factorization == "host" else 1e-4
    np.testing.assert_allclose(_gram(got), _gram(want), atol=tol)


def test_device_rsvd_matches_jax_with_the_same_omega(graphs, monkeypatch):
    """The device-counted factorization (PPMI + unfused rsvd) of both
    packages on the same ranges; the JAX package's device-drawn omega is
    replaced by the port's numpy draw."""
    import jax
    import jax.numpy as jnp

    _, jr, jm, tr, tm = _both_counts(graphs, 3, 1 << 15)
    n = graphs[1].num_entities
    k, r, seed = 16, n, 2
    omega = np.random.default_rng(seed ^ 0x5EED).standard_normal(
        (n, r)).astype(np.float32)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype: jnp.asarray(omega))
    want = jalg._device_counts_to_embeddings(jr, jm, n, k, seed,
                                             oversample=n, power_iters=4)
    got = talg._device_counts_to_embeddings(tr, tm, n, k, seed,
                                            oversample=n, power_iters=4,
                                            device="cpu")
    assert got.shape == (n, k) and np.isfinite(got).all()
    np.testing.assert_allclose(_gram(got), _gram(want), atol=1e-4)


# --------------------------------------------------------------- entry points
def test_host_backends_equal_the_jax_ones(graphs):
    ref, g = graphs
    kw = dict(feature_dim=16, num_walks=2, walk_length=8, seed=3)
    assert np.array_equal(talg.embed_deepwalk(g, **kw),
                          jalg.embed_deepwalk(ref, **kw))
    kw.update(p=0.5, q=2.0)
    assert np.array_equal(talg.embed_node2vec(g, **kw),
                          jalg.embed_node2vec(ref, **kw))


@pytest.mark.parametrize("kw", [
    dict(cooccurrence="device"),
    dict(factorization="device"),
    dict(),
])
def test_device_entry_points_run_and_node2vec_is_deepwalk(graphs, kw):
    _, g = graphs
    args = dict(feature_dim=16, num_walks=2, walk_length=10, seed=1,
                backend="device", device="cpu", **kw)
    e = talg.embed_deepwalk(g, **args)
    assert e.shape == (g.num_entities, 16) and e.dtype == np.float32
    norms = np.linalg.norm(e, axis=1)
    assert np.all((np.abs(norms - 1) < 1e-5) | (norms < 1e-6))
    assert np.array_equal(talg.embed_node2vec(g, **args), e)


def test_device_deepwalk_recovers_planted_communities_like_jax():
    rng = np.random.default_rng(3)
    src, dst, comm = planted_edges(300, 6, 6, 1, rng)
    ref = ct.SparseMatrix.from_edge_arrays(src, dst)
    g = from_jax_state(ref.__getstate__())
    labels = comm[np.array([int(e) for e in ref.entity_ids])]
    kw = dict(feature_dim=16, num_walks=4, walk_length=20,
              backend="device", cooccurrence="device")
    want = centroid_accuracy(jalg.embed_deepwalk(ref, **kw), labels,
                             np.random.default_rng(1))
    got = centroid_accuracy(talg.embed_deepwalk(g, device="cpu", **kw),
                            labels, np.random.default_rng(1))
    assert got >= 0.95 and want >= 0.95 and abs(got - want) <= 0.05


@pytest.mark.parametrize("kw", [
    dict(cooccurrence="bogus"),
    dict(factorization="bogus"),
    dict(cooccurrence="device"),
    dict(backend="device", cooccurrence="device", factorization="host"),
    dict(factorization="sharded"),
    dict(factorization="device"),
    dict(checkpoint_dir="x"),
    dict(backend="device", walk_tables="bogus"),
    dict(p=0.0),
])
def test_validation_errors_are_the_jax_ones(graphs, kw):
    ref, g = graphs
    with pytest.raises(ValueError) as want:
        jalg.embed_node2vec(ref, feature_dim=8, **kw)
    with pytest.raises(ValueError) as got:
        talg.embed_node2vec(g, feature_dim=8, device="cpu", **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [
    dict(mesh=object()),
    dict(n_devices=2),
    dict(walk_tables="sharded"),
    dict(cooccurrence="device", factorization="sharded"),
])
def test_multi_gpu_arguments_raise_not_implemented(graphs, kw):
    """The multi-GPU arguments (queue A item 8, ported): ``n_devices=2``
    without a process group names torchrun, a ``mesh=`` that is no
    ``ShardGroup`` is refused, and the sharded tables and the sharded
    factorization run on one shard, bitwise the one-card result (the
    multi-rank runs: tests/test_torch_walks_sharded.py)."""
    _, g = graphs
    base = dict(feature_dim=8, backend="device", device="cpu", num_walks=1,
                walk_length=5)
    error = {"mesh": (TypeError, "ShardGroup"),
             "n_devices": (ValueError, "torchrun --nproc-per-node 2")}.get(
                 next(iter(kw)))
    if error is not None:
        with pytest.raises(error[0], match=error[1]):
            talg.embed_deepwalk(g, **base, **kw)
        return
    want = talg.embed_deepwalk(g, **base, cooccurrence=kw.get(
        "cooccurrence", "host"))
    assert np.array_equal(talg.embed_deepwalk(g, **base, **kw), want)


def test_biased_node2vec_gives_unit_rows_and_sharded_tables_name_item_8(graphs):
    """A biased Node2Vec on one device runs (kernel K12) and returns finite
    unit rows; ``walk_tables="sharded"`` (queue A item 8) walks the same
    walks on one shard through K18's stages and gives the same rows."""
    _, g = graphs
    kw = dict(feature_dim=8, p=0.5, num_walks=2, walk_length=10,
              backend="device", device="cpu")
    e = talg.embed_node2vec(g, **kw)
    assert e.shape == (g.num_entities, 8) and np.isfinite(e).all()
    norms = np.linalg.norm(e, axis=1)
    assert np.all((np.abs(norms - 1) < 1e-5) | (norms < 1e-6))
    assert np.array_equal(talg.embed_node2vec(g, walk_tables="sharded", **kw),
                          e)


def test_device_backend_without_a_card_raises(graphs):
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    _, g = graphs
    for fn in (talg.embed_deepwalk, talg.embed_node2vec):
        with pytest.raises(RuntimeError, match="pass device='cpu'"):
            fn(g, feature_dim=8, backend="device")


def test_signatures_registry_and_partitions_are_the_jax_ones(graphs):
    ref, g = graphs
    for name in ("embed_deepwalk", "embed_node2vec"):
        want = inspect.signature(getattr(jalg, name)).parameters
        got = inspect.signature(getattr(talg, name)).parameters
        assert list(got) == [*want, "device"]
        for key, p in want.items():
            assert got[key].default == p.default, (name, key)
        assert got["device"].default is None
    assert talg.list_algorithms() == jalg.list_algorithms()
    assert talg._COOC_PASS_PAIRS == jalg._COOC_PASS_PAIRS
    for args in ((10, 80, 5), (1, 3, 9), (400, 80, 10)):
        assert talg._cooc_passes(g, *args) == jalg._cooc_passes(ref, *args)


def test_wrappers_run_plain_versions_on_cpu_and_launch_nothing(graphs):
    _, g = graphs
    kernels.reset_launches()
    talg.embed_deepwalk(g, feature_dim=8, num_walks=1, walk_length=6,
                        backend="device", cooccurrence="device",
                        device="cpu")
    assert kernels.LAUNCHES == dict.fromkeys(kernels.COUNTERS, 0)


# ---------------------------------------------------------------- lifecycle
def test_checkpoint_resume_reuses_counts_and_rejects_a_foreign_corpus(
        graphs, tmp_path, monkeypatch):
    ref, g = graphs
    sweeps = []
    real_sweep = tco._run_sweep

    def counting_sweep(*args, **kwargs):
        sweeps.append(1)
        return real_sweep(*args, **kwargs)

    monkeypatch.setattr(tco, "_run_sweep", counting_sweep)
    ckpt = str(tmp_path / "ckpt")
    kw = dict(feature_dim=8, num_walks=2, walk_length=10, backend="device",
              cooccurrence="device", device="cpu", checkpoint_dir=ckpt)
    first = np.array(talg.embed_deepwalk(g, **kw))
    out = os.path.join(ckpt, "embedding.npy")
    with open(out, "rb") as f:
        first_bytes = f.read()
    assert len(sweeps) == 1 and os.path.exists(
        os.path.join(ckpt, "counts_pass_00000.npz"))
    # a finished run returns its memmap at once
    again = talg.embed_deepwalk(g, **kw)
    assert isinstance(again, np.memmap) and len(sweeps) == 1
    # without the done marker: the counts are reused, the output identical
    os.remove(os.path.join(ckpt, "embedding.json"))
    os.remove(out)
    resumed = talg.embed_deepwalk(g, **kw)
    assert len(sweeps) == 1 and np.array_equal(np.asarray(resumed), first)
    with open(out, "rb") as f:
        assert f.read() == first_bytes
    # another seed is another corpus: its fingerprint rejects the passes
    talg.embed_deepwalk(g, seed=9, **kw)
    assert len(sweeps) == 2
    # the fingerprint names the port's walk engine, never the JAX one
    params = dict(window=5, passes=1, n=g.num_entities, seed=0,
                  num_walks=2, walk_length=10)
    ours = talg._walk_fingerprint(g, False,
                                  dict(params, engine=talg._WALK_ENGINE))
    theirs = jalg._walk_fingerprint(ref, False, dict(params, engine="walk1"))
    assert talg._WALK_ENGINE != "walk1" and ours != theirs
