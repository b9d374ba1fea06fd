"""The port's embedding modes and host helpers against cleora_tpu's, on the
CPU.

Inputs come from seeded numpy: a random graph of about 2,000 nodes carried
into the port with ``from_jax_state`` (both packages propagate the same
matrix), or the same edge lines fed to both packages' builders (bitwise
equal builds, tests/test_torch_graph.py).  Tolerances:

- unwhitened device loops: rtol=1e-4, atol=1e-5 (float32 sums in another
  order, over a few iterations);
- whitened outputs: row Gram matrices within atol=1e-3 (eigh signs are
  arbitrary);
- functions both packages compute on the host with numpy: exactly equal;
- attention weights against a numpy restatement of the JAX step
  (cleora_tpu/__init__.py:505-526): atol=1e-6.

Error strings must match cleora_tpu's word for word.
"""

import numpy as np
import pytest
import torch

import cleora_tpu as ct
import cleora_tpu_torch as ctt
from cleora_tpu_torch import kernels
from cleora_tpu_torch.convert import from_jax_state
from cleora_tpu_torch.ops.attention import (
    attention_step,
    edge_attention_weights,
    edge_attention_weights_plain,
)
from cleora_tpu_torch.ops.spmm import CsrMatrix
from torch_test_support import one_torch_thread  # noqa: F401

D = 32
CPU = torch.device("cpu")
TOL = {"rtol": 1e-4, "atol": 1e-5}
COLUMNS = "complex::reflexive::node"


@pytest.fixture(scope="module")
def graphs():
    rng = np.random.default_rng(29)
    src = rng.integers(0, 2000, size=6000)
    dst = rng.integers(0, 2000, size=6000)
    ref = ct.SparseMatrix.from_edge_arrays(src, dst)
    return ref, from_jax_state(ref.__getstate__())


@pytest.fixture(scope="module")
def jax_emb(graphs):
    """The JAX package's unwhitened D=16 embedding that the host helpers'
    tests share, computed once for the module."""
    emb = ct.embed(graphs[0], feature_dim=16, num_iterations=3, whiten=False)
    emb.setflags(write=False)
    return emb


@pytest.fixture(scope="module")
def lines():
    rng = np.random.default_rng(31)
    return [f"n{a} n{b}" for a, b in zip(rng.integers(0, 400, 1200),
                                         rng.integers(0, 400, 1200))]


def _gram_close(a, b, atol=1e-3):
    np.testing.assert_allclose(a @ a.T, b @ b.T, atol=atol)


def _same_error(ref_call, our_call, exc=ValueError):
    with pytest.raises(exc) as ref_err:
        ref_call()
    with pytest.raises(exc) as our_err:
        our_call()
    assert str(our_err.value) == str(ref_err.value)


# ------------------------------------------------------------ attention


def numpy_attention_weights(indptr, cols, vals, xn, temperature):
    """The JAX attention_step's score → masked softmax → reweight →
    renormalise, restated in float64 numpy."""
    n = indptr.shape[0] - 1
    rows = np.repeat(np.arange(n), np.diff(indptr))
    x = xn.astype(np.float64)
    scores = np.sum(x[rows] * x[cols], axis=1) / temperature
    valid = vals != 0.0
    masked = np.where(valid, scores, -np.inf)
    row_max = np.full(n, -np.inf)
    np.maximum.at(row_max, rows, masked)
    row_max[~np.isfinite(row_max)] = 0.0
    exp_scores = np.where(valid, np.exp(masked - row_max[rows]), 0.0)
    denom = np.zeros(n)
    np.add.at(denom, rows, exp_scores)
    weighted = exp_scores / np.maximum(denom, 1e-10)[rows] * vals
    wsum = np.zeros(n)
    np.add.at(wsum, rows, weighted)
    return weighted / np.maximum(wsum, 1e-10)[rows]


def attention_csr(n=400, seed=0):
    """Random Markov CSR with empty rows, one row whose values are all 0,
    scattered zero values and one hub row of 300 edges."""
    rng = np.random.default_rng(seed)
    deg = rng.poisson(5, size=n)
    deg[::9] = 0
    deg[2] = 300
    deg[3] = max(deg[3], 4)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    cols = rng.integers(0, n, size=int(indptr[-1]))
    vals = rng.random(cols.shape[0]).astype(np.float32)
    vals[rng.random(cols.shape[0]) < 0.1] = 0.0
    vals[indptr[3]:indptr[4]] = 0.0
    return indptr, cols, vals


@pytest.mark.parametrize("temperature", [0.7, 1.0])
@pytest.mark.parametrize("d", [8, 33])
def test_attention_weights_plain_vs_numpy(temperature, d):
    indptr, cols, vals = attention_csr(seed=d)
    x = np.random.default_rng(d).standard_normal((400, d)).astype(np.float32)
    xn = x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-10)
    csr = CsrMatrix.from_numpy(indptr, cols, vals, CPU)
    kernels.reset_launches()
    ours = edge_attention_weights(csr, torch.from_numpy(xn), temperature)
    assert kernels.LAUNCHES["edge_attention"] == 0
    assert torch.equal(ours, edge_attention_weights_plain(
        csr, torch.from_numpy(xn), temperature))
    ref = numpy_attention_weights(indptr, cols, vals, xn, temperature)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-6)
    # the all-zero row and masked edges get 0; other rows sum to 1
    assert np.all(ours.numpy()[indptr[3]:indptr[4]] == 0.0)
    assert np.all(ours.numpy()[vals == 0.0] == 0.0)
    sums = np.add.reduceat(ours.numpy(), indptr[:-1][np.diff(indptr) > 0])
    live = np.array([vals[indptr[r]:indptr[r + 1]].any()
                     for r in range(400) if indptr[r + 1] > indptr[r]])
    np.testing.assert_allclose(sums[live], 1.0, rtol=1e-5)


def test_attention_step_leaves_its_input_alone():
    indptr, cols, vals = attention_csr(seed=5)
    csr = CsrMatrix.from_numpy(indptr, cols, vals, CPU)
    x = torch.from_numpy(
        np.random.default_rng(5).standard_normal((400, 16)).astype(np.float32))
    before = x.clone()
    y = attention_step(csr, x, 0.7, "l2", False)
    assert torch.equal(x, before)
    norms = torch.linalg.norm(y, dim=1)
    assert torch.allclose(norms[norms > 0], torch.ones(()), atol=1e-6)


@pytest.mark.parametrize("propagation", ["left", "symmetric"])
def test_embed_with_attention_unwhitened(graphs, propagation):
    ref_g, our_g = graphs
    kw = dict(feature_dim=D, num_iterations=5, propagation=propagation,
              attention_temperature=0.7, whiten=False)
    ours = ctt.embed_with_attention(our_g, device="cpu", **kw)
    assert ours.dtype == np.float32 and ours.flags.writeable
    np.testing.assert_allclose(ours, ct.embed_with_attention(ref_g, **kw),
                               **TOL)


@pytest.mark.parametrize("propagation", ["left", "symmetric"])
def test_embed_with_attention_whitened_gram(graphs, propagation):
    ref_g, our_g = graphs
    kw = dict(feature_dim=D, num_iterations=5, propagation=propagation,
              attention_temperature=0.7, whiten=True)
    _gram_close(ctt.embed_with_attention(our_g, device="cpu", **kw),
                ct.embed_with_attention(ref_g, **kw))


def test_embed_with_attention_callback_and_one_iteration(graphs):
    ref_g, our_g = graphs
    seen = {"ref": [], "ours": []}
    kw = dict(feature_dim=16, num_iterations=3, seed=4, whiten=False)
    ct.embed_with_attention(
        ref_g, callback=lambda i, e: seen["ref"].append((i, np.array(e))), **kw)
    ctt.embed_with_attention(
        our_g, callback=lambda i, e: seen["ours"].append((i, e)),
        device="cpu", **kw)
    assert [i for i, _ in seen["ours"]] == [0, 1, 2]
    for (_, a), (_, b) in zip(seen["ours"], seen["ref"]):
        np.testing.assert_allclose(a, b, **TOL)
    kw["num_iterations"] = 1
    np.testing.assert_allclose(
        ctt.embed_with_attention(our_g, device="cpu", **kw),
        ct.embed_with_attention(ref_g, **kw), **TOL)


@pytest.mark.parametrize("kwargs", [
    {"attention_temperature": 0},
    {"attention_temperature": -1.5},
    {"num_iterations": 0},
    {"propagation": "banana"},
])
def test_embed_with_attention_errors(graphs, kwargs):
    ref_g, our_g = graphs
    _same_error(lambda: ct.embed_with_attention(ref_g, **kwargs),
                lambda: ctt.embed_with_attention(our_g, device="cpu", **kwargs))


# ------------------------------------------------- the other device modes


def test_embed_multiscale(graphs):
    ref_g, our_g = graphs
    kw = dict(feature_dim=16, scales=[3, 1, 3, 6], seed=2, whiten=False)
    ours = ctt.embed_multiscale(our_g, device="cpu", **kw)
    assert ours.shape == (our_g.num_entities, 64)
    np.testing.assert_allclose(ours, ct.embed_multiscale(ref_g, **kw), **TOL)
    kw = dict(feature_dim=16, scales=[2, 4], propagation="symmetric")
    a = ctt.embed_multiscale(our_g, device="cpu", **kw)
    b = ct.embed_multiscale(ref_g, **kw)
    for k in range(2):
        _gram_close(a[:, 16 * k:16 * (k + 1)], b[:, 16 * k:16 * (k + 1)])
    for scales in ([], [0, 2], [1.5]):
        _same_error(lambda: ct.embed_multiscale(ref_g, scales=scales),
                    lambda: ctt.embed_multiscale(our_g, scales=scales,
                                                 device="cpu"))


@pytest.mark.parametrize("propagation", ["left", "symmetric"])
def test_embed_weighted(lines, propagation):
    rng = np.random.default_rng(3)
    ew = [(line, float(w)) for line, w in zip(lines, rng.uniform(0.5, 3.0,
                                                                 len(lines)))]
    kw = dict(feature_dim=D, num_iterations=6, propagation=propagation,
              seed=1, whiten=False)
    g_ref, ref = ct.embed_weighted(ew, COLUMNS, **kw)
    g_ours, ours = ctt.embed_weighted(ew, COLUMNS, device="cpu", **kw)
    assert g_ours.entity_ids == g_ref.entity_ids
    np.testing.assert_allclose(ours, ref, **TOL)
    kw["whiten"] = True
    _gram_close(ctt.embed_weighted(ew, COLUMNS, device="cpu", **kw)[1],
                ct.embed_weighted(ew, COLUMNS, **kw)[1])


def test_embed_directed(lines):
    kw = dict(feature_dim=D, num_iterations=6, seed=5, whiten=False)
    g_ref, ref = ct.embed_directed(lines, COLUMNS, **kw)
    g_ours, ours = ctt.embed_directed(lines, COLUMNS, device="cpu", **kw)
    assert g_ours.entity_ids == g_ref.entity_ids
    np.testing.assert_allclose(ours, ref, **TOL)


@pytest.mark.parametrize("combine", ["concat", "mean", "edge_only"])
def test_embed_edge_features(graphs, combine):
    ref_g, our_g = graphs
    rng = np.random.default_rng(8)
    ids = our_g.entity_ids
    feats = {f"{ids[a]} {ids[b]}": rng.standard_normal(6).astype(np.float32)
             for a, b in rng.integers(0, len(ids), size=(300, 2))}
    feats["nope also_nope"] = np.ones(6, np.float32)
    kw = dict(feature_dim=16, num_iterations=4, combine=combine, whiten=False)
    ours = ctt.embed_edge_features(our_g, feats, device="cpu", **kw)
    np.testing.assert_allclose(ours, ct.embed_edge_features(ref_g, feats, **kw),
                               **TOL)
    np.testing.assert_allclose(
        ctt.embed_edge_features(our_g, {}, device="cpu", **kw),
        ct.embed_edge_features(ref_g, {}, **kw), **TOL)


def test_embed_edge_features_errors(graphs):
    ref_g, our_g = graphs
    feats = {f"{our_g.entity_ids[0]} {our_g.entity_ids[1]}": np.ones(3)}
    kw = dict(feature_dim=8, num_iterations=1, combine="banana")
    _same_error(lambda: ct.embed_edge_features(ref_g, feats, **kw),
                lambda: ctt.embed_edge_features(our_g, feats, device="cpu",
                                                **kw))
    _same_error(lambda: ct.embed_edge_features(ref_g, feats, propagation="x"),
                lambda: ctt.embed_edge_features(our_g, feats, propagation="x",
                                                device="cpu"))


def test_embed_with_node_features(graphs):
    ref_g, our_g = graphs
    rng = np.random.default_rng(9)
    feats = {our_g.entity_ids[i]: rng.standard_normal(12) for i in range(0, 300, 7)}
    feats["not_in_graph"] = np.ones(12)
    kw = dict(num_iterations=4, feature_weight=0.3)
    # whitening is always on here, as in cleora_tpu
    _gram_close(ctt.embed_with_node_features(our_g, feats, device="cpu", **kw),
                ct.embed_with_node_features(ref_g, feats, **kw))
    for bad in ({}, {"a": np.ones(3), "b": np.ones(4)}):
        _same_error(lambda: ct.embed_with_node_features(ref_g, bad),
                    lambda: ctt.embed_with_node_features(our_g, bad,
                                                         device="cpu"))


def test_embed_dim_sharded(graphs):
    ref_g, our_g = graphs
    kw = dict(feature_dim=32, slice_dim=16, num_iterations=5, seed=3)
    calls = []
    ours = ctt.embed_dim_sharded(our_g, device="cpu",
                                 slice_callback=lambda k, e: calls.append(k),
                                 **kw)
    assert calls == [0, 1]
    np.testing.assert_allclose(ours, ct.embed_dim_sharded(ref_g, **kw), **TOL)
    _same_error(lambda: ct.embed_dim_sharded(ref_g, feature_dim=30,
                                             slice_dim=16),
                lambda: ctt.embed_dim_sharded(our_g, feature_dim=30,
                                              slice_dim=16, device="cpu"))
    x0 = np.zeros((our_g.num_entities, 8), np.float32)
    _same_error(lambda: ct.embed_dim_sharded(ref_g, initial_embeddings=x0),
                lambda: ctt.embed_dim_sharded(our_g, initial_embeddings=x0,
                                              device="cpu"))
    with pytest.raises(TypeError, match="SparseMatrix or a DiskGraph"):
        ctt.embed_dim_sharded(object(), feature_dim=8, slice_dim=4,
                              device="cpu")


def test_propagate_gpu(graphs):
    ref_g, our_g = graphs
    x = np.random.default_rng(1).standard_normal(
        (our_g.num_entities, 12)).astype(np.float32)
    for normalization in ("l2", "l1", "none"):
        kw = dict(num_iterations=3, normalization=normalization, whiten=False)
        np.testing.assert_allclose(
            ctt.propagate_gpu(our_g, x, device="cpu", **kw),
            ct.propagate_gpu(ref_g, x, **kw), **TOL)
    assert ctt.propagate_tpu is ctt.propagate_gpu
    _same_error(lambda: ct.propagate_gpu(ref_g, x, normalization="spectral"),
                lambda: ctt.propagate_gpu(our_g, x, normalization="spectral",
                                          device="cpu"))


def test_embed_inductive(graphs, lines):
    g_ref = ct.SparseMatrix.from_iterator(iter(lines), COLUMNS)
    g_ours = ctt.SparseMatrix.from_iterator(iter(lines), COLUMNS)
    emb = np.random.default_rng(2).standard_normal(
        (g_ours.num_entities, 16)).astype(np.float32)
    new = ["n1 fresh1", "fresh1 fresh2", "n7 n9"]
    np.random.seed(123)
    ug_ref, ref = ct.embed_inductive(g_ref, emb, lines, new, COLUMNS,
                                     num_iterations=4)
    np.random.seed(123)
    ug_ours, ours = ctt.embed_inductive(g_ours, emb, lines, new, COLUMNS,
                                        num_iterations=4, device="cpu")
    assert ug_ours.entity_ids == ug_ref.entity_ids
    _gram_close(ours, ref)
    _same_error(lambda: ct.embed_inductive(g_ref, emb[:-1], lines, new,
                                           COLUMNS),
                lambda: ctt.embed_inductive(g_ours, emb[:-1], lines, new,
                                            COLUMNS, device="cpu"))


def test_embed_streaming(lines, monkeypatch):
    # Entities new in a batch start from randn·0.01, the others from the
    # previous batch's whitened output, whose columns may differ in sign
    # between the two packages (eigh).  Zero draws keep the two inits an
    # orthogonal transform apart, so the outputs compare by Gram; the
    # draws themselves (shapes, order) are compared as recorded.
    batches = [lines[:400], lines[400:800], lines[800:]]
    draws = {"ref": [], "ours": []}
    seen = {"ref": [], "ours": []}

    def run(mod, key, **kw):
        monkeypatch.setattr(np.random, "randn", lambda *shape: (
            draws[key].append(shape), np.zeros(shape))[1])
        return mod.embed_streaming(
            batches, COLUMNS, feature_dim=16, num_iterations=3,
            batch_callback=lambda i, g, e: seen[key].append(
                (i, g.num_entities, e.copy())), **kw)

    g_ref, ref = run(ct, "ref")
    g_ours, ours = run(ctt, "ours", device="cpu")
    assert draws["ours"] == draws["ref"] and len(draws["ours"]) == 2
    assert [s[:2] for s in seen["ours"]] == [s[:2] for s in seen["ref"]]
    assert g_ours.entity_ids == g_ref.entity_ids
    for (_, _, a), (_, _, b) in zip(seen["ours"], seen["ref"]):
        _gram_close(a, b)
    _gram_close(ours, ref)


def test_update_and_remove_edges(lines):
    for ours, ref in (
        (ctt.update_graph(lines[:50], lines[50:90], COLUMNS),
         ct.update_graph(lines[:50], lines[50:90], COLUMNS)),
        (ctt.remove_edges(lines[:90], lines[10:40], COLUMNS),
         ct.remove_edges(lines[:90], lines[10:40], COLUMNS)),
    ):
        assert isinstance(ours, ctt.SparseMatrix)
        assert ours.entity_ids == ref.entity_ids
        for x, y in zip(ours.to_sparse_csr(), ref.to_sparse_csr()):
            assert np.array_equal(x, y)
    _same_error(lambda: ct.remove_edges(lines[:3], lines[:3], COLUMNS),
                lambda: ctt.remove_edges(lines[:3], lines[:3], COLUMNS))


def test_cleora_embedder(lines):
    ref = ct.CleoraEmbedder(feature_dim=16, num_iterations=4, whiten=False)
    ours = ctt.CleoraEmbedder(feature_dim=16, num_iterations=4, whiten=False,
                              device="cpu")
    np.testing.assert_allclose(ours.fit_transform(lines),
                               ref.fit_transform(lines), **TOL)
    assert ours.entity_ids_ == ref.entity_ids_
    np.testing.assert_allclose(ours.transform(lines[:5]),
                               ref.transform(lines[:5]), **TOL)
    params = ours.get_params()
    assert params.pop("device") == "cpu"
    assert params == ref.get_params()
    _same_error(lambda: ref.transform(["zz yy"]),
                lambda: ours.transform(["zz yy"]))
    _same_error(lambda: ref.set_params(banana=1),
                lambda: ours.set_params(banana=1))
    _same_error(lambda: ct.CleoraEmbedder().transform(),
                lambda: ctt.CleoraEmbedder().transform(), RuntimeError)


def test_embed_using_baseline_cleora(graphs):
    ref_g, our_g = graphs
    _gram_close(ctt.embed_using_baseline_cleora(our_g, 16, 3, device="cpu"),
                ct.embed_using_baseline_cleora(ref_g, 16, 3))


def test_propagate_custom_coo_with_and_without_init(graphs):
    ref_g, our_g = graphs
    data = our_g.data
    n = our_g.num_entities
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(data.indptr))
    vals = np.random.default_rng(6).random(rows.shape[0]).astype(np.float32)
    init = np.random.default_rng(7).standard_normal((n, 8)).astype(np.float32)
    for kw in (dict(init=None), dict(init=init)):
        args = (rows, data.indices, vals, 8, 4, "l2", False, 2)
        np.testing.assert_allclose(
            ctt._propagate_custom_coo(our_g, *args, device="cpu", **kw),
            ct._propagate_custom_coo(ref_g, *args, **kw), **TOL)


# ------------------------------------------------ host numpy: exactly equal


def test_host_helpers_exactly_equal(graphs, jax_emb):
    ref_g, our_g = graphs
    emb = jax_emb.copy()
    assert np.array_equal(ctt.whiten_embeddings(emb), ct.whiten_embeddings(emb))
    assert np.array_equal(ctt.whiten_embeddings(emb, 5),
                          ct.whiten_embeddings(emb, 5))
    assert np.array_equal(ctt.whiten_embeddings(emb[:1]), emb[:1])
    for method in ("l2", "l1", "spectral", "none"):
        assert np.array_equal(ctt._normalize(emb, method),
                              ct._normalize(emb, method))
        for w in (False, True):
            assert np.array_equal(ctt._postprocess_iteration(emb, method, w),
                                  ct._postprocess_iteration(emb, method, w))
    _same_error(lambda: ct._normalize(emb, "banana"),
                lambda: ctt._normalize(emb, "banana"))
    a, b = emb[0], emb[1]
    assert ctt.cosine_similarity(a, b) == ct.cosine_similarity(a, b)
    assert ctt.cosine_similarity(a, np.zeros(16)) == 0.0
    q = our_g.entity_ids[3]
    for exclude_self in (True, False):
        assert (ctt.find_most_similar(our_g, emb, q, 7, exclude_self)
                == ct.find_most_similar(ref_g, emb, q, 7, exclude_self))
    for kw in (dict(), dict(exclude_existing=False),
               dict(source_entities=our_g.entity_ids[:20], top_k=15)):
        assert (ctt.predict_links(our_g, emb, **kw)
                == ct.predict_links(ref_g, emb, **kw))
    _same_error(lambda: ct.find_most_similar(ref_g, emb, "nope"),
                lambda: ctt.find_most_similar(our_g, emb, "nope"))


def test_supervised_refine_exactly_equal(graphs, jax_emb):
    ref_g, our_g = graphs
    emb = jax_emb.copy()
    ids = our_g.entity_ids
    pos = [(ids[i], ids[i + 1]) for i in range(0, 40, 2)]
    neg = [(ids[i], ids[i + 7]) for i in range(0, 20, 3)]
    for negatives in (None, neg):
        losses = {"ref": [], "ours": []}
        ref = ct.supervised_refine(
            ref_g, emb, pos, negatives, num_epochs=4,
            callback=lambda e, l: losses["ref"].append(l))
        ours = ctt.supervised_refine(
            our_g, emb, pos, negatives, num_epochs=4,
            callback=lambda e, l: losses["ours"].append(l))
        assert np.array_equal(ours, ref)
        assert losses["ours"] == losses["ref"]
    _same_error(lambda: ct.supervised_refine(ref_g, emb, [("nope", ids[0])]),
                lambda: ctt.supervised_refine(our_g, emb, [("nope", ids[0])]))
    _same_error(lambda: ct.supervised_refine(ref_g, emb[:-1], pos),
                lambda: ctt.supervised_refine(our_g, emb[:-1], pos))


# ----------------------------------------------------------- the public API


def test_public_api_covers_the_core_library():
    for name in ctt.__all__:
        assert hasattr(ctt, name), name
    core = {"embed", "embed_dim_sharded", "whiten_embeddings",
            "embed_with_node_features", "embed_with_attention",
            "embed_multiscale", "embed_weighted", "embed_directed",
            "supervised_refine", "update_graph", "remove_edges",
            "embed_inductive", "embed_streaming", "predict_links",
            "propagate_gpu", "propagate_tpu", "cosine_similarity",
            "find_most_similar", "embed_edge_features", "CleoraEmbedder",
            "embed_using_baseline_cleora", "SparseMatrix"}
    assert core <= set(ctt.__all__)
    assert all(hasattr(ct, name) for name in core)


def test_device_rule_for_the_new_entry_points(graphs, lines, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = graphs[1]
    calls = [
        lambda: ctt.embed_with_attention(g, feature_dim=8, num_iterations=2),
        lambda: ctt.embed_multiscale(g, feature_dim=8, scales=[1]),
        lambda: ctt.embed_weighted([(lines[0], 1.0)], COLUMNS, feature_dim=8,
                                   num_iterations=1),
        lambda: ctt.embed_directed(lines[:5], COLUMNS, feature_dim=8,
                                   num_iterations=1),
        lambda: ctt.propagate_gpu(g, np.zeros((g.num_entities, 4), np.float32),
                                  num_iterations=1),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
