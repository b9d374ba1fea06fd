"""The port's node classifiers against the JAX package's, on the CPU.

Inputs: the karate club graph and the cora-shaped synthetic citation graph
(2,708 papers, 7 classes), each built by both packages from the same edge
list, with one embedding fed to both (karate: the JAX package's embed; cora:
the dataset's class-bumped features).  The port runs ``device="cpu"``
(K14's and K15's plain versions, K1's plain SpMM); the JAX package runs on
its CPU platform.  Both packages' dataset caches point at a temporary
directory.

Tolerances: S and Â bitwise (the same float64 host code rounded to float32);
the plain K14 step bitwise against a numpy float32 restatement (the same
products, added in the same edge order); the final F of label propagation
atol=1e-6 (the row sums in another order over 30 steps), predictions equal
but where JAX's two largest values lie within 1e-6; one MLP or GCN step
from the same weights atol=1e-5 (float32 products and gradients in another
order); accuracy after 30 epochs within 2/test_size (MLP) or 0.03 (GCN at
dropout 0) of the JAX package's, and no more than 0.05 below it at dropout
0.5, where the masks are another stream (Philox, not jax.random); K15's
plain pair bitwise the JAX formula on one keep mask.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cleora_tpu as ct
import cleora_tpu.classify as jcl
import cleora_tpu.datasets as jds
import cleora_tpu_torch as ctt
import cleora_tpu_torch.classify as tcl
import cleora_tpu_torch.datasets as tds
from cleora_tpu_torch.ops.gcn import (
    CsrSpmm,
    ReluDropout,
    dropout_uniforms,
    relu_dropout,
    relu_dropout_backward_plain,
    relu_dropout_plain,
)
from cleora_tpu_torch.ops.label_prop import label_prop_step_plain
from cleora_tpu_torch.ops.spmm import CsrMatrix
from torch_test_support import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
# the module: cleora_tpu.ops re-exports a function of the same name
jspmm = importlib.import_module("cleora_tpu.ops.spmm")


class _Stop(Exception):
    pass


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("datasets"))
    saved = [(m, m._CACHE_DIR, m._COMPAT_CACHE_DIR) for m in (jds, tds)]
    for m in (jds, tds):
        m._CACHE_DIR = path
        m._COMPAT_CACHE_DIR = path
    yield path
    for m, a, b in saved:
        m._CACHE_DIR, m._COMPAT_CACHE_DIR = a, b


def _pair(d):
    ref = ct.SparseMatrix.from_iterator(iter(d["edges"]), d["columns"])
    g = ctt.SparseMatrix.from_iterator(iter(d["edges"]), d["columns"])
    assert ref.entity_ids == g.entity_ids
    return ref, g


@pytest.fixture(scope="module")
def karate(cache):
    d = jds.load_dataset("karate_club")
    ref, g = _pair(d)
    emb = np.asarray(ct.embed(ref, feature_dim=32, num_iterations=8))
    return ref, g, emb, d["labels"]


@pytest.fixture(scope="module")
def cora(cache):
    d = jds.load_dataset("cora")
    ref, g = _pair(d)
    rows = [int(e[1:]) for e in g.entity_ids]
    emb = np.ascontiguousarray(d["features"][rows], dtype=np.float32)
    return ref, g, emb, d["labels"]


@pytest.fixture(params=["karate", "cora"])
def graph_case(request):
    return request.getfixturevalue(request.param)


def _strip(coo, nnz):
    return tuple(np.asarray(a)[:nnz] for a in coo)


def _jax_gcn_adjacency(ref, labels):
    """The arrays the JAX package's gcn_classify hands to pad_coo."""
    seen = {}

    def capture(rows, cols, vals, n, *a, **k):
        seen["coo"] = (rows, cols, vals, n)
        raise _Stop

    real = jspmm.pad_coo
    jspmm.pad_coo = capture
    try:
        with pytest.raises(_Stop):
            jcl.gcn_classify(ref, np.zeros((ref.num_entities, 2), np.float32),
                             labels, num_epochs=1)
    finally:
        jspmm.pad_coo = real
    return seen["coo"]


def test_operators_are_bitwise_the_jax_ones(graph_case):
    ref, g, _, labels = graph_case
    rows, cols, svals, n = tcl._row_normalized(g)
    (prow, pcol, pval), jn = jcl._row_normalized_coo(ref)
    assert n == jn
    jr, jc, jv = _strip((prow, pcol, pval), rows.shape[0])
    assert np.array_equal(rows, jr) and np.array_equal(cols, jc)
    assert svals.dtype == np.float32 and svals.tobytes() == jv.tobytes()
    assert not np.any(np.asarray(pval)[rows.shape[0]:])  # only padding left

    rows, cols, vals, n = tcl._gcn_adjacency(g)
    jr, jc, jv, jn = _jax_gcn_adjacency(ref, labels)
    assert n == jn
    assert np.array_equal(rows, jr) and np.array_equal(cols, jc)
    assert vals.dtype == np.float32 and vals.tobytes() == jv.tobytes()


def _seeded_state(n, c, seed):
    rng = np.random.default_rng(seed)
    y = np.zeros((n, c), dtype=np.float32)
    mask = rng.random(n) < 0.3
    y[np.flatnonzero(mask), rng.integers(0, c, mask.sum())] = 1.0
    f = rng.random((n, c)).astype(np.float32)
    return f, y, mask


@pytest.mark.parametrize("c", [2, 7, 40])
@pytest.mark.parametrize("alpha", [0.5, 0.3])
def test_plain_k14_step_is_the_numpy_loop_body(cora, c, alpha):
    _, g, _, _ = cora
    rows, cols, svals, n = tcl._row_normalized(g)
    f, y, mask = _seeded_state(n, c, 3)
    a32 = np.float32(alpha)
    beta = np.float32(1) - a32
    s = np.zeros((n, c), dtype=np.float32)
    np.add.at(s, rows, f[cols] * svals[:, None])
    want = np.where(mask[:, None], y, s * a32 + beta * y)

    S = CsrMatrix.from_coo(rows, cols, svals, n, CPU)
    got = label_prop_step_plain(S, torch.from_numpy(f), torch.from_numpy(y),
                                torch.from_numpy(mask), alpha, float(beta))
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == want.tobytes()


def _labels_state(g, labels, every=3):
    train = {e: l for i, (e, l) in enumerate(labels.items())
             if i % every == 0 and e in g._index_map}
    classes = sorted(set(train.values()))
    n = g.num_entities
    Y = np.zeros((n, len(classes)), dtype=np.float32)
    mask = np.zeros(n, dtype=bool)
    for e, l in train.items():
        i = g._index_map[e]
        Y[i, classes.index(l)] = 1.0
        mask[i] = True
    return train, Y, mask


def test_label_propagation_matches_jax(graph_case):
    ref, g, emb, labels = graph_case
    train, Y, mask = _labels_state(g, labels)
    (prow, pcol, pval), n = jcl._row_normalized_coo(ref)
    want = np.asarray(jcl._label_prop_jit()(
        prow, pcol, pval, Y, mask, np.float32(0.5), n_rows=n, iters=30))
    rows, cols, svals, _ = tcl._row_normalized(g)
    S = CsrMatrix.from_coo(rows, cols, svals, n, CPU)
    got = tcl._propagate_labels(S, torch.from_numpy(Y),
                                torch.from_numpy(mask), 0.5, 30).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    top2 = np.sort(want, axis=1)[:, -2:]
    tie = top2[:, 1] - top2[:, 0] <= 1e-6
    ours = tcl.label_propagation(g, train, device="cpu")
    theirs = jcl.label_propagation(ref, train)
    ids = g.entity_ids
    assert all(ours[e] == theirs[e] for i, e in enumerate(ids) if not tie[i])
    assert all(ours[e] == train[e] for e in train)  # clamped

    assert (tcl.label_propagation_predict(g, emb, labels, device="cpu")
            == jcl.label_propagation_predict(ref, emb, labels))


def _capture_jax_first_step(monkeypatch, name, call):
    """The arguments of the JAX package's first training step."""
    real = getattr(jcl, name)
    seen = {}

    def jits():
        step, infer = real()

        def first(*args, **kw):
            seen["args"], seen["kw"] = args, kw
            raise _Stop

        return first, infer

    monkeypatch.setattr(jcl, name, jits)
    with pytest.raises(_Stop):
        call()
    monkeypatch.setattr(jcl, name, real)
    return seen["args"], seen["kw"]


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("hidden", [64, 0])
def test_mlp_split_init_and_one_step_match_jax(cora, monkeypatch, hidden):
    ref, g, emb, labels = cora
    (params, Xb, yb, lr, l2), _ = _capture_jax_first_step(
        monkeypatch, "_mlp_jits",
        lambda: jcl.mlp_classify(ref, emb, labels, hidden_dim=hidden))

    node_idx, y_mapped, classes, tr, te, rng = tcl._labeled_split(
        g, labels, 0.8, 42)
    ours = tcl._mlp_init(rng, emb.shape[1], hidden, len(classes))
    theirs = _np(params)
    assert list(ours) == list(theirs)
    for k in ours:
        assert ours[k].tobytes() == theirs[k].tobytes(), k
    X = emb[node_idx]
    b = rng.permutation(len(tr))[:min(256, len(tr))]
    assert X[tr][b].tobytes() == np.asarray(Xb).tobytes()
    assert np.array_equal(y_mapped[tr][b], np.asarray(yb))

    want = _np(jcl._mlp_jits()[0](params, Xb, yb, lr, l2))
    got = tcl._mlp_step(ours, X[tr][b], y_mapped[tr][b], 0.01, 1e-4, "cpu")
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5)


@pytest.mark.parametrize("hidden", [64, 0])
def test_mlp_accuracy_after_30_epochs_matches_jax(cora, hidden):
    ref, g, emb, labels = cora
    ours = tcl.mlp_classify(g, emb, labels, hidden_dim=hidden, num_epochs=30,
                            device="cpu")
    theirs = jcl.mlp_classify(ref, emb, labels, hidden_dim=hidden,
                              num_epochs=30)
    assert set(ours) == set(theirs)
    for k in ("num_classes", "train_size", "test_size", "num_epochs",
              "hidden_dim"):
        assert ours[k] == theirs[k]
    assert abs(ours["accuracy"] - theirs["accuracy"]) <= 2 / ours["test_size"]


@pytest.mark.parametrize("layers", [2, 3])
def test_gcn_one_step_at_dropout_0_matches_jax(cora, monkeypatch, layers):
    ref, g, emb, labels = cora
    args, kw = _capture_jax_first_step(
        monkeypatch, "_gcn_jits",
        lambda: jcl.gcn_classify(ref, emb, labels, num_layers=layers,
                                 dropout=0.0))
    params, key, X, dr, dc, dv, tr_nodes, y_train, lr, l2 = args
    want = jcl._gcn_jits()[0](*args, **kw)
    adj = tcl._gcn_operators(g, CPU)
    got = tcl._gcn_step([np.asarray(w) for w in params], np.asarray(X), adj,
                        np.asarray(tr_nodes), np.asarray(y_train), 0.01, 1e-4,
                        0.0, 42, 0)
    assert len(got) == layers
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)


@pytest.mark.parametrize("layers", [2, 3])
def test_gcn_accuracy_after_30_epochs_at_dropout_0_matches_jax(cora, layers):
    ref, g, emb, labels = cora
    kw = dict(num_epochs=30, num_layers=layers, dropout=0.0)
    ours = tcl.gcn_classify(g, emb, labels, device="cpu", **kw)
    theirs = jcl.gcn_classify(ref, emb, labels, **kw)
    assert set(ours) == set(theirs)
    assert abs(ours["accuracy"] - theirs["accuracy"]) <= 0.03


def test_gcn_accuracy_at_dropout_half_is_no_worse_than_jax(cora):
    ref, g, emb, labels = cora
    ours = tcl.gcn_classify(g, emb, labels, num_epochs=30, device="cpu")
    theirs = jcl.gcn_classify(ref, emb, labels, num_epochs=30)
    assert ours["accuracy"] >= theirs["accuracy"] - 0.05


def test_dropout_mask_keeps_half_and_depends_on_seed_epoch_layer_only():
    n, width = 2708, 64
    z = torch.ones((n, width))
    h = relu_dropout(z, 0.5, 42, 3, 0)[0]
    keep = h != 0
    frac = float(keep.float().mean())
    assert abs(frac - 0.5) <= 4 * np.sqrt(0.25 / keep.numel())
    assert torch.all(h[keep] == 2.0)
    # the same draw for other positive values, another row count, and again
    z2 = torch.from_numpy(np.random.default_rng(0).random((n, width))
                          .astype(np.float32) + 0.5)
    assert torch.equal(relu_dropout(z2, 0.5, 42, 3, 0)[0] != 0, keep)
    assert torch.equal(relu_dropout(z[:100], 0.5, 42, 3, 0)[0] != 0,
                       keep[:100])
    u = dropout_uniforms(n * width, 3, 0, 42, CPU)
    assert torch.equal(u, dropout_uniforms(n * width, 3, 0, 42, CPU))
    for other in ((43, 3, 0), (42, 4, 0), (42, 3, 1)):
        seed, epoch, layer = other
        assert not torch.equal(
            relu_dropout(z, 0.5, seed, epoch, layer)[0] != 0, keep), other
    # p = 0 draws nothing: ReLU alone
    zr = torch.randn((50, 7), generator=torch.Generator().manual_seed(1))
    assert torch.equal(relu_dropout(zr, 0.0, 42, 0, 0)[0], torch.relu(zr))


@pytest.mark.parametrize("shape", [(1, 1), (33, 7), (517, 3), (300, 64)])
@pytest.mark.parametrize("p", [0.0, 0.3, 0.5])
def test_k15_plain_pair_is_the_jax_formula(shape, p):
    """K15's plain forward and backward, bitwise the JAX package's hidden
    tail ``where(keep, relu(z)/(1−p), 0)`` and its ``jax.vjp`` on the same
    keep mask, and the packed bits are ``keep and z > 0`` at bit e % 32 of
    word e // 32 (0 past the last element)."""
    rng = np.random.default_rng(shape[0])
    z = rng.standard_normal(shape).astype(np.float32)
    z[0, 0] = 0.0  # ReLU's gradient at 0 is 0
    dh = rng.standard_normal(shape).astype(np.float32)
    seed, epoch, layer = 2**40 + 3, 7, 1
    keep = (dropout_uniforms(z.size, epoch, layer, seed, CPU).numpy()
            >= np.float32(p)).reshape(shape)
    h_jax, vjp = jax.vjp(
        lambda x: jnp.where(keep, jax.nn.relu(x) / (1 - p), 0.0),
        jnp.asarray(z))
    h, mask = relu_dropout_plain(torch.from_numpy(z), p, seed, epoch, layer)
    assert np.array_equal(h.numpy(), np.asarray(h_jax))
    dz = relu_dropout_backward_plain(mask, torch.from_numpy(dh), p)
    assert np.array_equal(dz.numpy(), np.asarray(vjp(jnp.asarray(dh))[0]))
    words = mask.numpy().view(np.uint32)
    assert words.shape == ((z.size + 31) // 32,)
    bits = (words[:, None] >> np.arange(32, dtype=np.uint32)) & 1
    want = np.zeros(words.size * 32, bool)
    want[:z.size] = (keep & (z > 0)).reshape(-1)
    assert np.array_equal(bits.reshape(-1).astype(bool), want)


def test_relu_dropout_saves_no_float_tensor_of_z():
    """The GCN's hidden layer keeps only the packed bits for its backward
    (int32, 1 bit an element), and its gradient is the plain backward's."""
    gen = torch.Generator().manual_seed(4)
    z = torch.randn((300, 64), generator=gen, requires_grad=True)
    dh = torch.randn((300, 64), generator=gen)
    saved = []

    def pack(t):
        saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        h = ReluDropout.apply(z, 0.5, 42, 3, 0)
    assert [(t.dtype, tuple(t.shape)) for t in saved] == [
        (torch.int32, (300 * 64 // 32,))]
    h.backward(dh)
    h_plain, mask = relu_dropout_plain(z.detach(), 0.5, 42, 3, 0)
    assert torch.equal(h.detach(), h_plain)
    assert torch.equal(z.grad, relu_dropout_backward_plain(mask, dh, 0.5))


def test_csr_spmm_backward_is_the_transpose(cora):
    _, g, _, _ = cora
    rows, cols, vals, n = tcl._gcn_adjacency(g)
    a, at = tcl._gcn_operators(g, CPU)
    dense = torch.zeros((n, n))
    dense.index_put_((torch.from_numpy(rows), torch.from_numpy(cols)),
                     torch.from_numpy(vals), accumulate=True)
    assert not torch.equal(dense, dense.T)  # Â is not symmetric
    gen = torch.Generator().manual_seed(2)
    h = torch.randn((n, 16), generator=gen, requires_grad=True)
    weight = torch.randn((n, 16), generator=gen)
    (CsrSpmm.apply(h, a, at) * weight).sum().backward()
    h2 = h.detach().clone().requires_grad_()
    (dense @ h2 * weight).sum().backward()
    torch.testing.assert_close(h.grad, h2.grad, rtol=0, atol=1e-6)
    assert not torch.allclose(h.grad, dense @ weight, atol=1e-3)


def _validation_cases(g, emb, labels):
    """Empty labels, train_ratio out of range, fewer than 4 labelled
    entities (with and without unknown ids).  The "Test set is empty"
    error cannot be reached with 0 < train_ratio < 1: int(n·r) < n."""
    few = dict(list(labels.items())[:3])
    calls = []
    for name in ("mlp_classify", "gcn_classify"):
        calls += [(name, (g, emb, {}), {}),
                  (name, (g, emb, labels), {"train_ratio": 1.0}),
                  (name, (g, emb, labels), {"train_ratio": 0.0}),
                  (name, (g, emb, few), {}),
                  (name, (g, emb, {"x": 0, "y": 1, **few}), {})]
    calls.append(("label_propagation", (g, {}), {}))
    return calls


def test_validation_errors_are_the_jax_ones(karate):
    ref, g, emb, labels = karate
    for (name, args, kw), (_, jargs, _) in zip(
            _validation_cases(g, emb, labels),
            _validation_cases(ref, emb, labels)):
        with pytest.raises(ValueError) as theirs:
            getattr(jcl, name)(*jargs, **kw)
        with pytest.raises(ValueError) as ours:
            getattr(tcl, name)(*args, device="cpu", **kw)
        assert str(ours.value) == str(theirs.value), (name, kw)


def test_without_a_card_every_entry_point_raises(karate, monkeypatch):
    _, g, emb, labels = karate
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [lambda: tcl.label_propagation(g, labels),
             lambda: tcl.label_propagation_predict(g, emb, labels),
             lambda: tcl.mlp_classify(g, emb, labels, num_epochs=1),
             lambda: tcl.gcn_classify(g, emb, labels, num_epochs=1)]
    for call in calls:
        with pytest.raises(RuntimeError, match="pass device='cpu'"):
            call()
