"""The port's graph build against the JAX package's: bitwise.

Both packages' GraphData fields and the deterministic hash init must agree
bit for bit, on the C++ ingest core and on the numpy fallback.
"""

import pickle

import numpy as np
import pytest

import cleora_tpu as ct
import cleora_tpu.graph.builder as jax_builder
import cleora_tpu.graph.hashing as jax_hashing
import cleora_tpu.graph.native as jax_native
import cleora_tpu_torch as ctt
import cleora_tpu_torch.graph.builder as port_builder
import cleora_tpu_torch.graph.hashing as port_hashing
import cleora_tpu_torch.graph.native as port_native
import cleora_tpu_torch.native as port_native_lib
from cleora_tpu.datasets import load_dataset
from cleora_tpu_torch.convert import from_jax_state
from torch_test_support import one_torch_thread  # noqa: F401

_FIELDS = ("entity_hashes", "column_ids", "row_sums", "indptr", "indices",
           "left_vals", "sym_vals")


def _karate():
    d = load_dataset("karate_club")
    return d["edges"], d["columns"], 16


def _random_edges():
    rng = np.random.default_rng(11)
    src = rng.integers(0, 300, size=1500)
    dst = rng.integers(0, 300, size=1500)
    return [f"{s} {d}" for s, d in zip(src, dst)], "complex::reflexive::node", 16


def _hyperedges():
    rng = np.random.default_rng(5)
    lines = []
    for u in range(120):
        k = int(rng.integers(1, 12))
        items = rng.choice(60, size=k, replace=False)
        lines.append(f"u{u}\t" + " ".join(f"p{i}" for i in items))
    # hyperedge trimming (side longer than hyperedge_trim_n) is exercised
    return lines, "user complex::product", 4


_CASES = {"karate": _karate, "random_edges": _random_edges,
          "hyperedge_tsv": _hyperedges}


def assert_same_graph(a, b):
    assert a.entity_ids == b.entity_ids
    # two packages, two dataclass types: compare the fields
    assert vars(a.descriptor) == vars(b.descriptor)
    for f in _FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        assert x.tobytes() == y.tobytes(), f


@pytest.mark.parametrize("case", sorted(_CASES))
@pytest.mark.parametrize("builder", ["native", "numpy"])
def test_graph_data_bitwise(case, builder):
    lines, columns, trim = _CASES[case]()
    if builder == "native":
        if port_native_lib.get_lib() is None:
            pytest.fail("the port's native builder did not build")
        ours = port_native.build_graph_native(lines, columns, trim)
        ref = jax_native.build_graph_native(lines, columns, trim)
    else:
        ours = port_builder.build_graph(lines, columns, trim)
        ref = jax_builder.build_graph(lines, columns, trim)
    assert_same_graph(ours, ref)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_init_bitwise(case, monkeypatch):
    lines, columns, trim = _CASES[case]()
    hashes = jax_builder.build_graph(lines, columns, trim).entity_hashes
    ref = jax_hashing.init_embeddings(hashes, 48, seed=3)
    # several blocks, the last one ragged
    monkeypatch.setattr(port_hashing, "_INIT_BLOCK_ROWS", 7)
    ours = port_hashing.init_embeddings(hashes, 48, seed=3)
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    assert ours.tobytes() == ref.tobytes()


@pytest.mark.parametrize("native", [True, False])
def test_sparse_matrix_from_files(tmp_path, monkeypatch, native):
    lines, columns, trim = _hyperedges()
    path = tmp_path / "hyper.tsv"
    path.write_text("\n".join(lines) + "\n")
    if not native:
        # CLEORA_TPU_NATIVE=0 forces the numpy fallback on the next load
        monkeypatch.setenv("CLEORA_TPU_NATIVE", "0")
        monkeypatch.setattr(port_native_lib, "_lib", None)
        monkeypatch.setattr(port_native_lib, "_load_failed", False)
    ours = ctt.SparseMatrix.from_files([str(path)], columns, trim)
    assert (port_native_lib.get_lib() is not None) == native
    ref = ct.SparseMatrix.from_files([str(path)], columns, trim)
    assert_same_graph(ours.data, ref.data)
    a = ours.initialize_deterministically(32, seed=1)
    b = ref.initialize_deterministically(32, seed=1)
    assert a.tobytes() == b.tobytes()


def test_sparse_matrix_from_iterator_and_edge_arrays():
    lines, columns, trim = _karate()
    ours = ctt.SparseMatrix.from_iterator(iter(lines), columns, trim)
    ref = ct.SparseMatrix.from_iterator(iter(lines), columns, trim)
    assert_same_graph(ours.data, ref.data)
    rng = np.random.default_rng(2)
    src, dst = rng.integers(0, 500, 2000), rng.integers(0, 500, 2000)
    assert_same_graph(ctt.SparseMatrix.from_edge_arrays(src, dst).data,
                      ct.SparseMatrix.from_edge_arrays(src, dst).data)
    with pytest.raises(ValueError, match="equal length"):
        ctt.SparseMatrix.from_edge_arrays(src, dst[:-1])


def test_sparse_matrix_inspection_and_pickle():
    lines, columns, trim = _hyperedges()
    ref = ct.SparseMatrix.from_iterator(iter(lines), columns, trim)
    ours = from_jax_state(ref.__getstate__())
    assert_same_graph(ours.data, ref.data)
    assert_same_graph(from_jax_state(pickle.loads(ref.__getstate__())).data,
                      ref.data)
    assert repr(ours) == repr(ref) and len(ours) == len(ref)
    assert ours.num_entities == ref.num_entities
    assert ours.num_edges == ref.num_edges
    assert ours.entity_ids == ref.entity_ids
    assert ours.get_entity_index("p7") == ref.get_entity_index("p7")
    assert (ours.get_entity_indices(["u3", "p1"])
            == ref.get_entity_indices(["u3", "p1"]))
    with pytest.raises(ValueError, match="Entity 'nope' not found"):
        ours.get_entity_index("nope")
    for mt in ("left", "symmetric"):
        for x, y in zip(ours.to_sparse_csr(mt), ref.to_sparse_csr(mt)):
            assert np.array_equal(x, y)
    again = pickle.loads(pickle.dumps(ours))
    assert_same_graph(again.data, ref.data)
    with pytest.raises(ValueError, match="missing"):
        from_jax_state({"indptr": np.zeros(1)})
    with pytest.raises(ValueError, match="cannot be constructed directly"):
        ctt.SparseMatrix(1)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_sparse_matrix_node_methods_exactly_equal(case):
    lines, columns, trim = _CASES[case]()
    ref = ct.SparseMatrix.from_iterator(iter(lines), columns, trim)
    # through the converter: the column ids travel with the graph state
    ours = from_jax_state(ref.__getstate__())
    degrees = ours.entity_degrees
    assert degrees.dtype == ref.entity_degrees.dtype
    assert degrees.tobytes() == ref.entity_degrees.tobytes()
    degrees[:] = -1  # a copy: the graph keeps its own
    assert ours.entity_degrees.tobytes() == ref.entity_degrees.tobytes()
    d = ref.descriptor
    for name in {d.col_a_name, d.col_b_name}:
        mask = ours.get_entity_column_mask(name)
        assert mask.dtype == bool
        assert np.array_equal(mask, ref.get_entity_column_mask(name))
    for eid in ref.entity_ids[:25]:
        assert ours.get_neighbors(eid) == ref.get_neighbors(eid)
    x = np.random.default_rng(1).standard_normal(
        (ours.num_entities, 6)).astype(np.float32)
    x[0] = 0.0
    assert ours.l2_normalize(x).tobytes() == ref.l2_normalize(x).tobytes()
    for call in (lambda g: g.get_entity_column_mask("banana"),
                 lambda g: g.get_neighbors("banana")):
        with pytest.raises(ValueError) as ref_err:
            call(ref)
        with pytest.raises(ValueError) as our_err:
            call(ours)
        assert str(our_err.value) == str(ref_err.value)


def test_column_mask_after_conversion_of_a_complex_graph():
    lines, columns, trim = _hyperedges()
    assert "complex::" in columns
    ref = ct.SparseMatrix.from_iterator(iter(lines), columns, trim)
    ours = from_jax_state(pickle.loads(ref.__getstate__()))
    users = ours.get_entity_column_mask("user")
    products = ours.get_entity_column_mask("product")
    assert users.sum() == 120 and products.sum() == ours.num_entities - 120
    assert not np.any(users & products)
    assert all(ours.entity_ids[i].startswith("u") for i in np.flatnonzero(users))


def test_converted_graph_feeds_the_spectral_siblings():
    """The graph is the only state the spectral siblings need: a converted
    graph runs embed_randne and gives the JAX package's result (the same
    float64 host code on the same arrays)."""
    import cleora_tpu.algorithms as jalg
    import cleora_tpu_torch.algorithms as talg

    lines, columns, trim = _hyperedges()
    ref = ct.SparseMatrix.from_iterator(iter(lines), columns, trim)
    ours = from_jax_state(ref.__getstate__())
    kw = dict(feature_dim=16, num_iterations=6, seed=3)
    assert np.array_equal(talg.embed_randne(ours, **kw),
                          jalg.embed_randne(ref, **kw))
    np.testing.assert_allclose(
        talg.embed_randne(ours, backend="device", device="cpu", **kw),
        jalg.embed_randne(ref, backend="device", **kw), rtol=0, atol=1e-4)
