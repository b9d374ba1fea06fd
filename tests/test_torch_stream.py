"""The port's streamed build (cleora_tpu_torch/graph/stream.py) against the
JAX package's (cleora_tpu/graph/stream.py) on the inputs of
tests/test_stream_build.py.

Both packages run the same native streaming core (each its own copy), so
for the same input and RAM cap every on-disk array — the CSR, both Markov
value arrays, row sums, entity hashes, column ids and the id blob — and
the meta must be bitwise equal.
"""

import contextlib
import json
import os

import numpy as np
import pytest

import cleora_tpu.graph.stream as jstream
import cleora_tpu_torch.graph.stream as tstream
from cleora_tpu.graph.native import native_available
from cleora_tpu_torch.sparse import SparseMatrix
from torch_test_support import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native builder unavailable"
)

_ARRAYS = ("indptr", "indices", "left_vals", "sym_vals", "entity_hashes",
           "column_ids", "row_sums", "id_lens", "id_blob")


def _assert_same(ours, ref):
    assert type(ours) is tstream.DiskGraph
    for name in _ARRAYS:
        a, b = np.asarray(getattr(ours, name)), np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    with open(os.path.join(ours.path, "meta.json")) as f:
        meta_ours = json.load(f)
    with open(os.path.join(ref.path, "meta.json")) as f:
        meta_ref = json.load(f)
    assert meta_ours == meta_ref


def _both(tmp_path, fn, source, columns, *rest, **kw):
    """Run ``fn(source, columns, out_dir, *rest)`` of both modules into two
    directories (``source`` a list, so that each reads all of it)."""
    ref = getattr(jstream, fn)(source, columns, str(tmp_path / "ref"), *rest,
                               **kw)
    ours = getattr(tstream, fn)(source, columns, str(tmp_path / "ours"),
                                *rest, **kw)
    return ours, ref


def _pair_lines(seed, n_nodes, n_lines, prefix="n", sep=" "):
    rng = np.random.default_rng(seed)
    return [f"{prefix}{rng.integers(0, n_nodes)}{sep}"
            f"{prefix}{rng.integers(0, n_nodes)}" for _ in range(n_lines)]


def _hyperedge_lines(seed, n_lines):
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(n_lines):
        a = " ".join(f"u{rng.integers(0, 50)}"
                     for _ in range(rng.integers(1, 40)))
        b = " ".join(f"p{rng.integers(0, 80)}"
                     for _ in range(rng.integers(1, 40)))
        lines.append(f"{a}\t{b}")
    return lines


@pytest.mark.parametrize("case", ["pairs", "trimmed_hyperedges"])
def test_line_builds_bitwise(tmp_path, case):
    if case == "pairs":
        lines, cols, kw = (_pair_lines(1, 300, 8000),
                           "complex::reflexive::node",
                           dict(chunk_bytes=2048))
    else:
        lines, cols, kw = (_hyperedge_lines(2, 400),
                           "complex::user complex::product",
                           dict(hyperedge_trim_n=8, chunk_bytes=1024))
    ours, ref = _both(tmp_path, "build_graph_streaming", lines, cols,
                      ram_cap_bytes=64 << 20, **kw)
    _assert_same(ours, ref)
    assert ours.entity_ids == ref.entity_ids


@pytest.mark.parametrize("case", ["tiny_cap_runs", "loser_tree", "two_column"])
def test_pair_feed_builds_bitwise(tmp_path, monkeypatch, case):
    rng = np.random.default_rng(3)
    if case == "tiny_cap_runs":
        src = rng.integers(0, 1000, 60_000)
        dst = rng.integers(0, 1000, 60_000)
        chunks = [(src[i:i + 7000], dst[i:i + 7000])
                  for i in range(0, 60_000, 7000)]
        cols = "complex::reflexive::n"
    elif case == "loser_tree":
        # many small spilled runs, a hub key in every run
        monkeypatch.setenv("CLEORA_STREAM_RUN_PAIRS", "4096")
        src = np.concatenate([rng.integers(0, 800, 20_000),
                              np.zeros(20_000, dtype=np.int64)])
        dst = rng.integers(0, 800, 40_000)
        chunks, cols = [(src, dst)], "complex::reflexive::n"
    else:
        src = rng.integers(0, 400, 10_000)
        dst = rng.integers(0, 400, 10_000)
        chunks, cols = [(src, dst)], "complex::a complex::b"
    ours, ref = _both(tmp_path, "build_graph_streaming_pairs", chunks, cols,
                      ram_cap_bytes=64 << 20)
    _assert_same(ours, ref)
    if case == "loser_tree":
        assert ours.meta["pairs_emitted"] >= 4096 * 4
    assert not [f for f in os.listdir(ours.path) if f.startswith("run_")]


@pytest.mark.parametrize("case", ["chunk_boundary_mid_line", "bad_lines"])
def test_file_builds_bitwise(tmp_path, case):
    p = tmp_path / "in.txt"
    if case == "chunk_boundary_mid_line":
        p.write_text("\n".join(_pair_lines(4, 99, 3000, "x")))  # no final \n
        kw = dict(chunk_bytes=97)
    else:
        p.write_bytes(b"a b\n\xed\xa0\x80 c\n\nbad\tline\there\nb c\n")
        kw = {}
    with (pytest.warns(UserWarning) if case == "bad_lines"
          else contextlib.nullcontext()):
        ours, ref = _both(tmp_path, "build_graph_streaming", [str(p)],
                          "complex::reflexive::n", files=True, **kw)
    _assert_same(ours, ref)


def test_row_range_reopen_and_materialize(tmp_path):
    lines = _pair_lines(5, 100, 2000)
    ours, ref = _both(tmp_path, "build_graph_streaming", lines,
                      "complex::reflexive::n")
    for lo, hi in ((10, 30), (0, ours.num_entities), (40, 40)):
        for mt in ("left", "symmetric"):
            for a, b in zip(ours.row_range(lo, hi, mt),
                            ref.row_range(lo, hi, mt)):
                assert a.dtype == b.dtype and np.array_equal(a, b)
    again = tstream.DiskGraph(ours.path)  # a fresh open from disk
    _assert_same(again, ref)
    sm = again.to_sparse_matrix()
    assert isinstance(sm, SparseMatrix)
    ref_sm = ref.to_sparse_matrix()
    assert sm.entity_ids == ref_sm.entity_ids
    for name in ("indptr", "indices", "left_vals", "sym_vals"):
        assert np.array_equal(getattr(sm.data, name),
                              getattr(ref_sm.data, name))
    for seed in (0, 3):
        assert np.array_equal(again.initialize_deterministically(8, seed),
                              ref.initialize_deterministically(8, seed))


def test_sharded_pieces_and_merge_bitwise(tmp_path):
    rng = np.random.default_rng(22)
    lines = []
    for _ in range(500):  # pair lines and trimming-heavy hyperedges
        if rng.random() < 0.2:
            lines.append(_hyperedge_lines(int(rng.integers(1 << 30)), 1)[0])
        else:
            lines.append(f"u{rng.integers(0, 40)}\tp{rng.integers(0, 60)}")
    cols = "complex::user complex::product"
    pieces = []
    for k in range(3):
        ours, ref = _both(tmp_path / f"piece{k}",
                          "build_graph_streaming_sharded", lines, cols, k, 3,
                          hyperedge_trim_n=8, chunk_bytes=777)
        _assert_same(ours, ref)
        pieces.append((ours.path, ref.path))
    merged = tstream.merge_disk_graph_shards([p for p, _ in pieces],
                                             str(tmp_path / "m_ours"))
    merged_ref = jstream.merge_disk_graph_shards([p for _, p in pieces],
                                                 str(tmp_path / "m_ref"))
    _assert_same(merged, merged_ref)
    full = tstream.build_graph_streaming(iter(lines), cols,
                                         str(tmp_path / "full"),
                                         hyperedge_trim_n=8)
    for name in ("indptr", "indices", "left_vals", "sym_vals"):
        assert np.array_equal(np.asarray(getattr(merged, name)),
                              np.asarray(getattr(full, name)))
    with pytest.raises(ValueError, match="tile|uncovered"):
        tstream.merge_disk_graph_shards([pieces[0][0], pieces[2][0]],
                                        str(tmp_path / "gap"))


def test_empty_pieces_and_counts(tmp_path):
    lines = [f"n{i % 20} n{(i * 3) % 20}" for i in range(200)]
    cols = "complex::reflexive::n"
    n = tstream.count_entities_streaming(lines, cols, chunk_bytes=512)
    assert n == jstream.count_entities_streaming(lines, cols,
                                                 chunk_bytes=512) == 20
    lo, hi = tstream.host_piece_range(n, 8, 2, 3)
    assert (lo, hi) == jstream.host_piece_range(n, 8, 2, 3) == (n, n)
    ours, ref = _both(tmp_path, "build_graph_streaming", lines, cols,
                      row_range=(lo, hi))
    _assert_same(ours, ref)
    assert len(tstream.DiskGraph(ours.path).indices) == 0
    ours, ref = _both(tmp_path / "last", "build_graph_streaming_sharded",
                      lines, cols, 7, 8, n_entities=n)
    _assert_same(ours, ref)
    assert ours.num_edges == 0


@pytest.mark.parametrize("n", [0, 1, 7, 63, 64, 65, 1000, 1_958_363])
def test_shard_cut_formula(n):
    for p in (1, 2, 3, 4, 8):
        assert (tstream.shard_row_params(n, p)
                == jstream.shard_row_params(n, p))
        assert (tstream.shard_row_bounds(n, p)
                == jstream.shard_row_bounds(n, p))
        for spc in (1, 2):
            for h in range(max(1, p // spc)):
                assert (tstream.host_piece_range(n, p, spc, h)
                        == jstream.host_piece_range(n, p, spc, h))


@pytest.mark.parametrize("source,match", [
    ("empty", "No valid hyperedge lines"),
    ("bytes", "Iterator must yield strings"),
    ("newline", "single lines"),
    ("bare_path", "LIST of paths"),
])
def test_errors_match(tmp_path, source, match):
    p = tmp_path / "edges.tsv"
    p.write_text("a b\nb c\n")
    kw = {"files": True} if source == "bare_path" else {}
    errors = []
    for mod, sub in ((jstream, "ref"), (tstream, "ours")):
        src = {"empty": iter([]), "bytes": iter([b"a b"]),
               "newline": iter(["a b\nc d"]), "bare_path": str(p)}[source]
        with pytest.raises(ValueError, match=match) as err:
            mod.build_graph_streaming(src, "complex::reflexive::n",
                                      str(tmp_path / sub), **kw)
        errors.append(str(err.value))
    assert errors[0] == errors[1]
