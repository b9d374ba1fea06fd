"""The port's checkpoint.py, convert.checkpoint_from_jax and CLI against
the JAX package's on the CPU.

* checkpoint.py on the cases of tests/test_aux.py against
  cleora_tpu.checkpoint: the port's graph and state round-trip, and its
  checkpointed embeds equal its plain embeds (bitwise: the same segments
  of the same loop) and the JAX package's (whitened: row Gram matrices
  within atol=1e-3, tests/test_torch_embed.py's whitened tolerance).
* checkpoint_from_jax reads a directory that the JAX package's
  embed_with_checkpointing wrote after 20 of 40 iterations; resumed by
  the port to 40, it matches the JAX package's uninterrupted run by Gram
  (atol=1e-3).
* The CLI through main(argv), in-process, against cleora_tpu.cli.main on
  one small edge file: the same stdout for info and merge-shards, the
  same neighbours for similar, and embeddings by Gram (atol=1e-3).
"""

import os

import numpy as np
import pytest

import cleora_tpu as ct
import cleora_tpu.checkpoint as jck
import cleora_tpu.cli as jcli

import cleora_tpu_torch as ctt
import cleora_tpu_torch.checkpoint as tck
import cleora_tpu_torch.cli as tcli
from cleora_tpu_torch.convert import checkpoint_from_jax, from_jax_state
from torch_test_support import one_torch_thread  # noqa: F401

GRAM_ATOL = 1e-3
LINES = ["a b", "b c", "c a", "a d", "d e", "e a", "b e"]


def _gram_close(a, b, atol=GRAM_ATOL):
    np.testing.assert_allclose(a @ a.T, b @ b.T, atol=atol, rtol=0)


@pytest.fixture(scope="module")
def graphs():
    ref = ct.SparseMatrix.from_iterator(iter(LINES),
                                        "complex::reflexive::node")
    return ref, from_jax_state(ref.__getstate__())


# ------------------------------------------------------------ checkpoint.py
def test_checkpoint_roundtrip(graphs, tmp_path):
    _, g = graphs
    d = str(tmp_path / "ckpt")
    emb = ctt.embed(g, feature_dim=8, num_iterations=3, device="cpu")
    assert not tck.has_checkpoint(d)
    tck.save_checkpoint(d, g, emb, 3)
    assert tck.has_checkpoint(d)
    g2, emb2, it = tck.load_checkpoint(d)
    assert it == 3 and np.array_equal(emb, emb2)
    assert isinstance(g2, ctt.SparseMatrix)
    assert g2.entity_ids == g.entity_ids
    tck.save_checkpoint(d, g, emb * 2, 4, save_graph=False)
    assert tck.load_checkpoint(d)[2] == 4


@pytest.mark.parametrize("case", ["matches_plain", "resumes_partial",
                                  "zero_iterations"])
def test_embed_with_checkpointing_like_jax(graphs, tmp_path, case):
    ref_g, g = graphs
    kw = dict(feature_dim=8, checkpoint_every=2)
    outs = []
    for mod, graph, sub, extra in ((jck, ref_g, "ref", {}),
                                   (tck, g, "ours", {"device": "cpu"})):
        d = str(tmp_path / sub)
        if case == "resumes_partial":
            embed = ct.embed if mod is jck else ctt.embed
            mod.save_checkpoint(d, graph, embed(graph, feature_dim=8,
                                                num_iterations=2, **extra), 2)
        n = {"matches_plain": 6, "resumes_partial": 5,
             "zero_iterations": 0}[case]
        outs.append(mod.embed_with_checkpointing(
            graph, num_iterations=n, checkpoint_dir=d, **kw, **extra))
        if n:
            assert mod.load_checkpoint(d)[2] == n
    ref, ours = outs
    plain = ctt.embed(g, feature_dim=8, num_iterations=0, device="cpu")
    if case == "zero_iterations":
        assert np.array_equal(ours, plain) and np.allclose(ref, ours)
        return
    _gram_close(ours, ref)
    if case == "matches_plain":
        # a resume from the last iteration runs nothing
        again = tck.embed_with_checkpointing(
            g, num_iterations=6, checkpoint_dir=str(tmp_path / "ours"),
            device="cpu", **kw)
        assert np.array_equal(again, ours)


def test_checkpoint_errors_like_jax(graphs, tmp_path):
    ref_g, g = graphs
    messages = []
    for mod, graph, sub in ((jck, ref_g, "ref"), (tck, g, "ours")):
        d = str(tmp_path / sub)
        mod.save_checkpoint(d, graph, np.zeros((5, 4), np.float32), 1)
        with pytest.raises(ValueError, match="feature_dim") as err:
            mod.embed_with_checkpointing(graph, feature_dim=8,
                                         checkpoint_dir=d)
        messages.append(str(err.value))
    assert messages[0] == messages[1]
    with pytest.raises(ValueError, match="'npz'"):
        tck.save_checkpoint(str(tmp_path / "o"), g,
                            np.zeros((5, 4), np.float32), 1, backend="orbax")
    with pytest.raises(ValueError, match="'npz'"):
        tck.embed_with_checkpointing(g, checkpoint_dir=str(tmp_path / "o"),
                                     backend="orbax", device="cpu")


# ---------------------------------------------------- checkpoint_from_jax
def test_resume_a_jax_run(tmp_path):
    rng = np.random.default_rng(4)
    lines = [f"n{rng.integers(0, 60)} n{rng.integers(0, 60)}"
             for _ in range(300)]
    ref_g = ct.SparseMatrix.from_iterator(iter(lines),
                                          "complex::reflexive::node")
    kw = dict(feature_dim=8, checkpoint_every=10)
    d = str(tmp_path / "jax")
    jck.embed_with_checkpointing(ref_g, num_iterations=20, checkpoint_dir=d,
                                 **kw)
    whole = jck.embed_with_checkpointing(
        ref_g, num_iterations=40, checkpoint_dir=str(tmp_path / "jax40"),
        **kw)
    g, emb, it = checkpoint_from_jax(d)
    assert it == 20 and isinstance(g, ctt.SparseMatrix)
    assert g.entity_ids == ref_g.entity_ids
    for name in ("indptr", "indices", "left_vals", "sym_vals",
                 "entity_hashes"):
        assert np.array_equal(getattr(g.data, name),
                              getattr(ref_g.data, name))
    ours_dir = str(tmp_path / "ours")
    tck.save_checkpoint(ours_dir, g, emb, it)
    resumed = tck.embed_with_checkpointing(
        g, num_iterations=40, checkpoint_dir=ours_dir, device="cpu", **kw)
    assert tck.load_checkpoint(ours_dir)[2] == 40
    _gram_close(resumed, whole)


def test_checkpoint_from_jax_refuses_other_pickles(graphs, tmp_path):
    _, g = graphs
    d = str(tmp_path / "port")
    tck.save_checkpoint(d, g, np.zeros((5, 4), np.float32), 1)
    with pytest.raises(Exception, match="refusing to unpickle"):
        checkpoint_from_jax(d)  # the port's own SparseMatrix pickle
    with open(os.path.join(d, "graph.pkl"), "wb") as f:
        f.write(b"cos\nsystem\n(S'true'\ntR.")
    with pytest.raises(Exception, match="refusing to unpickle os.system"):
        checkpoint_from_jax(d)


# ---------------------------------------------------------------- the CLI
@pytest.fixture(scope="module")
def edge_file(tmp_path_factory):
    rng = np.random.default_rng(9)
    path = tmp_path_factory.mktemp("cli") / "edges.tsv"
    path.write_text("\n".join(f"n{rng.integers(0, 80)} n{rng.integers(0, 80)}"
                              for _ in range(400)) + "\n")
    return str(path)


def _run(capsys, main, argv):
    main(argv)
    return capsys.readouterr().out


@pytest.mark.parametrize("mode", ["in_ram", "streaming"])
def test_cli_embed_like_jax(edge_file, tmp_path, capsys, mode):
    outs = []
    for main, sub, extra in ((jcli.main, "ref", []),
                             (tcli.main, "ours", ["--device", "cpu"])):
        out = str(tmp_path / f"{sub}.npz")
        # 40 iterations: the JAX package compiles this loop once for this
        # test and similar's embed
        argv = ["embed", "-i", edge_file, "-o", out, "-d", "8", "-n", "40"]
        if mode == "streaming":
            argv += ["--streaming", str(tmp_path / f"{sub}_g")]
        said = _run(capsys, main, argv + extra)
        outs.append((said.replace(out, "OUT"), np.load(out)))
    (said_ref, ref), (said, ours) = outs
    assert said == said_ref
    assert list(ours["entity_ids"]) == list(ref["entity_ids"])
    _gram_close(ours["embeddings"], ref["embeddings"])


def test_cli_streaming_npy_and_sharded(edge_file, tmp_path, capsys):
    """A streamed build's .npy output streams shard by shard; --sharded
    with --checkpoint-dir runs the checkpointed sharded loop."""
    ref = ctt.embed(ctt.SparseMatrix.from_iterator(
        iter(open(edge_file).read().split("\n")[:-1]),
        "complex::reflexive::node"), feature_dim=8, num_iterations=5,
        device="cpu")
    npy = str(tmp_path / "e.npy")
    said = _run(capsys, tcli.main, [
        "embed", "-i", edge_file, "-o", npy, "-d", "8", "-n", "5",
        "--streaming", str(tmp_path / "g"), "--device", "cpu"])
    assert "streamed to" in said
    assert np.array_equal(np.load(npy), ref)
    npy2 = str(tmp_path / "e2.npy")
    _run(capsys, tcli.main, [
        "embed", "-i", edge_file, "-o", npy2, "-d", "8", "-n", "5",
        "--sharded", "--checkpoint-dir", str(tmp_path / "ck"),
        "--checkpoint-every", "2", "--device", "cpu"])
    assert np.array_equal(np.load(npy2), ref)
    assert os.path.exists(tmp_path / "ck" / "checkpoint.json")


def test_cli_sharded_sibling(edge_file, tmp_path, capsys):
    """`embed --sharded 1 -a prone --backend device` runs the sharded
    ProNE (one shard, no group) and saves what embed_prone returns;
    without --backend device it exits with the JAX CLI's message."""
    import cleora_tpu_torch.algorithms as talg

    out = str(tmp_path / "prone.npz")
    argv = ["embed", "-i", edge_file, "-o", out, "-d", "8", "-a", "prone",
            "--sharded", "1", "--device", "cpu"]
    said = _run(capsys, tcli.main, argv + ["--backend", "device"])
    assert "saved to" in said
    graph = ctt.SparseMatrix.from_iterator(
        iter(open(edge_file).read().split("\n")[:-1]),
        "complex::reflexive::node")
    want = talg.embed_prone(graph, 8, backend="device", n_devices=1,
                            device="cpu")
    got = np.load(out)
    assert list(got["entity_ids"]) == list(graph.entity_ids)
    assert np.array_equal(got["embeddings"], want)
    with pytest.raises(SystemExit, match="requires --backend device") as err:
        tcli.main(argv)
    with pytest.raises(SystemExit) as jerr:
        jcli.main(argv[:-2])
    assert str(err.value) == str(jerr.value)


def test_cli_info_similar_merge_like_jax(edge_file, tmp_path, capsys):
    cols = "complex::reflexive::node"
    assert (_run(capsys, tcli.main, ["info", "-i", edge_file])
            == _run(capsys, jcli.main, ["info", "-i", edge_file]))
    sims = [_run(capsys, main, ["similar", "-i", edge_file, "-e", "n3",
                                "-k", "3", "-d", "8"] + extra)
            for main, extra in ((jcli.main, []),
                                (tcli.main, ["--device", "cpu"]))]
    names = [[line.split()[0] for line in s.splitlines()] for s in sims]
    assert names[0] == names[1] and len(names[1]) == 3
    pieces = []
    for k in range(2):
        piece = str(tmp_path / f"p{k}")
        said = _run(capsys, tcli.main, ["embed", "-i", edge_file,
                                        "--streaming", piece,
                                        "--shard", f"{k}/2", "-c", cols])
        assert said.startswith(f"Built shard {k}/2")
        pieces.append(piece)
    said = [_run(capsys, main, ["merge-shards", *pieces, "-o",
                                str(tmp_path / sub)]).split("(")[0]
            for main, sub in ((jcli.main, "m_ref"), (tcli.main, "m_ours"))]
    assert said[0].replace("m_ref", "m") == said[1].replace("m_ours", "m")
    for name in ("indptr.bin", "indices.bin", "left_vals.bin", "hashes.bin"):
        with open(tmp_path / "m_ref" / name, "rb") as a, \
                open(tmp_path / "m_ours" / name, "rb") as b:
            assert a.read() == b.read(), name
