"""K17's rounds and K14's layout on the CPU, against the one-card walks and
the JAX package.

* K17's plain round version (``ops/walk.py:walk_owned_round_plain``, run
  by ``walk_uniform_sharded`` for every slice held in this process):
  bitwise ``walk_uniform_plain`` at 1-4 slices and walk lengths 1, 2 and
  10 on a graph with a hub, a dead row, an isolated node and pad lanes;
  one round at one slice, at most ``walk_length − 1`` past it, and, where
  every lane's rows stay on its slice, two: the round that finished them
  and the round that counted them.
* K14's layout: label propagation carries its buffers at a stride rounded
  up to ``classify.LABEL_STRIDE`` columns; the plain step over those
  padded columns is bitwise the unpadded step in its first C columns, and
  ``label_propagation`` matches the JAX package's F (atol=1e-6: the row
  sums in another order over 30 steps) and predictions (but where JAX's
  two largest values lie within 1e-6) at C in {2, 7, 40, 47}.
"""

import numpy as np
import pytest
import torch

import cleora_tpu as ct
import cleora_tpu.classify as jcl
import cleora_tpu_torch as ctt
import cleora_tpu_torch.classify as tcl
from cleora_tpu_torch.ops import walk as twalk
from cleora_tpu_torch.ops.label_prop import label_prop_step_plain
from cleora_tpu_torch.ops.spmm import CsrMatrix
from torch_test_support import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
CLASSES = (2, 7, 40, 47)


def _walk_csr(n, seed, hub=60):
    """A walk CSR (indptr, cols, deg) with a hub (node 1), a dead row
    (node 2: no out-edges, others lead to it) and an isolated node
    (n - 1)."""
    rng = np.random.default_rng(seed)
    src = np.concatenate([rng.integers(0, n - 1, 3 * n), np.ones(hub, int)])
    dst = np.concatenate([rng.integers(0, n - 1, 3 * n),
                          rng.choice(n - 1, hub, replace=False)])
    keys = np.unique(np.concatenate([src * n + dst, dst * n + src]))
    rows, cols = keys // n, keys % n
    keep = (rows != cols) & (rows != 2)
    rows, cols = rows[keep], cols[keep]
    deg = np.bincount(rows, minlength=n).astype(np.int32)
    indptr = np.concatenate([[0], np.cumsum(deg)[:-1]]).astype(np.int32)
    return indptr, cols.astype(np.int32), deg


def _starts(n, lanes, seed):
    starts = np.random.default_rng(seed).integers(0, n + 1, lanes)
    starts[:4] = (1, 2, n - 1, n)  # hub, dead row, isolated node, pad lane
    return torch.from_numpy(starts.astype(np.int32))


@pytest.mark.parametrize("world", [1, 2, 3, 4])
@pytest.mark.parametrize("length", [1, 2, 10])
def test_k17_rounds_are_the_one_card_walks(world, length):
    n = 301
    arrays = _walk_csr(n, world)
    starts = _starts(n, 500, length)
    seed, base = 2**40 + 9, 17
    want = twalk.walk_uniform_plain(*map(torch.from_numpy, arrays), starts,
                                    length, seed, base, n)
    slices = [twalk.ShardedWalkTables(*arrays, n, r, world, CPU)
              for r in range(world)]
    stats = {}
    got = twalk.walk_uniform_sharded(slices, starts, length, seed, base,
                                     stats=stats)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    if world == 1:
        assert stats["rounds"] == 1
    else:
        assert 1 <= stats["rounds"] <= max(1, length - 1)


def test_k17_one_round_plain_state_and_writes():
    """One round of two slices by hand, each alone (as one rank's process)
    and both on one buffer (as one process): every lane's state has exactly
    one writer, the summed states name the last entry each lane resolved,
    the walk entries written are the one-card walks' entries up to each
    lane's hop, and the next round's count is the lanes short of the last
    hop."""
    n, length = 301, 10
    arrays = _walk_csr(n, 3)
    starts = _starts(n, 400, 3)
    want = twalk.walk_uniform_plain(*map(torch.from_numpy, arrays), starts,
                                    length, 5, 0, n)
    b = starts.shape[0]
    slices = [twalk.ShardedWalkTables(*arrays, n, r, 2, CPU)
              for r in range(2)]
    walks = torch.zeros((b, length), dtype=torch.int32)
    shared = torch.zeros((2, b), dtype=torch.int32)
    shares = []
    for t in slices:
        mine = torch.full((2, b), 7, dtype=torch.int32)
        twalk.walk_owned_round(t, starts, None, walks, 5, 0, mine, True)
        twalk.walk_owned_round(t, starts, None, walks.clone(), 5, 0, shared)
        shares.append(mine)
    state = shares[0] + shares[1]
    assert torch.equal(state, shared)
    taken = [s.any(dim=0) for s in shares]
    assert not bool((taken[0] & taken[1]).any())
    nodes, hops = state[0], state[1].long()
    assert torch.equal(nodes, want[torch.arange(b), hops])
    upto = torch.arange(length)[None, :] <= hops[:, None]
    assert torch.equal(walks[upto], want[upto])
    assert not bool(walks[~upto].any())
    live = torch.zeros(1, dtype=torch.int32)
    twalk.walk_owned_round(slices[0], state[0], state[1], walks.clone(), 5,
                           0, torch.zeros_like(state), True, live)
    assert int(live) == int((hops < length - 1).sum())


def test_k17_local_rows_stop_after_two_rounds():
    """Two slices of a graph whose edges stay inside each slice: every
    lane ends in the first round, the second counts none left, and the
    host reads that count after it."""
    n, half = 200, 100
    rng = np.random.default_rng(4)
    src = rng.integers(0, half, 600)
    dst = rng.integers(0, half, 600)
    src = np.concatenate([src, src + half])
    dst = np.concatenate([dst, dst + half])
    keys = np.unique(np.concatenate([src * n + dst, dst * n + src]))
    rows, cols = keys // n, keys % n
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    deg = np.bincount(rows, minlength=n).astype(np.int32)
    indptr = np.concatenate([[0], np.cumsum(deg)[:-1]]).astype(np.int32)
    arrays = (indptr, cols.astype(np.int32), deg)
    starts = torch.arange(n, dtype=torch.int32)
    length = 20
    want = twalk.walk_uniform_plain(*map(torch.from_numpy, arrays), starts,
                                    length, 1, 0, n)
    slices = [twalk.ShardedWalkTables(*arrays, n, r, 2, CPU)
              for r in range(2)]
    stats = {}
    got = twalk.walk_uniform_sharded(slices, starts, length, 1, 0,
                                     stats=stats)
    assert torch.equal(got, want)
    assert stats["rounds"] == 2


# --------------------------------------------------------------------- K14
def _labelled_pair(c):
    """One random graph built by both packages, and a training split of
    random labels of ``c`` classes (every class present)."""
    rng = np.random.default_rng(c)
    lines = [f"n{rng.integers(0, 240)} n{rng.integers(0, 240)}"
             for _ in range(900)]
    ref = ct.SparseMatrix.from_iterator(iter(lines), "complex::reflexive::n")
    g = ctt.SparseMatrix.from_iterator(iter(lines), "complex::reflexive::n")
    assert ref.entity_ids == g.entity_ids
    ids = g.entity_ids
    classes = np.concatenate([np.arange(c), rng.integers(0, c, len(ids))])
    labels = {e: int(classes[i]) for i, e in enumerate(ids)}
    train = {e: labels[e] for i, e in enumerate(ids)
             if i % 3 == 0 or i < c}
    return ref, g, train


@pytest.mark.parametrize("c", CLASSES)
def test_padded_step_is_the_unpadded_step(c):
    ref, g, train = _labelled_pair(c)
    rows, cols, svals, n = tcl._row_normalized(g)
    S = CsrMatrix.from_coo(rows, cols, svals, n, CPU)
    rng = np.random.default_rng(c + 1)
    f = torch.from_numpy(rng.random((n, c)).astype(np.float32))
    y = torch.from_numpy((rng.random((n, c)) < 0.1).astype(np.float32))
    mask = torch.from_numpy(rng.random(n) < 0.3)
    wide = -(-c // tcl.LABEL_STRIDE) * tcl.LABEL_STRIDE
    pad = torch.nn.functional.pad
    for alpha in (0.5, 0.3):
        beta = float(np.float32(1) - np.float32(alpha))
        want = label_prop_step_plain(S, f, y, mask, alpha, beta)
        got = label_prop_step_plain(S, pad(f, (0, wide - c)),
                                    pad(y, (0, wide - c)), mask, alpha, beta)
        assert got.shape == (n, wide)
        assert torch.equal(got[:, :c], want)
        assert not bool(got[:, c:].any())


@pytest.mark.parametrize("c", CLASSES)
def test_label_propagation_matches_jax_at_class_counts(c):
    ref, g, train = _labelled_pair(c)
    Y, mask, classes = tcl._label_matrix(g, train)
    assert Y.shape[1] == c
    (prow, pcol, pval), n = jcl._row_normalized_coo(ref)
    want = np.asarray(jcl._label_prop_jit()(
        prow, pcol, pval, Y, mask, np.float32(0.5), n_rows=n, iters=30))
    rows, cols, svals, _ = tcl._row_normalized(g)
    S = CsrMatrix.from_coo(rows, cols, svals, n, CPU)
    got = tcl._propagate_labels(S, torch.from_numpy(Y),
                                torch.from_numpy(mask), 0.5, 30)
    assert got.shape == (n, c)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)

    top2 = np.sort(want, axis=1)[:, -2:]
    tie = top2[:, 1] - top2[:, 0] <= 1e-6
    ours = tcl.label_propagation(g, train, device="cpu")
    theirs = jcl.label_propagation(ref, train)
    ids = g.entity_ids
    assert all(ours[e] == theirs[e] for i, e in enumerate(ids) if not tie[i])
    assert all(ours[e] == train[e] for e in train)  # clamped
