"""K1's fused normalisation, its hub slices, the fused attention pass and
the trace writer, on the CPU.

* the loop step and the attention step (plain versions: ``spmm_plain`` →
  the plain normalisation; K4's plain weights → ``spmm_plain`` → the
  plain normalisation) against ``cleora_tpu.embed`` and
  ``cleora_tpu.embed_with_attention`` unwhitened, both fed one CSR with
  empty rows, a row whose values are all 0, zero values and a hub row
  (rtol=1e-5, atol=1e-6: one or two iterations of float32 sums taken in
  another order);
* the hub plan (``kernels.hub_plan``): every entry of a cut row in
  exactly one slice, in chunk-interleaved order, cuts decided by a row's
  own degree (a shard's plan is the whole matrix's on its rows);
* K1's slice-and-join and the fused pass's online softmax with its slice
  merge, restated here in torch/numpy in the kernels' order, against
  ``spmm_plain`` and against the JAX attention step: the kernels' algebra
  where the kernels cannot run;
* ``tracing.add_port_kernels``, ``port_launches`` and ``busy_us`` on
  synthetic events.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cleora_tpu as ct
import cleora_tpu_torch as ctt
from cleora_tpu_torch import kernels, tracing
from cleora_tpu_torch.convert import from_jax_state
from cleora_tpu_torch.ops.attention import (
    attention_spmm,
    attention_spmm_plain,
)
from cleora_tpu_torch.ops.normalize import normalize_plain
from cleora_tpu_torch.ops.spmm import CsrMatrix, spmm, spmm_plain
from torch_test_support import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
D = 16
TOL = {"rtol": 1e-5, "atol": 1e-6}


@pytest.fixture(scope="module")
def graphs():
    """The entity set both packages initialise from (the propagated CSR
    is :func:`markov_rows`'s, patched into both)."""
    rng = np.random.default_rng(23)
    ref = ct.SparseMatrix.from_edge_arrays(rng.integers(0, 300, 900),
                                           rng.integers(0, 300, 900))
    return ref, from_jax_state(ref.__getstate__())


def markov_rows(n: int, seed: int, hub: int = 260):
    """A row-sorted CSR: left-Markov values (1/degree), every ninth row
    empty, row 2 a hub of ``hub`` entries, row 3 with every value 0 and
    about a tenth of the other values 0."""
    rng = np.random.default_rng(seed)
    deg = rng.poisson(5, size=n)
    deg[::9] = 0
    deg[2] = hub
    deg[3] = max(deg[3], 4)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=indptr[1:])
    cols = rng.integers(0, n, size=int(indptr[-1])).astype(np.int32)
    vals = (1.0 / np.maximum(deg, 1))[np.repeat(np.arange(n), deg)]
    vals = vals.astype(np.float32)
    vals[rng.random(vals.shape[0]) < 0.1] = 0.0
    vals[indptr[3]:indptr[4]] = 0.0
    return indptr, cols, vals


def _patched(monkeypatch, graphs, seed: int):
    ref, ours = graphs
    n = ref.num_entities
    indptr, cols, vals = markov_rows(n, seed)
    rows = np.repeat(np.arange(n, dtype=np.int32), np.diff(indptr))
    coo = (jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals))
    monkeypatch.setattr(ref, "_device_coo", lambda *a, **k: coo)
    monkeypatch.setattr(ours, "_device_csr", lambda *a, **k:
                        CsrMatrix.from_numpy(indptr, cols, vals, CPU))
    return ref, ours, (indptr, cols, vals)


@pytest.mark.parametrize("iterations", [1, 2])
@pytest.mark.parametrize("normalization", ["l2", "l1"])
@pytest.mark.parametrize("w", [0.0, 0.3])
def test_fused_loop_step_matches_jax(monkeypatch, graphs, iterations,
                                     normalization, w):
    ref, ours, _ = _patched(monkeypatch, graphs, seed=iterations)
    kw = dict(feature_dim=D, num_iterations=iterations,
              normalization=normalization, residual_weight=w, whiten=False)
    got = ctt.embed(ours, device="cpu", **kw)
    np.testing.assert_allclose(got, ct.embed(ref, **kw), **TOL)


@pytest.mark.parametrize("temperature", [0.7, 1.0])
@pytest.mark.parametrize("normalization", ["l2", "l1"])
def test_fused_attention_step_matches_jax(monkeypatch, graphs, temperature,
                                          normalization):
    ref, ours, (indptr, _, _) = _patched(monkeypatch, graphs, seed=7)
    kw = dict(feature_dim=D, num_iterations=3, normalization=normalization,
              attention_temperature=temperature, whiten=False)
    got = ctt.embed_with_attention(ours, device="cpu", **kw)
    np.testing.assert_allclose(got, ct.embed_with_attention(ref, **kw), **TOL)
    assert np.all(got[3] == 0.0)  # every value 0: no valid edge
    assert np.all(got[0] == 0.0)  # empty


def test_fused_entry_points_take_the_plain_versions_on_cpu():
    indptr, cols, vals = markov_rows(200, 3)
    csr = CsrMatrix.from_numpy(indptr, cols, vals, CPU)
    x = torch.from_numpy(
        np.random.default_rng(3).standard_normal((200, D)).astype(np.float32))
    kernels.reset_launches()
    for norm in ("none", "l2", "l1"):
        assert torch.equal(spmm(csr, x, 0.3, normalization=norm),
                           normalize_plain(spmm_plain(csr, x, 0.3), norm))
        assert torch.equal(attention_spmm(csr, x, 0.7, norm),
                           attention_spmm_plain(csr, x, 0.7, norm))
    assert kernels.LAUNCHES == dict.fromkeys(kernels.COUNTERS, 0)
    with pytest.raises(ValueError, match="unknown normalization"):
        spmm(csr, x, normalization="spectral")
    with pytest.raises(ValueError, match="CUDA"):
        kernels.attention_spmm(csr.indptr, csr.indices, csr.vals, x, 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.spmm_csr(csr.indptr, csr.indices, csr.vals, x,
                         normalization="l2")


# ------------------------------------------------------------ hub slices


def _slice_entries(plan, w: int, end: int) -> list:
    """The entries slice ``w`` of ``plan`` walks, in order: its chunks of
    32 from item_starts[w], every item_cuts[w]-th chunk."""
    start = int(plan.item_starts[w])
    stride = 32 * int(plan.item_cuts[w])
    out = []
    for cs in range(start, end, stride):
        out.extend(range(cs, min(cs + 32, end)))
    return out


def _indptr(lengths) -> torch.Tensor:
    return torch.from_numpy(np.concatenate([[0], np.cumsum(lengths)])
                            .astype(np.int64))


def test_hub_plan_covers_each_entry_once_in_chunk_order():
    lengths = [0, 5, 4096, 4097, 3, 10_000, 8192, 8193, 40_000]
    indptr = _indptr(lengths)
    plan = kernels.hub_plan(indptr)
    hubs = [r for r, n in enumerate(lengths) if n > kernels.LONG_SLICE]
    assert plan.item_rows.tolist() == [
        r for r in hubs for _ in range(-(-lengths[r] // kernels.LONG_SLICE))]
    assert [int(plan.item_rows[s]) for s in plan.split.tolist()] == hubs
    for r in hubs:
        ws = [w for w in range(plan.item_rows.shape[0])
              if int(plan.item_rows[w]) == r]
        k = len(ws)
        assert k == -(-lengths[r] // kernels.LONG_SLICE)
        assert all(int(plan.item_cuts[w]) == k for w in ws)
        lo, hi = int(indptr[r]), int(indptr[r + 1])
        seen = []
        for j, w in enumerate(ws):
            entries = _slice_entries(plan, w, hi)
            # slice j takes the row's chunks j, j + K, j + 2K, ...
            assert {(e - lo) // 32 % k for e in entries} == {j}
            seen.extend(entries)
        assert sorted(seen) == list(range(lo, hi))


def test_hub_plan_of_a_shard_is_the_whole_plan_on_its_rows():
    rng = np.random.default_rng(5)
    lengths = rng.integers(0, 40, size=60)
    lengths[[4, 17, 18, 41, 59]] = [5000, 4097, 12_000, 4096, 9000]
    whole = kernels.hub_plan(_indptr(lengths))
    for lo, hi in ((0, 20), (17, 42), (40, 60)):
        indptr = _indptr(lengths[lo:hi])
        part = kernels.hub_plan(indptr)
        keep = (whole.item_rows >= lo) & (whole.item_rows < hi)
        base = int(_indptr(lengths)[lo])
        assert torch.equal(part.item_rows, whole.item_rows[keep] - lo)
        assert torch.equal(part.item_cuts, whole.item_cuts[keep])
        assert torch.equal(part.item_starts, whole.item_starts[keep] - base)


def _hub_csr(monkeypatch, seed: int):
    """markov_rows with hubs of 260 and 130 entries, LONG_SLICE 64, so
    both are cut (5 and 3 slices) at a CPU test's size."""
    monkeypatch.setattr(kernels, "LONG_SLICE", 64)
    indptr, cols, vals = markov_rows(400, seed)
    deg = np.diff(indptr)
    deg[7] = 130
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    rng = np.random.default_rng(seed + 1)
    cols = rng.integers(0, 400, size=int(indptr[-1])).astype(np.int32)
    vals = (1.0 / np.maximum(deg, 1))[np.repeat(np.arange(400), deg)]
    vals = vals.astype(np.float32)
    vals[rng.random(vals.shape[0]) < 0.1] = 0.0
    vals[indptr[3]:indptr[4]] = 0.0
    csr = CsrMatrix.from_numpy(indptr, cols, vals, CPU)
    assert csr.hub_plan().split.shape[0] == 2
    return csr


@pytest.mark.parametrize("norm", ["none", "l2", "l1"])
def test_k1_slice_and_join_equals_spmm_plain(monkeypatch, norm):
    """K1's order: a row's entries in order; a hub's slices each in their
    chunk order, added in slice order; then the residual and the
    normalisation."""
    csr = _hub_csr(monkeypatch, 11)
    plan = csr.hub_plan()
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        (400, D)).astype(np.float32))
    w = 0.3
    indptr, cols, vals = csr.indptr.tolist(), csr.indices, csr.vals
    hub_rows = set(plan.item_rows.tolist())
    out = torch.zeros((400, D))
    for r in range(400):
        if r in hub_rows:
            acc = torch.zeros(D)
            for s in range(plan.item_rows.shape[0]):
                if int(plan.item_rows[s]) == r:
                    part = torch.zeros(D)
                    for e in _slice_entries(plan, s, indptr[r + 1]):
                        part += vals[e] * x[cols[e]]
                    acc += part
        else:
            acc = torch.zeros(D)
            for e in range(indptr[r], indptr[r + 1]):
                acc += vals[e] * x[cols[e]]
        out[r] = (1.0 - w) * acc + w * x[r]
    torch.testing.assert_close(
        normalize_plain(out, norm),
        normalize_plain(spmm_plain(csr, x, w), norm), **TOL)


RESCALE = np.float32(8.0)  # kRescale of kernels/edge_attention.cu
BATCH = 4  # the kernel's batch at D = 16: a team of 4 lanes, 4 entries


def _online_state(xn_r, x, cols, vals, entries, temperature):
    """The fused pass's per-row (or per-slice) state over ``entries`` in
    order, in float32, as the kernel walks them at D = 16: batches of
    BATCH consecutive entries (aligned with the chunks of 32); a batch's
    scores first, the reference m moved to the batch's largest score (and
    the state rescaled) when that exceeds m by more than RESCALE, then
    (P, PV, acc) in entry order."""
    f32 = np.float32
    m, sp, spv = f32(-np.inf), f32(0), f32(0)
    acc = np.zeros(x.shape[1], dtype=f32)
    entries = list(entries)
    for b in range(0, len(entries), BATCH):
        batch = [e for e in entries[b:b + BATCH] if vals[e] != 0]
        scores = []
        for e in batch:
            xc = x[cols[e]]
            scores.append(f32(f32(np.dot(xn_r, xc))
                              / max(f32(np.sqrt(np.dot(xc, xc))), f32(1e-10))
                              / f32(temperature)))
        if not batch:
            continue
        mb = max(scores)
        if mb > m + RESCALE:
            f = np.exp(f32(m - mb)) if np.isfinite(m) else f32(0)
            sp, spv, acc = sp * f, spv * f, acc * f
            m = mb
        for e, s in zip(batch, scores):
            p = np.exp(f32(s - m))
            sp, spv = sp + p, spv + p * vals[e]
            acc = acc + (p * vals[e]) * x[cols[e]]
    return m, sp, spv, acc


def _merge(states):
    """attention_join: the slices' states merged in slice order."""
    f32 = np.float32
    m, sp, spv = f32(-np.inf), f32(0), f32(0)
    acc = np.zeros_like(states[0][3])
    for mj, spj, spvj, accj in states:
        if mj == -np.inf:
            continue
        if mj > m:
            f = np.exp(f32(m - mj)) if np.isfinite(m) else f32(0)
            sp, spv, acc = sp * f, spv * f, acc * f
            m = mj
        f = np.exp(f32(mj - m))
        sp, spv, acc = sp + spj * f, spv + spvj * f, acc + accj * f
    return m, sp, spv, acc


def _epilogue(sp, spv, acc):
    dp = max(sp, np.float32(1e-10))
    da = max(np.float32(spv / dp), np.float32(1e-10))
    return acc / dp / da


@pytest.mark.parametrize("temperature", [0.7, 1.0])
def test_online_attention_merge_matches_jax(monkeypatch, graphs,
                                            temperature):
    """The fused pass's algebra (online softmax, hub slices merged in
    order, the clamps) on JAX's own state, against JAX's attention step."""
    ref, _ = graphs
    n = ref.num_entities
    monkeypatch.setattr(kernels, "LONG_SLICE", 64)
    indptr, cols, vals = markov_rows(n, 13)
    assert np.diff(indptr)[2] > kernels.LONG_SLICE
    rows = np.repeat(np.arange(n, dtype=np.int32), np.diff(indptr))
    coo = (jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals))
    monkeypatch.setattr(ref, "_device_coo", lambda *a, **k: coo)
    states = {}
    ct.embed_with_attention(
        ref, feature_dim=D, num_iterations=2, attention_temperature=temperature,
        whiten=False, normalization="l2",
        callback=lambda i, x: states.__setitem__(i, np.asarray(x)))
    x, want = states[0].astype(np.float32), states[1]
    plan = kernels.hub_plan(torch.from_numpy(indptr))
    got = np.zeros_like(x)
    for r in range(n):
        xr = x[r]
        xn_r = xr / max(np.float32(np.sqrt(np.dot(xr, xr))), np.float32(1e-10))
        lo, hi = int(indptr[r]), int(indptr[r + 1])
        if hi - lo > kernels.LONG_SLICE:
            slices = [s for s in range(plan.item_rows.shape[0])
                      if int(plan.item_rows[s]) == r]
            m, sp, spv, acc = _merge([
                _online_state(xn_r, x, cols, vals,
                              _slice_entries(plan, s, hi), temperature)
                for s in slices])
        else:
            m, sp, spv, acc = _online_state(xn_r, x, cols, vals,
                                            range(lo, hi), temperature)
        y = _epilogue(sp, spv, acc)
        got[r] = y / max(np.float32(np.linalg.norm(y)), np.float32(1e-10))
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[3] == 0.0) and np.all(got[0] == 0.0)


# ------------------------------------------------------------ tracing


def test_trace_writer_names_the_port_kernels():
    """The profiler's record of a launch is kept and tagged with it; a
    launch the profiler lost is written from its event pair, placed by
    the clock marker (or, without one, the anchor span)."""
    k1_name = ("void (anonymous namespace)::spmm_csr_rows<float, true, 2>"
               "(long const*, int const*)")
    events = [
        {"ph": "X", "cat": "user_annotation", "name": tracing.DEVICE_CLOCK_SPAN,
         "pid": 1, "tid": 1, "ts": 1000.0, "dur": 2.0},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 1510.0,
         "dur": 280.0, "name": k1_name},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 1900.0,
         "dur": 100.0, "name": "void at::native::vectorized_elementwise_"
                              "kernel<4>(int)"},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "ts": 2950.0,
         "dur": 50.0, "name": "spin_kernel(long)"},
    ]
    functions = tracing.port_kernel_functions()
    assert {"spmm_csr_rows", "spmm_csr_join", "attention_rows",
            "attention_join", "edge_attention_kernel",
            "row_normalize_team"} <= set(functions)
    assert functions["attention_rows"] == "edge_attention"
    # the anchor is 2.0 ms before the marker's end (3000 µs): ts 1000
    launches = [("spmm_csr", "spmm_csr", 0.5, 0.3),
                ("attention_spmm", "edge_attention", 1.2, 0.05)]
    out = tracing.add_port_kernels(events, launches, device=0, marker_ms=2.0)
    kernels_out = tracing.kernel_events(out)
    assert [e["name"] for e in kernels_out] == [
        k1_name, "void at::native::vectorized_elementwise_kernel<4>(int)",
        "attention_spmm"]
    k1, att = kernels_out[0], kernels_out[2]
    assert k1["pid"] == 0 and k1["ts"] == 1510.0 and k1["dur"] == 280.0
    assert k1["args"]["launch"] == "spmm_csr"
    # K1's pair spans [1500, 1800]: it starts 10 µs before the kernel and
    # adds 20 µs to its 280
    assert tracing.pair_offsets(out) == pytest.approx(
        {"launches": 1, "start_us": 10.0, "extra_us": 20.0})
    assert att["pid"] == tracing.PORT_KERNELS_PID
    assert att["ts"] == pytest.approx(2200.0)
    assert att["dur"] == pytest.approx(50.0)
    assert tracing.port_launches(out) == [("spmm_csr", "profiler"),
                                          ("attention_spmm", "events")]
    assert any(e.get("ph") == "M" and e.get("pid") == tracing.PORT_KERNELS_PID
               for e in out)
    # 280 µs of K1, 100 µs of the ATen kernel (after it), 50 µs of the
    # pass; the marker is dropped
    assert tracing.busy_us(out) == pytest.approx(430.0)
    overlapping = out + [{"ph": "X", "cat": "kernel", "name": "other",
                          "pid": 0, "tid": 9, "ts": 1600.0, "dur": 50.0}]
    assert tracing.busy_us(overlapping) == pytest.approx(430.0)
    # no marker: the anchor is the end of the span (1002 µs)
    out = tracing.add_port_kernels(events[:3], launches, device=0)
    assert tracing.port_launches(out) == [("spmm_csr", "profiler"),
                                          ("attention_spmm", "events")]
    assert tracing.kernel_events(out)[2]["ts"] == pytest.approx(2202.0)
    # a launch of another library does not claim K1's record
    out = tracing.add_port_kernels(
        events, [("hash_init", "hash_init", 0.5, 0.3)], marker_ms=2.0)
    assert "launch" not in tracing.kernel_events(out)[0].get("args", {})
    assert tracing.port_launches(out) == [("hash_init", "events")]


def test_launch_recording_is_scoped():
    with kernels.recording() as outer:
        with kernels.recording() as inner:
            assert kernels._RECORDING == [outer, inner]
        assert kernels._RECORDING == [outer]
    assert kernels._RECORDING == [] and outer.launches == []
    calls = []
    launch = kernels._recorded("spmm_csr", "probe",
                               lambda *a: calls.append(a) or 0)
    assert launch(1, 2, 0) == 0 and calls == [(1, 2, 0)]
