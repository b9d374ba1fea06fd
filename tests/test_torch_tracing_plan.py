"""The port's tracing.py, plan.py, scaling.py and their CLI commands
against the JAX package's (cleora_tpu/tracing.py, plan.py, scaling.py,
cli.py) on the CPU.

* EmbedTracer's summaries and log_every's messages equal the JAX
  package's on the same clock readings and counts; trace() writes a Chrome
  trace that holds an annotate() span; without a card
  device_memory_stats() is empty.
* plan_report: the graph section and the walk counts (counting passes,
  worst-case pairs) equal the JAX package's; "fits" agrees with the
  port's check_device_fit under the same budget; a DiskGraph plans like
  its SparseMatrix; the walk-table mode is the runtime's
  algorithms._walk_table_mode for that budget.
* The CLI: plan as text and as ``--json -``; scaling's gate with measure
  replaced by canned numbers (FAIL exits 2, PASS and no --check exit 0),
  as tests/test_scaling_report.py checks the JAX package's; and one smoke
  run of the rank ladder on the CPU (gloo ranks 1 and 2).
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

import cleora_tpu as ct
import cleora_tpu.cli as jcli
import cleora_tpu.plan as jplan
import cleora_tpu.tracing as jtracing

import cleora_tpu_torch as ctt
import cleora_tpu_torch.cli as tcli
import cleora_tpu_torch.plan as tplan
import cleora_tpu_torch.scaling as tscaling
import cleora_tpu_torch.tracing as ttracing
from cleora_tpu_torch import algorithms as talg
from cleora_tpu_torch.graph.stream import build_graph_streaming
from cleora_tpu_torch.ops import memory
from torch_test_support import one_torch_thread  # noqa: F401

GIB = 1 << 30


@pytest.fixture(scope="module")
def graphs():
    """tests/test_plan.py's graph (5,000 nodes, 60,000 random edges) in
    both packages."""
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, 5000, 60000), rng.integers(0, 5000, 60000)
    return (ct.SparseMatrix.from_edge_arrays(src, dst),
            ctt.SparseMatrix.from_edge_arrays(src, dst))


class _Clock:
    """time.perf_counter stand-in: 0.0, then +step per reading."""

    def __init__(self, step):
        self.t, self.step = -step, step

    def __call__(self):
        self.t += self.step
        return self.t


# ------------------------------------------------------------- tracing.py
def test_embed_tracer_like_jax(monkeypatch):
    summaries = []
    for mod in (jtracing, ttracing):
        monkeypatch.setattr(mod.time, "perf_counter", _Clock(0.25))
        tracer = mod.EmbedTracer(num_edges=1000)
        assert tracer.summary()["iterations"] == 0
        for i in range(3):
            tracer(i, None)
        summaries.append(tracer.summary())
    assert summaries[0] == summaries[1]
    assert summaries[1] == {"iterations": 3, "total_s": 0.75,
                            "mean_iter_s": 0.25, "edges_per_s": 4000.0}


def test_embed_tracer_as_the_embed_callback(graphs):
    _, tg = graphs
    tracer = ttracing.EmbedTracer(num_edges=tg.num_edges)
    ctt.embed(tg, feature_dim=8, num_iterations=3, callback=tracer,
              device="cpu")
    s = tracer.summary()
    assert s["iterations"] == 3 and s["edges_per_s"] > 0


def test_log_every_messages_like_jax(monkeypatch, caplog):
    caplog.set_level(logging.INFO)
    said = []
    for mod in (jtracing, ttracing):
        monkeypatch.setattr(mod.time, "perf_counter", _Clock(0.5))
        progress = mod.log_every(10, "read {count:,} lines")
        caplog.clear()
        # 12 crosses 10; 38 crosses 20 and 30 at once; 40 meets 40
        for n in (3, 4, 5, 1, 25, 2):
            progress(n)
        said.append([r.getMessage() for r in caplog.records])
    assert said[0] == said[1]
    assert [m.split(" (")[0] for m in said[1]] == [
        "read 12 lines", "read 38 lines", "read 40 lines"]


def test_trace_writes_the_annotated_span(graphs, tmp_path):
    _, tg = graphs
    with ttracing.trace(str(tmp_path / "tr")):
        with ttracing.annotate("cleora_step_span"):
            ctt.embed(tg, feature_dim=8, num_iterations=1, device="cpu")
    path = tmp_path / "tr" / "trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any(e.get("name") == "cleora_step_span" for e in events)
    assert ttracing.device_memory_stats() == []  # no card here


# ---------------------------------------------------------------- plan.py
@pytest.mark.parametrize("kw", [
    dict(n_devices=8, walks=True),
    dict(n_devices=4, walks=True, hbm_gib=0.01),
    dict(n_devices=1, walks=True, hbm_gib=0.5, second_order=True,
         num_walks=3, walk_length=40, window_size=7),
], ids=["default", "tiny", "second_order"])
def test_plan_counts_like_jax(graphs, kw):
    jg, tg = graphs
    ours = tplan.plan_report(tg, feature_dim=256, **kw)
    ref = jplan.plan_report(jg, feature_dim=256, **kw)
    assert ours["graph"] == ref["graph"]
    for key in ("counting_passes", "worst_case_pairs"):
        assert ours["walks"][key] == ref["walks"][key], key
    assert [r["devices"] for r in ours["embed"]] == \
        [r["devices"] for r in ref["embed"]]
    assert ours["layout"] == {"choice": "CSR"}
    limit = int(kw.get("hbm_gib", 80) * GIB)
    try:
        mode = talg._walk_table_mode(
            "auto", 5000, tg.num_edges, None, kw.get("second_order", False),
            world=kw["n_devices"], limit=limit)
    except ValueError:
        mode = "host"
    assert ours["walks"]["table_mode"].startswith(mode)
    text = tplan.format_plan(ours)
    assert "SpMM layout: CSR" in text and "Walk pipeline" in text


def test_plan_fits_agrees_with_the_runtime_check(graphs, monkeypatch):
    """'fits' at P=1 is exactly: check_device_fit does not raise under the
    same budget (its live budget replaced by the planned one)."""
    _, tg = graphs
    need = memory.estimate_embed_bytes(5000, 256, tg.num_edges, "float32")
    for limit in (need - 1, need, need + 1, 16 * GIB, need // 3):
        rep = tplan.plan_report(tg, feature_dim=256, hbm_gib=limit / GIB)
        monkeypatch.setattr(memory, "device_memory_limit",
                            lambda device, limit=limit: limit)
        try:
            memory.check_device_fit(5000, 256, tg.num_edges, "float32",
                                    torch.device("cuda"))
            raised = False
        except ValueError:
            raised = True
        assert rep["embed"][0]["fits"] == (not raised), limit
        assert rep["embed"][0]["need_gib"] == round(need / GIB, 2)
    rep = tplan.plan_report(tg, feature_dim=256, hbm_gib=need / 3 / GIB,
                            n_devices=2)
    assert rep["embed_min_devices"] >= 4
    assert any("shard over" in r for r in rep["recommendations"])
    assert rep["hbm"]["source"] == "explicit"
    if not torch.cuda.is_available():  # else the live card's memory
        assert tplan.plan_report(tg)["hbm"] == {"per_device_gib": 80.0,
                                                "source": "default-h100"}


def test_plan_diskgraph_input(graphs, tmp_path):
    _, tg = graphs
    lines = [f"n{i} n{(i * 7 + 3) % 400}" for i in range(1200)]
    dg = build_graph_streaming(lines, "complex::reflexive::node",
                               str(tmp_path / "g"))
    sm = ctt.SparseMatrix.from_iterator(iter(lines),
                                        "complex::reflexive::node")
    a = tplan.plan_report(dg, walks=True)
    b = tplan.plan_report(sm, walks=True)
    assert a == b and a["graph"]["n"] == 1200


# ---------------------------------------------------------------- the CLI
@pytest.fixture(scope="module")
def edge_file(tmp_path_factory):
    rng = np.random.default_rng(9)
    path = tmp_path_factory.mktemp("plan_cli") / "edges.tsv"
    path.write_text("\n".join(f"n{rng.integers(0, 80)} n{rng.integers(0, 80)}"
                              for _ in range(400)) + "\n")
    return str(path)


def test_cli_plan_text(edge_file, capsys):
    tcli.main(["plan", "-i", edge_file, "--devices", "4", "--walks",
               "--hbm-gib", "80"])
    out = capsys.readouterr().out
    assert "SpMM layout: CSR" in out and "P=4" in out
    assert "[explicit]" in out and "walk tables: replicated" in out


def test_cli_plan_json_like_jax(edge_file, capsys):
    reports = []
    for main in (jcli.main, tcli.main):
        main(["plan", "-i", edge_file, "--walks", "--json", "-"])
        reports.append(json.loads(capsys.readouterr().out))
    ref, ours = reports
    assert ours["graph"] == ref["graph"]
    for key in ("counting_passes", "worst_case_pairs"):
        assert ours["walks"][key] == ref["walks"][key]


def _canned(monkeypatch, results):
    monkeypatch.setattr(tscaling, "measure",
                        lambda smoke=False, device=None: results)


def test_cli_scaling_gate_fails_below_target(monkeypatch, tmp_path, capsys):
    _canned(monkeypatch, [
        {"devices": 1, "edges_per_s": 100e6, "efficiency": 1.0},
        {"devices": 2, "edges_per_s": 125e6, "efficiency": 0.625},
    ])
    out = tmp_path / "fail.json"
    with pytest.raises(SystemExit) as exc:
        tcli.main(["scaling", "--check", "--json", str(out),
                   "--device", "cpu"])
    assert exc.value.code == 2
    report = json.loads(out.read_text())
    assert report["pass"] is False and report["backend"] == "cpu"
    assert report["target_efficiency"] == tscaling.TARGET_EFFICIENCY == 0.80
    assert "FAIL" in capsys.readouterr().out


def test_cli_scaling_gate_passes_at_target(monkeypatch, capsys):
    _canned(monkeypatch, [
        {"devices": 1, "edges_per_s": 100e6, "efficiency": 1.0},
        {"devices": 2, "edges_per_s": 168e6, "efficiency": 0.84},
    ])
    tcli.main(["scaling", "--check", "--device", "cpu"])  # exit code 0
    assert "PASS" in capsys.readouterr().out


def test_cli_scaling_without_check_exits_zero(monkeypatch):
    _canned(monkeypatch, [
        {"devices": 1, "edges_per_s": 1e6, "efficiency": 1.0},
        {"devices": 2, "edges_per_s": 1e6, "efficiency": 0.5},
    ])
    assert tscaling.run_report(device="cpu") == 0
    tcli.main(["scaling", "--device", "cpu"])


def test_scaling_smoke_ladder_on_the_cpu(tmp_path, capsys):
    """The real ladder: one gloo rank, then two, each its own processes."""
    out = tmp_path / "scaling.json"
    rc = tscaling.run_report(smoke=True, check=0.0, json_path=str(out),
                             device="cpu")
    assert rc == 0
    report = json.loads(out.read_text())
    assert report["smoke"] is True and report["pass"] is True
    assert [r["devices"] for r in report["results"]] == [1, 2]
    assert all(r["edges_per_s"] > 0 for r in report["results"])
    assert report["results"][0]["efficiency"] == 1.0
    assert "PASS" in capsys.readouterr().out
    if not torch.cuda.is_available():  # the ladder never falls back
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tscaling.available_ranks(None)
