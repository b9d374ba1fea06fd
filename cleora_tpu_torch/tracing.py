"""Tracing, profiling and progress logs (the port of cleora_tpu/tracing.py).

* ``EmbedTracer`` — per-iteration wall-clock and edges/s counters, usable
  as the ``callback=`` of :func:`cleora_tpu_torch.embed`;
* ``trace`` — a ``torch.profiler`` scope over the CPU and, with a card,
  CUDA activities that writes a Chrome trace into a directory (the JAX
  package's ``jax.profiler`` trace directory); a launch of the port's own
  kernels that the profiler's CUDA activity records lost (they can, in a
  long-lived process) is written into it from the CUDA event pair around
  it (``kernels.recording``);
* ``kernel_events``/``busy_us``/``port_launches``/``pair_offsets`` — the
  device kernels of such a trace, the time the device spent in at least
  one of them, the port's launches with where each record came from, and
  how far the event pairs stand from the profiler's records;
* ``annotate`` — a named span in that trace (``record_function``) and, on
  a card, an NVTX range;
* ``device_memory_stats`` — live memory of each CUDA device (the device
  side of the host tracemalloc numbers);
* ``log_every`` — rate-limited progress logging for host ingest loops.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import logging
import os
import re
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

logger = logging.getLogger("cleora_tpu_torch")


@dataclass
class EmbedTracer:
    """Collects per-iteration timing; pass ``tracer`` as embed()'s callback.

    >>> tracer = EmbedTracer(num_edges=graph.num_edges)
    >>> embed(graph, callback=tracer)
    >>> tracer.summary()["edges_per_s"]
    """

    num_edges: int = 0
    iter_times: List[float] = field(default_factory=list)
    _last: Optional[float] = None

    def __post_init__(self):
        # count the first iteration from construction (its interval thus
        # includes embed()'s setup and dispatch — the conservative side)
        self._last = time.perf_counter()

    def __call__(self, iteration: int, embeddings) -> None:
        now = time.perf_counter()
        self.iter_times.append(now - self._last)
        self._last = now

    def summary(self) -> Dict[str, float]:
        if not self.iter_times:
            return {"iterations": 0, "total_s": 0.0, "mean_iter_s": 0.0,
                    "edges_per_s": 0.0}
        total = sum(self.iter_times)
        mean = total / len(self.iter_times)
        return {
            "iterations": len(self.iter_times),
            "total_s": total,
            "mean_iter_s": mean,
            "edges_per_s": self.num_edges / mean if mean > 0 else 0.0,
        }


# the span around the CUDA event that anchors the port's kernels in time
# when the trace holds no clock marker
DEVICE_CLOCK_SPAN = "cleora_tpu_torch.device_clock"
# the trace process that holds the launches the profiler lost (a pid no
# host process has)
PORT_KERNELS_PID = 1 << 30
# the clock marker: torch.cuda._sleep's kernel, launched at the end of a
# trace with a CUDA event queued behind it (about 50 µs on an H100)
MARKER_KERNEL = "spin_kernel"
_MARKER_CYCLES = 100_000
_KERNEL_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "kernels")
_GLOBAL_FN = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)")


def port_kernel_functions() -> Dict[str, str]:
    """The ``__global__`` functions of the port's kernel sources, each
    with its library (the name of its source)."""
    names = {}
    for fname in sorted(os.listdir(_KERNEL_DIR)):
        if fname.endswith(".cu"):
            with open(os.path.join(_KERNEL_DIR, fname)) as f:
                for fn in _GLOBAL_FN.findall(f.read()):
                    names[fn] = fname[:-3]
    return names


# a profiler kernel name of a function in the top-level namespace (the
# port's kernels live in each source's anonymous namespace), such as
# ``void (anonymous namespace)::spmm_csr_rows<float, true, 2>(...)``
_PROFILED_NAME = re.compile(
    r"^(?:void\s+)?(?:\(anonymous namespace\)::)?(\w+)(?:<|\(|$)")


def _port_library(name: str, functions: Dict[str, str]) -> Optional[str]:
    """The library of a profiler kernel name, None for a kernel not the
    port's."""
    m = _PROFILED_NAME.match(name)
    return None if m is None else functions.get(m.group(1))


def add_port_kernels(events: List[Dict], launches: List[tuple],
                     device: int = 0,
                     marker_ms: Optional[float] = None) -> List[Dict]:
    """``events`` (a Chrome trace's) with each launch of the port's
    kernels accounted for once.  ``launches`` holds ``(entry, library,
    offset_ms, dur_ms)`` in launch order: the CUDA event pair around the
    launch, ``offset_ms`` after the anchor event.

    The anchor sits ``marker_ms`` before the end of the clock marker's
    kernel (:data:`MARKER_KERNEL`, its last record) or, without one, at
    the end of the :data:`DEVICE_CLOCK_SPAN` span.  A profiler record of
    one of the port's kernels whose midpoint falls inside a launch's
    event interval, of the same library, is that launch's: it is kept,
    tagged with ``args["launch"]`` (the entry), ``args["launch_index"]``
    and the pair's interval (``pair_ts``, ``pair_dur``).  A launch with no such record (the profiler
    lost it) is added as a device event under its entry's name on the
    trace process :data:`PORT_KERNELS_PID`; its interval is the event
    pair's, which includes the host's launch delay when the device queue
    was empty.  The marker's record is dropped.  Returns the new list."""
    marker = [e for e in events if e.get("cat") == "kernel"
              and e.get("name", "").startswith(MARKER_KERNEL)]
    used = None
    if marker and marker_ms is not None:
        used = max(marker, key=lambda e: float(e["ts"]))
        t0 = (float(used["ts"]) + float(used.get("dur", 0.0))
              - marker_ms * 1e3)
    else:
        anchor = next(e for e in events if e.get("name") == DEVICE_CLOCK_SPAN
                      and e.get("ph") == "X")
        t0 = float(anchor["ts"]) + float(anchor.get("dur", 0.0))
    windows: Dict[str, List[tuple]] = {}
    for i, (entry, library, offset_ms, dur_ms) in enumerate(launches):
        start = t0 + offset_ms * 1e3
        windows.setdefault(library, []).append(
            (start, start + dur_ms * 1e3, i))
    for ws in windows.values():  # one stream's launches do not overlap
        ws.sort()
    starts = {lib: [w[0] for w in ws] for lib, ws in windows.items()}
    functions = port_kernel_functions()
    found = set()
    kept = []
    for e in events:
        if e.get("cat") != "kernel":
            kept.append(e)
            continue
        if e is used:
            continue
        library = _port_library(e.get("name", ""), functions)
        if library in windows:
            mid = float(e["ts"]) + float(e.get("dur", 0.0)) / 2
            j = bisect.bisect_right(starts[library], mid) - 1
            if j >= 0 and mid <= windows[library][j][1]:
                start, end, i = windows[library][j]
                found.add(i)
                e = dict(e, args=dict(e.get("args", {}),
                                      launch=launches[i][0], launch_index=i,
                                      pair_ts=start, pair_dur=end - start))
        kept.append(e)
    lost = [i for i in range(len(launches)) if i not in found]
    if lost:
        kept.append({"ph": "M", "name": "process_name",
                     "pid": PORT_KERNELS_PID,
                     "args": {"name": f"cleora_tpu_torch kernels (cuda:"
                                      f"{device}, CUDA event pairs)"}})
    for i in lost:
        entry, _, offset_ms, dur_ms = launches[i]
        kept.append({"ph": "X", "cat": "kernel", "name": entry,
                     "pid": PORT_KERNELS_PID, "tid": 0,
                     "ts": t0 + offset_ms * 1e3, "dur": dur_ms * 1e3,
                     "args": {"device": device, "launch": entry,
                              "launch_index": i,
                              "timing": "CUDA events around the launch"}})
    return kept


def port_launches(events: List[Dict]) -> List[tuple]:
    """The port's kernel launches in a :func:`trace`'s events, in launch
    order: ``(entry, source)``, where source is ``"profiler"`` for a
    launch the profiler recorded and ``"events"`` for one written from
    its CUDA event pair."""
    seen = {}
    for e in kernel_events(events):
        args = e.get("args", {})
        if "launch_index" in args:
            source = ("events" if e.get("pid") == PORT_KERNELS_PID
                      else "profiler")
            seen[args["launch_index"]] = (args["launch"], source)
    return [seen[i] for i in sorted(seen)]


def pair_offsets(events: List[Dict]) -> Dict[str, float]:
    """How the CUDA event pairs place the port's launches that the
    profiler also recorded: the median microseconds from a pair's start
    to its launch's first kernel (the anchor's offset and the host's
    launch delay), and from that kernel's start to the pair's end less
    the launch's kernel time (what a pair adds to it); empty when no
    launch has both."""
    first, kernel_us, pair = {}, {}, {}
    for e in kernel_events(events):
        args = e.get("args", {})
        if "pair_ts" not in args:
            continue
        i = args["launch_index"]
        first[i] = min(first.get(i, float("inf")), float(e["ts"]))
        kernel_us[i] = kernel_us.get(i, 0.0) + float(e.get("dur", 0.0))
        pair[i] = (float(args["pair_ts"]), float(args["pair_dur"]))
    if not pair:
        return {}
    lead = sorted(first[i] - pair[i][0] for i in pair)
    extra = sorted(pair[i][1] - kernel_us[i] for i in pair)
    return {"launches": len(pair), "start_us": lead[len(lead) // 2],
            "extra_us": extra[len(extra) // 2]}


def kernel_events(events: List[Dict]) -> List[Dict]:
    """The device kernels of a Chrome trace's events."""
    return [e for e in events if e.get("cat") == "kernel"]


def busy_us(events: List[Dict]) -> float:
    """Microseconds in which at least one of the trace's kernels ran (the
    union of their intervals)."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                   for e in kernel_events(events))
    total, end = 0.0, float("-inf")
    for s, e in spans:
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block into ``log_dir/trace.json`` (open it in
    chrome://tracing or Perfetto): CPU ops, and with a card every kernel
    launch.  Each launch of the port's kernels also records a CUDA event
    pair; a launch that the profiler's records lack is written from its
    pair (:func:`add_port_kernels`), so the trace holds every launch."""
    from torch.profiler import ProfilerActivity, profile

    from . import kernels

    card = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if card:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    anchor = marker = None
    with kernels.recording() as log, profile(activities=activities) as prof:
        if card:
            torch.cuda.synchronize()  # the anchor runs as soon as queued
            with torch.profiler.record_function(DEVICE_CLOCK_SPAN):
                anchor = torch.cuda.Event(enable_timing=True)
                anchor.record()
        yield
        if card:
            torch.cuda.synchronize()
            if log.launches:  # the clock marker: the event ends the kernel
                torch.cuda._sleep(_MARKER_CYCLES)
                marker = torch.cuda.Event(enable_timing=True)
                marker.record()
                torch.cuda.synchronize()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    if anchor is not None and log.launches:
        launches = [(entry, library, anchor.elapsed_time(start),
                     start.elapsed_time(end))
                    for entry, library, start, end in log.launches]
        with open(path) as f:
            doc = json.load(f)
        doc["traceEvents"] = add_port_kernels(
            doc["traceEvents"], launches, torch.cuda.current_device(),
            anchor.elapsed_time(marker))
        with open(path, "w") as f:
            json.dump(doc, f)


@contextlib.contextmanager
def annotate(name: str):
    """Named span: a ``record_function`` range in :func:`trace`'s output
    and, with a card, an NVTX range."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def device_memory_stats() -> List[Dict]:
    """Live memory of each CUDA device in bytes (an empty list without a
    card): what PyTorch's allocator holds in tensors, its peak, and the
    card's total memory."""
    out = []
    for i in range(torch.cuda.device_count() if torch.cuda.is_available()
                   else 0):
        out.append({
            "device": f"cuda:{i} ({torch.cuda.get_device_name(i)})",
            "bytes_in_use": int(torch.cuda.memory_allocated(i)),
            "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(i)),
            "bytes_limit": int(torch.cuda.mem_get_info(i)[1]),
        })
    return out


class log_every:
    """Rate-limited progress logger for ingest loops.

    >>> progress = log_every(10_000, "read {count:,} lines")
    >>> for line in lines: progress()
    """

    def __init__(self, every: int, fmt: str = "processed {count:,} items"):
        self.every = every
        self.fmt = fmt
        self.count = 0
        self._next = every
        self._t0 = time.perf_counter()

    def __call__(self, n: int = 1):
        self.count += n
        # threshold, not modulo: chunked feeds (n > 1) must not skip a
        # milestone when a chunk jumps across it
        if self.count >= self._next:
            self._next += ((self.count - self._next) // self.every + 1) * self.every
            elapsed = time.perf_counter() - self._t0
            logger.info(
                self.fmt.format(count=self.count)
                + f" ({self.count / max(elapsed, 1e-9):,.0f}/s)"
            )
