"""Tracing, profiling and progress logs (the port of cleora_tpu/tracing.py).

* ``EmbedTracer`` — per-iteration wall-clock and edges/s counters, usable
  as the ``callback=`` of :func:`cleora_tpu_torch.embed`;
* ``trace`` — a ``torch.profiler`` scope over the CPU and, with a card,
  CUDA activities that writes a Chrome trace into a directory (the JAX
  package's ``jax.profiler`` trace directory);
* ``annotate`` — a named span in that trace (``record_function``) and, on
  a card, an NVTX range;
* ``device_memory_stats`` — live memory of each CUDA device (the device
  side of the host tracemalloc numbers);
* ``log_every`` — rate-limited progress logging for host ingest loops.
"""

from __future__ import annotations

import contextlib
import logging
import os
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


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block into ``log_dir/trace.json`` (open it in
    chrome://tracing or Perfetto): CPU ops, and with a card every kernel
    launch, the port's own kernels among them."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


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
