# -*- coding: utf-8 -*-
"""Profiling hooks (counterpart of ``gaussiancity_tpu/utils/profiling.py``,
on ``torch.profiler`` in place of ``jax.profiler``)."""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator["torch.profiler.profile"]:
    """Profile the block (CPU, and CUDA when a card is present) and write
    a Chrome trace, ``trace.json`` under ``log_dir`` (default
    ``$GCT_TRACE_DIR``, else ``gct_trace`` in the temporary directory),
    viewable in Perfetto or chrome://tracing.  Yields the profiler, whose
    ``key_averages()`` stays readable after the block."""
    log_dir = log_dir or os.environ.get(
        "GCT_TRACE_DIR", os.path.join(tempfile.gettempdir(), "gct_trace"))
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def step_annotation(name: str, step: int) -> Iterator[None]:
    """A ``name#step`` range in the trace around one step."""
    with torch.profiler.record_function(f"{name}#{step}"):
        yield


class Timer:
    """Lightweight wall-clock section timer with named accumulators."""

    def __init__(self):
        self.totals = {}
        self.counts = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self):
        return {
            k: {"total_s": v, "count": self.counts[k],
                "mean_ms": v / self.counts[k] * 1e3}
            for k, v in self.totals.items()
        }
