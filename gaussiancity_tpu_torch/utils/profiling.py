# -*- coding: utf-8 -*-
"""The port's tracer (counterpart of ``gaussiancity_tpu/utils/profiling.py``,
on ``torch.profiler`` in place of ``jax.profiler``).

``span(name)`` marks a block of the program as ``gct/<name>`` in a
``torch.profiler`` trace.  Kineto stamps the span on the clock of the
device's CUPTI activity, so spans, torch ops, CUDA runtime calls and
kernels share one timeline, and a span nested in another is its child.
With no profiler running a span is one shared no-op context: the cost is
one read of the profiler's module flag.  Spans are kept by the profiler
and written out by ``trace()``'s Chrome trace.

The names, from the unit down (``PERF.md`` lists what reads each):

- units: ``train_step#<step>``, ``frame#<pose id>``, ``frame.readback``,
  ``prepare``; every span of one step or frame lies inside its unit;
- stages (``Stages``): the trainer's and the pipeline's ``stage_ms`` keys;
- layers: ``encoder``, ``hash_grid``, ``ptv3``, ``ptv3.enc<k>`` /
  ``ptv3.dec<k>``, ``attr_mlp``, ``raster.preprocess`` / ``.binning`` /
  ``.blend``, ``disc``, ``vgg``, ``adam_d``, ``adam_g``;
- readbacks: ``sync.<what>`` around each explicit wait of the host on the
  device (``sync.stage`` is the stage timer's own).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Dict, Iterator, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

PREFIX = "gct/"
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator["torch.profiler.profile"]:
    """Profile the block (CPU, and CUDA when a card is present) and write
    a Chrome trace, ``trace.json`` under ``log_dir`` (default
    ``$GCT_TRACE_DIR``, else ``gct_trace`` in the temporary directory),
    viewable in Perfetto or chrome://tracing, with the program's spans.
    Yields the profiler, whose ``key_averages()`` stays readable after
    the block."""
    log_dir = log_dir or os.environ.get(
        "GCT_TRACE_DIR", os.path.join(tempfile.gettempdir(), "gct_trace"))
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def span(name: str):
    """A ``gct/<name>`` range in the running profiler's trace; a shared
    no-op context when no profiler runs."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(PREFIX + name)


def step_annotation(name: str, step):
    """The unit span ``gct/<name>#<step>`` around one step or frame."""
    return span(f"{name}#{step}")


class Stages:
    """The stage spans of one owner (a trainer, a pipeline) and, while
    ``timed``, its stage times: each stage ends at a synchronise of the
    device (in a ``sync.stage`` span) and appends its wall ms to
    ``ms[name]``.  A stage starts where the owner's previous stage ended;
    after ``restart`` (where work outside any stage may be queued, as at a
    unit's start) the next one starts at a synchronise of its own."""

    def __init__(self, device, timed: bool = False):
        self.device = torch.device(device)
        self.timed = timed
        self.ms: Dict[str, List[float]] = {}
        self._end: Optional[float] = None

    def restart(self) -> None:
        self._end = None

    def __call__(self, name: str):
        """The context of stage ``name``: its span, timed while
        ``timed``."""
        if not self.timed:
            return span(name)
        return _TimedStage(self, name)

    def _mark(self) -> float:
        if self.device.type == "cuda":
            with span("sync.stage"):
                torch.cuda.synchronize(self.device)
        return time.perf_counter()


class _TimedStage:
    __slots__ = ("owner", "name", "span", "t0")

    def __init__(self, owner: Stages, name: str):
        self.owner, self.name = owner, name

    def __enter__(self):
        self.span = span(self.name)
        self.span.__enter__()
        owner = self.owner
        self.t0 = owner._end if owner._end is not None else owner._mark()
        return self

    def __exit__(self, exc_type, exc, tb):
        owner = self.owner
        owner._end = None
        if exc_type is None:
            owner._end = owner._mark()
            owner.ms.setdefault(self.name, []).append(
                (owner._end - self.t0) * 1e3)
        return self.span.__exit__(exc_type, exc, tb)
