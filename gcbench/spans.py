"""The program's spans in the profiled pass and what the span readers
count under them.

The port marks its steps and frames as ``gct/...`` ranges
(``gaussiancity_tpu_torch/utils/profiling.py``): a unit span around each
train step or frame (and the frame's readback), with stage, layer and
``gct/sync.*`` spans nested inside.  Kineto stamps them on the clock of
the CUDA runtime calls and the device's activity.  A host event counts
when its interval lies inside a top-level ``gct/`` span, on any thread:
that leaves out the harness's closing synchronise.  Every reader divides
by the profiled steps or frames and returns None where the profile holds
no ``gct/`` span (a program without them)."""

from __future__ import annotations

import bisect
import json
import sys
from typing import Dict, List, Optional, Sequence, Tuple

PREFIX = "gct/"
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")
# kernel launches through the CUDA runtime (cudaLaunchKernel,
# cudaLaunchKernelExC, cudaLaunchCooperativeKernel, ...) and through its
# lower-level API (cuLaunchKernel, ...)
LAUNCHES = ("cudaLaunch", "cuLaunch")

Event = Tuple[str, int, int]


def gct(profile) -> List[Event]:
    return [ev for ev in profile.host if ev[0].startswith(PREFIX)]


def units(profile) -> List[Tuple[int, int]]:
    """The top-level ``gct/`` spans, (start, end), sorted."""
    out: List[Tuple[int, int]] = []
    for _, s, e in sorted(gct(profile), key=lambda ev: (ev[1], -ev[2])):
        if out and s < out[-1][1]:
            continue
        out.append((s, e))
    return out


def inside(events: Sequence[Event], spans: Sequence[Tuple[int, int]]
           ) -> List[Event]:
    """The events whose interval lies inside one of ``spans`` (sorted,
    disjoint)."""
    starts = [s for s, _ in spans]
    out = []
    for ev in events:
        i = bisect.bisect_right(starts, ev[1]) - 1
        if i >= 0 and ev[2] <= spans[i][1]:
            out.append(ev)
    return out


def _named(profile, names: Sequence[str], within) -> Optional[List[Event]]:
    spans = within(profile)
    if not spans or profile.n <= 0:
        return None
    return inside([ev for ev in profile.host if ev[0].startswith(names)],
                  spans)


def syncs(profile) -> Optional[float]:
    """Host synchronisations with the device a unit."""
    evs = _named(profile, SYNCS, units)
    return None if evs is None else len(evs) / profile.n


def sync_ms(profile) -> Optional[float]:
    """Host ms a unit inside those synchronisations."""
    evs = _named(profile, SYNCS, units)
    return None if evs is None else sum(
        e - s for _, s, e in evs) * 1e-6 / profile.n


def kernels(profile) -> Optional[float]:
    """Device kernels a unit: the profiled pass's device events that are
    neither a copy nor a fill (the pass runs only the program's units and
    the harness's closing synchronise)."""
    if not units(profile) or profile.n <= 0:
        return None
    return sum(1 for n, _, _ in profile.device
               if not n.lower().startswith(("memcpy", "memset"))
               ) / profile.n


def launches_in(profile, span: str) -> Optional[float]:
    """Kernel-launch runtime calls a unit inside the spans named
    ``gct/<span>``; None where there are none of those spans."""
    def named(p):
        return sorted((s, e) for n, s, e in gct(p) if n == PREFIX + span)
    evs = _named(profile, LAUNCHES, named)
    return None if evs is None else len(evs) / profile.n


# ---------------------------------------------------------------------------
# the split of a profiled pass by span, for PERF.md's breakdowns (standard
# error of a traced run)
# ---------------------------------------------------------------------------

def _union(ivs) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _overlap(a: Tuple[int, int], ivs: List[Tuple[int, int]]) -> int:
    return sum(max(0, min(a[1], e) - max(a[0], s)) for s, e in ivs)


def _innermost(events: Sequence[Event], t: int, default: str) -> str:
    inner = [(e - s, n) for n, s, e in events if s <= t <= e]
    return min(inner)[1] if inner else default


def split(profile, top: int = 10) -> Optional[dict]:
    """Device-idle time inside the units: its total ms a unit, the share
    under a ``gct/`` span below the unit, ms a unit by the innermost
    ``gct/`` span at each gap's midpoint; synchronisations and their ms a
    unit by innermost span; the ``top`` longest gaps inside units, each
    named by the innermost host event and the innermost span at its
    midpoint."""
    tops = units(profile)
    if not tops or profile.n <= 0:
        return None
    spans = gct(profile)
    top_set = set(tops)
    below = _union((s, e) for _, s, e in spans if (s, e) not in top_set)
    busy = _union((s, e) for _, s, e in profile.device)
    gaps = []
    for us, ue in tops:
        t = us
        for s, e in busy:
            if e <= us or s >= ue:
                continue
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < ue:
            gaps.append((t, ue))
    idle = sum(e - s for s, e in gaps)
    covered = sum(_overlap(g, below) for g in gaps)
    by_span: Dict[str, float] = {}
    for s, e in gaps:
        name = _innermost(spans, (s + e) // 2, "none")
        by_span[name] = by_span.get(name, 0.0) + (e - s) * 1e-6 / profile.n
    sync_by: Dict[str, List[float]] = {}
    for n, s, e in inside([ev for ev in profile.host
                           if ev[0].startswith(SYNCS)], tops):
        name = _innermost(spans, (s + e) // 2, "none")
        c = sync_by.setdefault(name, [0.0, 0.0])
        c[0] += 1 / profile.n
        c[1] += (e - s) * 1e-6 / profile.n
    longest = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = (s + e) // 2
        longest.append([_innermost(profile.host, mid, "host (no op)")[:80],
                        _innermost(spans, mid, "none"), (e - s) * 1e-6])
    return {"idle_ms": idle * 1e-6 / profile.n,
            "idle_under_span": covered / idle if idle else 1.0,
            "idle_ms_by_span": dict(sorted(by_span.items(),
                                           key=lambda kv: -kv[1])[:top]),
            "syncs_by_span": {k: [round(c, 3), round(ms, 4)] for k, (c, ms)
                              in sorted(sync_by.items(),
                                        key=lambda kv: -kv[1][1])},
            "longest_gaps_ms": longest}


def report(profile) -> None:
    """``split`` as one line of standard error."""
    got = split(profile)
    if got is not None:
        print("spans: " + json.dumps(got), file=sys.stderr)
