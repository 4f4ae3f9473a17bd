"""The profiled pass of a ``--trace 1`` run and what is read from it:
device busy time (the union of the intervals of the device's kernels,
copies and fills; the device-side spans of annotations such as
``Optimizer.step#Adam.step`` cover idle time and are left out), the
window's length, device time by kernel name, and the longest idle gaps
labelled by the host operation that was running in them."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

from gcbench.devices import sync


def _v(ev, name: str):
    """A profiler event's field, a method or an attribute by version."""
    x = getattr(ev, name)
    return x() if callable(x) else x


def _device_work(ev) -> bool:
    """Whether a device-side profiler event is work on the device (a
    kernel, a copy or a fill) and not an annotation's device span."""
    return not _v(ev, "is_user_annotation")


@dataclass
class Profile:
    window_s: float
    n: int  # steps or frames profiled
    device: List[Tuple[str, int, int]]  # (name, start_ns, end_ns)
    host: List[Tuple[str, int, int]] = field(default_factory=list)

    def busy_s(self) -> float:
        busy, end = 0, None
        for _, s, e in sorted(self.device, key=lambda t: t[1]):
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy * 1e-9

    def kernel_s(self, names) -> float:
        """Seconds of device activity whose name holds one of ``names``."""
        return sum(e - s for n, s, e in self.device
                   if any(k in n for k in names)) * 1e-9

    def by_name(self, top: int = 10) -> List[list]:
        tot: Dict[str, int] = {}
        for n, s, e in self.device:
            tot[n] = tot.get(n, 0) + e - s
        return [[n[:160], t * 1e-9] for n, t in
                sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """The ``top`` longest gaps between device activity, each named by
        the innermost host operation running at its midpoint."""
        ivs = sorted((s, e) for _, s, e in self.device)
        gaps, end = [], None
        for s, e in ivs:
            if end is not None and s > end:
                gaps.append((s - end, end, s))
            end = e if end is None else max(end, e)
        gaps.sort(reverse=True)
        out = []
        for length, a, b in gaps[:top]:
            mid = (a + b) // 2
            inside = [(he - hs, n) for n, hs, he in self.host
                      if hs <= mid <= he]
            out.append([min(inside)[1][:160] if inside else "host (no op)",
                        length * 1e-9])
        return out


def profiled(run: Callable[[int], None], n: int, device) -> Profile:
    """Run ``run(i)`` for i < n under ``torch.profiler`` (CPU and CUDA
    activity), the device synchronised at both ends."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    sync(device)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            run(i)
        sync(device)
        window = time.perf_counter() - t0
    on_device, host = [], []
    for ev in prof.profiler.kineto_results.events():
        s = int(_v(ev, "start_ns"))
        rec = (str(_v(ev, "name")), s, s + int(_v(ev, "duration_ns")))
        if _v(ev, "device_type") == torch.autograd.DeviceType.CPU:
            host.append(rec)
        elif _device_work(ev):
            on_device.append(rec)
    return Profile(window_s=window, n=n, device=on_device, host=host)
