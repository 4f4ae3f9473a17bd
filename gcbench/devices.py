"""Device calls that the harness makes, which do nothing on the CPU: the
harness's own tests drive a whole run there at tiny sizes (``main``
refuses to run without a card)."""

from __future__ import annotations

import time

import torch


def cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def sync(device) -> None:
    if cuda(device):
        torch.cuda.synchronize()


def reset_peak(device) -> None:
    if cuda(device):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def peak_bytes(device) -> int:
    return int(torch.cuda.max_memory_allocated()) if cuda(device) else 0


def name(device) -> str:
    return torch.cuda.get_device_name(0) if cuda(device) else "cpu"


def free(device) -> None:
    if cuda(device):
        torch.cuda.empty_cache()


class HostEvent:
    """A stand-in for ``torch.cuda.Event`` on the CPU."""

    def __init__(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end: "HostEvent") -> float:
        return (end.t - self.t) * 1e3


def event():
    """A timing event recorded now on the current stream."""
    if not torch.cuda.is_available():
        return HostEvent()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev
