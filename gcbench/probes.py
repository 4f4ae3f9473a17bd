"""Device time of a module's forward or backward, from CUDA events that
hooks record on the current stream: what the per-layer readers install
on the program's modules (found by class name) for the instrumented
pass of a ``--trace 1`` run."""

from __future__ import annotations

import warnings
from typing import List

import torch

from gcbench.devices import event


def modules_named(roots, cls_name: str) -> List[torch.nn.Module]:
    """Every module under ``roots`` whose class is called ``cls_name``."""
    return [m for r in roots if r is not None for m in r.modules()
            if type(m).__name__ == cls_name]


class ForwardSpan:
    """Each forward call of ``module``: (start, end) events."""

    def __init__(self, module: torch.nn.Module):
        self.spans = []
        self._start = None
        self.handles = [
            module.register_forward_pre_hook(self._pre),
            module.register_forward_hook(self._post)]

    def _pre(self, module, args):
        self._start = event()

    def _post(self, module, args, out):
        self.spans.append((self._start, event()))

    def remove(self) -> None:
        for h in self.handles:
            h.remove()

    def ms(self) -> float:
        return sum(a.elapsed_time(b) for a, b in self.spans)


class BackwardSpan:
    """Each backward pass through ``module``: from the moment the gradient
    of its output is ready (full backward pre-hook) to the later of its
    input gradients (full backward hook) and the last gradient of its
    parameters accumulated.  A module whose inputs need no gradient
    fires its backward hook at once, so the parameters' hooks end it."""

    def __init__(self, module: torch.nn.Module):
        self.spans = []
        warnings.filterwarnings(
            "ignore", message="Full backward hook is firing when gradients")
        self.handles = [
            module.register_full_backward_pre_hook(self._pre),
            module.register_full_backward_hook(self._post)]
        for p in module.parameters():
            if p.requires_grad:
                self.handles.append(
                    p.register_post_accumulate_grad_hook(self._param))

    def _pre(self, module, grad_out):
        self.spans.append([event(), None])

    def _post(self, module, grad_in, grad_out):
        if self.spans:
            self.spans[-1][1] = event()

    def _param(self, p):
        if self.spans:
            self.spans[-1][1] = event()

    def remove(self) -> None:
        for h in self.handles:
            h.remove()

    def ms(self) -> float:
        return sum(a.elapsed_time(b) for a, b in self.spans if b is not None)


class Group:
    """Several spans read and removed as one."""

    def __init__(self, members):
        self.members = members

    def spans(self) -> list:
        return [s for m in self.members for s in m.spans]

    def ms(self) -> float:
        return sum(m.ms() for m in self.members)

    def remove(self) -> None:
        for m in self.members:
            m.remove()
