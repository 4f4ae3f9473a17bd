"""Model FLOPs and SubMConv work, counted on the reference.

``WorkCounter`` runs around the reference's steps or frames.  It counts
matmul and convolution FLOPs with ``torch.utils.flop_counter.
FlopCounterMode``, then replaces each SubMConv's products, which that
mode sees as dense over every kernel offset (missing neighbours are
gathered as zero rows), by the products of the neighbour pairs that
exist: 2 x pairs x C_in x C_out forward, twice that backward.
Recomputation is not counted (no configuration recomputes)."""

from __future__ import annotations

from typing import Dict, List

import torch
from torch.utils.flop_counter import FlopCounterMode

F32 = 4  # bytes of a float32
IDX = 4 + 1  # bytes of one neighbour-table entry: int32 row, bool found


class SubMConvCall(dict):
    """One SubMConv forward: ``pairs``, ``n`` rows, ``k3`` offsets,
    ``cin``, ``cout``, ``bwd`` (its backward runs), ``bwd_input`` (it
    computes the gradient of its input)."""

    def padded_flops(self) -> float:
        f = 2.0 * self["k3"] * self["n"] * self["cin"] * self["cout"]
        b = 0.0
        if self["bwd"]:
            b = f * (int(self["bwd_input"]) + 1)
        return f + b

    def flops(self) -> float:
        f = 2.0 * self["pairs"] * self["cin"] * self["cout"]
        return f * 3 if self["bwd"] else f

    def bytes(self) -> float:
        n, ci, co, k3 = self["n"], self["cin"], self["cout"], self["k3"]
        fwd = F32 * (n * ci + n * co + k3 * ci * co) + k3 * n * IDX
        bwd = F32 * (n * co + 2 * n * ci + 2 * k3 * ci * co) + k3 * n * IDX
        return fwd + (bwd if self["bwd"] else 0)


class WorkCounter:
    """``with WorkCounter(roots) as w:`` around reference calls; then
    ``w.flops()`` and ``w.calls`` (every SubMConv forward under
    ``roots``, in call order)."""

    def __init__(self, roots: List[torch.nn.Module]):
        self.roots = roots
        self.calls: List[SubMConvCall] = []
        self._fc = FlopCounterMode(display=False)
        self._handles = []

    def _hook(self, module, args, out):
        feat, (nb_idx, found) = args[0], args[1]
        grad = torch.is_grad_enabled()
        k = module.kernel
        self.calls.append(SubMConvCall(
            pairs=int(found.sum()), n=int(feat.shape[0]),
            k3=int(k.shape[0]), cin=int(k.shape[1]), cout=int(k.shape[2]),
            bwd=bool(grad and (k.requires_grad or feat.requires_grad)),
            bwd_input=bool(grad and feat.requires_grad)))

    def __enter__(self):
        for r in self.roots:
            for m in r.modules():
                if type(m).__name__ == "SubMConv":
                    self._handles.append(m.register_forward_hook(self._hook))
        self._fc.__enter__()
        return self

    def __exit__(self, *exc):
        self._fc.__exit__(*exc)
        for h in self._handles:
            h.remove()
        self._handles = []

    def flops(self) -> float:
        total = float(self._fc.get_total_flops())
        return (total - sum(c.padded_flops() for c in self.calls)
                + sum(c.flops() for c in self.calls))

    def submconv(self) -> Dict[str, float]:
        return {"flops": sum(c.flops() for c in self.calls),
                "bytes": sum(c.bytes() for c in self.calls),
                "calls": len(self.calls)}
