"""The numbers that decide ``correct``, each read from the program's
output and the reference's for the same inputs and weights.

Train cells (the first ``followed_steps`` steps of the one trainer the
window then drives, and the reference over the same steps):

- ``loss``: the largest relative gap of any of the seven losses (G: L1,
  perceptual, GAN, total; D: fake, real, total) over the steps;
- ``attrs``: the first step's Gaussian attributes, the largest gap over
  the largest reference magnitude, worst attribute;
- ``crop``: the first step's rendered crop, the largest absolute gap;
- ``grad.G``, ``grad.D``: the first gradient as Adam got it (its first
  moment after one step over 1 - beta1), by the worst leaf: the gap
  between the two norms over the larger of the reference leaf's norm and
  the median leaf's;
- ``change.G``: the norm of each leaf's change after the followed steps,
  by the worst leaf as above, leaving out leaves whose reference gradient
  is under a thousandth of the median leaf's (they move by round-off);
- ``adam.D``: D's Adam after the followed steps, whose warm-up learning
  rate moves D's weights by less than their rounding: the norm of each
  leaf's second moment by the worst leaf as above, and infinite where a
  leaf's step count differs from the reference's;
- ``lr.D``: the learning rate D's Adam applied at each followed step, the
  largest gap over the largest the reference applied (exact);
- ``replicas`` (data-parallel cells, ``gcbench/kinds/train_ddp.py``): the
  largest gap between any rank's weights and running state and rank 0's
  after the followed steps (exact).

Frame cells (a seed-drawn sample of the window's frames):

- ``vis_rows``: visible point rows in one set and not the other, summed
  over the sampled frames (exact);
- ``gauss``: the Gaussians fed to the rasterizer, the largest gap over
  the largest reference magnitude of its channel, worst channel;
- ``frame_px``: the share of the frame's channel values that differ by
  more than one grey level, worst frame;
- ``frame_any``: the share that differ at all, worst frame.

Each cell compares the numbers its limits file names.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

LOSS_KEYS = ("GenLoss", "L1Loss", "PerceptualLoss", "GANLoss", "DisLoss",
             "GANLossFake", "GANLossReal")
COUNTER_KEYS = ("RasterDroppedPairs", "RasterTruncated",
                "RasterGradTruncated", "PTv3PoolOverflow")


def named_params(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {n: p for n, p in module.named_parameters()}


def _moment_norm(opt: torch.optim.Optimizer, p: torch.Tensor,
                 key: str) -> float:
    """The norm of Adam's ``key`` moment of ``p``; 0 where Adam has not
    stepped it."""
    st = opt.state.get(p, {})
    return float(st[key].norm()) if key in st else 0.0


def adam_grad_norms(opt: torch.optim.Optimizer, params: Dict[str, torch.Tensor],
                    beta1: float) -> Dict[str, float]:
    """Each leaf's first gradient from Adam's first moment after one
    step (m = (1 - beta1) g)."""
    return {n: _moment_norm(opt, p, "exp_avg") / (1.0 - beta1)
            for n, p in params.items()}


def adam_state(opt: torch.optim.Optimizer, params: Dict[str, torch.Tensor]
               ) -> Dict[str, Dict[str, float]]:
    """Each leaf's second-moment norm and step count."""
    return {"v": {n: _moment_norm(opt, p, "exp_avg_sq")
                  for n, p in params.items()},
            "steps": {n: float(opt.state.get(p, {}).get("step", 0))
                      for n, p in params.items()}}


def change_norms(params: Dict[str, torch.Tensor],
                 start: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float((p.detach() - start[n]).norm())
            for n, p in params.items()}


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               keep=None) -> float:
    names = [n for n in ref if keep is None or keep(n)]
    if not names:
        return 0.0
    med = float(np.median([ref[n] for n in names]))
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
               for n in names)


def rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float(), b.float()
    if a.shape != b.shape:
        return float("inf")
    scale = float(b.abs().max()) if b.numel() else 0.0
    return float((a - b).abs().max()) / max(scale, 1e-30) if b.numel() \
        else 0.0


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref``: ``losses`` (a dict a step), ``attrs``,
    ``crop``, ``grad`` / ``change`` (per module, per leaf), ``adam_D``
    (``adam_state`` of D) and ``lr_D`` (D's learning rate a step)."""
    loss = max(abs(p[k] - r[k]) / max(abs(r[k]), 1e-12)
               for p, r in zip(prog["losses"], ref["losses"])
               for k in LOSS_KEYS)
    attrs = max(rel_gap(prog["attrs"][k], ref["attrs"][k])
                for k in ref["attrs"])
    crop = float((prog["crop"] - ref["crop"]).abs().max())
    out = {"loss": loss, "attrs": attrs, "crop": crop}
    for m in ("G", "D"):
        out[f"grad.{m}"] = worst_leaf(prog["grad"][m], ref["grad"][m])
    g = ref["grad"]["G"]
    floor = 1e-3 * float(np.median(list(g.values())))
    out["change.G"] = worst_leaf(prog["change"]["G"], ref["change"]["G"],
                                 keep=lambda n: g[n] >= floor)
    pa, ra = prog["adam_D"], ref["adam_D"]
    out["adam.D"] = (worst_leaf(pa["v"], ra["v"])
                     if pa["steps"] == ra["steps"] else float("inf"))
    out["lr.D"] = (max(abs(a - b) for a, b in zip(prog["lr_D"], ref["lr_D"]))
                   / max(max(ref["lr_D"]), 1e-30)
                   if len(prog["lr_D"]) == len(ref["lr_D"]) else float("inf"))
    return out


def rows_set(rows: np.ndarray) -> set:
    return set(map(tuple, np.asarray(rows).tolist()))


def frame_numbers(prog: List[dict], ref: List[dict]) -> Dict[str, float]:
    """One dict a sampled frame on each side: ``rows`` (visible rows),
    ``gauss`` [n, 14], ``frame`` uint8 [H, W, 3]."""
    vis, gauss, px, diff = 0, 0.0, 0.0, 0.0
    for p, r in zip(prog, ref):
        vis += len(rows_set(p["rows"]) ^ rows_set(r["rows"]))
        a, b = p["gauss"].float(), r["gauss"].float()
        if a.shape != b.shape:
            gauss = float("inf")
        else:
            scale = b.abs().amax(dim=0).clamp_min(1e-30)
            gauss = max(gauss, float(((a - b).abs().amax(dim=0)
                                      / scale).max()))
        d = np.abs(p["frame"].astype(np.int16) - r["frame"].astype(np.int16))
        px = max(px, float((d > 1).mean()))
        diff = max(diff, float((d > 0).mean()))
    return {"vis_rows": float(vis), "gauss": gauss, "frame_px": px,
            "frame_any": diff}


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: (value, limit)}) over the numbers that have a
    limit; a number with none, or a missing one, fails."""
    compared = {k: (float(numbers.get(k, float("inf"))), limits[k])
                for k in limits}
    ok = all(np.isfinite(v) and v <= lim for v, lim in compared.values())
    return bool(ok), compared
