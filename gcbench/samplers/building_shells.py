"""Traffic sampler ``building_shells``: the city's largest buildings, one
a train sample, each seen by a camera facing it."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from gcbench import inputs
from gcbench.reference.frame import (get_quat_from_look_at,
                                     normalize_rel_cords)


def sample(cfg, traffic: dict, seed: int, device, city
           ) -> List[Dict[str, torch.Tensor]]:
    """The city's ``n_samples`` largest buildings by shell points, each a
    sample of ``points`` shell points (facade and roof, bottom rings
    included) seen by a camera facing the building from 0.75 of the
    distance at which its height fills the crop (``chip_smoke.
    building_batch``, frozen).  The buildings are the same for every
    seed; the point subsets, the targets and their order come from it.
    ``city`` is the traffic's (``inputs.city_from``)."""
    projections, centers = city
    pts = inputs.extrude_city(projections, True, device)
    ids = pts[:, 4].astype(np.int64)
    bldg = np.where(ids >= 100, ids - (ids - 100) % 2, -1)
    uniq, counts = np.unique(bldg[bldg >= 0], return_counts=True)
    largest = uniq[np.argsort(-counts, kind="stable")[:traffic["n_samples"]]]
    rng = np.random.default_rng(inputs.sub_seed(seed, 1))
    ds = cfg.dataset
    out = []
    for iid in largest:
        shell, n_valid = inputs.pad_rows(pts[bldg == iid],
                                         traffic["points"], rng)
        pts9 = np.concatenate([shell.astype(np.float32),
                               normalize_rel_cords(shell, centers)], axis=1)
        cx, cy, _, _, d = centers[int(iid)]
        target = np.array([cx, cy, d / 2])
        dist = 0.75 * d * ds.cam_k[0] / ds.train_crop_size[1]
        cam_pos = target + np.array([dist / np.sqrt(2), dist / np.sqrt(2),
                                     d / 4])
        out.append(inputs.targets(
            cfg, rng, traffic["points"], n_valid, pts9, cam_pos,
            get_quat_from_look_at(cam_pos, target), device))
    return inputs.rotate(out, seed)
