"""Traffic sampler ``city_views``: views of the city on an orbit around its
centre, one a train sample, each the REST points in the train crop."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from gcbench import inputs
from gcbench.reference.frame import (get_orbit_camera_poses,
                                     normalize_rel_cords)


def sample(cfg, traffic: dict, seed: int, device, city
           ) -> List[Dict[str, torch.Tensor]]:
    """``n_samples`` views of the city on an orbit (``view_radius``,
    ``view_altitude``) around its centre, each the REST points (instances
    below 100) inside the centred train crop, capped at ``points`` by a
    sorted random subset as upstream's RandomCrop caps them, with the
    city's height field and segmentation as the encoder's projection
    maps.  Points hidden behind buildings are kept: no raycast decides
    visibility here.  ``city`` is the traffic's (``inputs.city_from``)."""
    projections, centers = city
    pts = inputs.extrude_city(projections, False, device)
    rest = pts[pts[:, 4] < 100]
    P = traffic["city"]["size"]
    poses = get_orbit_camera_poses(P, traffic["n_samples"],
                                   traffic["view_radius"],
                                   traffic["view_altitude"])
    rng = np.random.default_rng(inputs.sub_seed(seed, 1))
    ds = cfg.dataset
    r = projections["REST"]
    pick = np.arange(ds.proj_size) * P // ds.proj_size
    hf = r["TD_HF"][np.ix_(pick, pick)].astype(np.float32)
    seg = r["SEG"][np.ix_(pick, pick)] % ds.n_classes
    proj_hf = torch.as_tensor(hf[None, :, :, None], device=device)
    proj_seg = torch.nn.functional.one_hot(
        torch.as_tensor(seg[None], device=device).long(),
        ds.n_classes).float()
    out = []
    for pose in poses:
        cam_pos = np.array([pose["tx"], pose["ty"], pose["tz"]])
        quat = np.array([pose["qx"], pose["qy"], pose["qz"], pose["qw"]])
        seen = rest[inputs.in_crop(cfg, rest[:, :3].astype(np.float32),
                                   cam_pos, quat, device)]
        rows, n_valid = inputs.pad_rows(seen, traffic["points"], rng)
        pts9 = np.concatenate([rows.astype(np.float32),
                               normalize_rel_cords(rows, centers)], axis=1)
        b = inputs.targets(cfg, rng, traffic["points"], n_valid, pts9,
                           cam_pos, quat, device)
        b["proj_hf"], b["proj_seg"] = proj_hf, proj_seg
        out.append(b)
    return inputs.rotate(out, seed)
