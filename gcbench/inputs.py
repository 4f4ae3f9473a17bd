"""The cells' inputs, made from the seed by the benchmark and handed alike
to the program and to the reference: the synthetic city, the training
samples and the camera orbit.

The city and its helpers are frozen copies of ``chip_smoke.py``'s
(``synthetic_city``, ``building_batch``) built on the reference's own
extrusion, normalisation and look-at code, so that nothing here runs the
program.  A train traffic file's ``sampler`` names the module
``gcbench/samplers/<sampler>.py`` whose ``sample(cfg, traffic, seed,
device, city)`` makes its samples from the traffic's city; every number
a sampler uses comes from the traffic file
(``gcbench/traffic/<name>.json``).
"""

from __future__ import annotations

import importlib
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

from gcbench.reference.gct.ops import extrusion as ext
from gcbench.reference.gct.ops.rasterizer import preprocess
from gcbench.reference.frame import get_orbit_camera_poses
from gcbench.reference.gct.camera import CameraModel


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed derived from the run's seed and ``tags``."""
    (s,) = np.random.SeedSequence([int(seed), *tags]).generate_state(
        1, dtype=np.uint64)
    return int(s) >> 1


def synthetic_city(P: int, n_buildings: int, seed: int):
    """Roads and a random grid of box buildings: REST projections and
    instance centres (``chip_smoke.synthetic_city``, frozen)."""
    rng = np.random.default_rng(seed)
    ins = np.ones((P, P), np.int16)
    td = np.full((P, P), 2, np.int16)
    for bi in range(n_buildings):
        x, y = rng.integers(16, P - 48, 2)
        w, h = rng.integers(12, 40, 2)
        ins[y:y + h, x:x + w] = 100 + 2 * bi
        td[y:y + h, x:x + w] = rng.integers(20, 120)
    seg = np.where(ins >= 100, 2, ins).astype(np.int16)
    projections = {"REST": {
        "INS": ins, "SEG": seg, "TD_HF": td,
        "BU_HF": np.zeros((P, P), np.int16), "PTS": np.ones((P, P), bool)}}
    return projections, instance_centers(ins, td)


def instance_centers(ins: np.ndarray, td: np.ndarray) -> dict:
    """Each instance's (mean x, mean y, width, depth, top) over its pixels
    of the [P, P] instance and height maps, mirrored to id + 1 (a
    building's roof)."""
    P = ins.shape[1]
    # grouped by one stable sort (the sums of integers are exact)
    flat = ins.ravel()
    order = np.argsort(flat, kind="stable")
    ids, starts, counts = np.unique(flat[order], return_index=True,
                                    return_counts=True)
    ys, xs = np.divmod(order, P)
    hf = td.ravel()[order]
    centers = {}
    for iid, s, n, sx, sy, x0, x1, y0, y1, top in zip(
            ids, starts, counts, np.add.reduceat(xs, starts),
            np.add.reduceat(ys, starts), np.minimum.reduceat(xs, starts),
            np.maximum.reduceat(xs, starts), np.minimum.reduceat(ys, starts),
            np.maximum.reduceat(ys, starts), np.maximum.reduceat(hf, starts)):
        centers[int(iid)] = (float(sx / n), float(sy / n),
                             float(x1 - x0 + 1), float(y1 - y0 + 1),
                             float(top))
        centers[int(iid) + 1] = centers[int(iid)]
    return centers


def city_from(traffic: dict, root: str):
    """The traffic's city: (projections, centers).  A ``city`` that names
    a ``builder`` is built by ``build(city)`` of
    ``<root>/gcbench/cities/<builder>.py``, ``root`` the cell's; any other
    is the synthetic city."""
    c = traffic["city"]
    if "builder" in c:
        from gcbench.harness import load_module

        return load_module(os.path.join(root, "gcbench", "cities",
                                        f"{c['builder']}.py")).build(c)
    return synthetic_city(c["size"], c["n_buildings"], c["seed"])


def extrude_city(projections, include_btm_pts: bool, device
                 ) -> np.ndarray:
    """The city's points [N, 5] (x, y, z, scale, instance), extruded on
    ``device`` by the reference's plain extrusion."""
    r = projections["REST"]
    maps = [torch.as_tensor(np.asarray(r[k], np.int32), device=device)
            for k in ("INS", "TD_HF", "BU_HF")]
    maps.append(torch.as_tensor(np.asarray(r["PTS"]) != 0, device=device))
    return ext.extrude_points_exact(*maps, ext.SegInsRelation(),
                                    ext.GOOGLE_EARTH_CLASS_SCALES,
                                    include_btm_pts=include_btm_pts
                                    ).cpu().numpy()


def targets(cfg, rng, n_points: int, n_valid: int, pts9: np.ndarray,
             cam_pos, quat, device) -> Dict[str, torch.Tensor]:
    """One sample's batch: points with their mask, random RGB and
    segmentation targets of the crop, a full mask and a centred crop."""
    ds = cfg.dataset
    Wc, Hc = ds.train_crop_size
    W, H = ds.sensor_size
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "pts": torch.as_tensor(pts9[None], **f32),
        "pts_mask": torch.arange(n_points, device=device)[None] < n_valid,
        "rgb": torch.as_tensor(rng.uniform(-1, 1, (1, Hc, Wc, 3)), **f32),
        "seg": torch.as_tensor(np.eye(ds.n_classes)[rng.integers(
            0, ds.n_classes, (1, Hc, Wc))], **f32),
        "msk": torch.ones((1, Hc, Wc, 1), **f32),
        "cam_pos": torch.as_tensor(np.asarray(cam_pos)[None], **f32),
        "cam_quat": torch.as_tensor(np.asarray(quat)[None], **f32),
        "crp_xy": torch.tensor([[(W - Wc) // 2, (H - Hc) // 2]],
                               dtype=torch.int32, device=device)}


def pad_rows(rows: np.ndarray, n_points: int, rng) -> Tuple[np.ndarray, int]:
    """A sorted random subset of ``n_points`` rows, or all rows padded to
    ``n_points`` with copies of the first (masked off)."""
    n_valid = min(len(rows), n_points)
    rows = rows[np.sort(rng.choice(len(rows), n_valid, replace=False))]
    return np.concatenate([rows, np.repeat(rows[:1], n_points - n_valid,
                                           0)]), n_valid


def rotate(samples: list, seed: int) -> list:
    """The same samples for every seed, starting at a seed-drawn one."""
    k = sub_seed(seed, 2) % len(samples)
    return samples[k:] + samples[:k]


def in_crop(cfg, xyz: np.ndarray, cam_pos, quat, device) -> np.ndarray:
    """Rows of ``xyz`` that the camera sees in front of it inside the
    centred train crop, by the reference rasterizer's own projection."""
    ds = cfg.dataset
    cam = CameraModel(np.asarray(ds.cam_k).reshape(3, 3),
                      ds.sensor_size).params(cam_pos, quat, device=device)
    x = torch.as_tensor(xyz, dtype=torch.float32, device=device)
    n = len(x)
    one = x.new_ones(n)
    prep = preprocess.preprocess(
        x, one, x.new_full((n, 3), 1e-3),
        x.new_tensor([1.0, 0, 0, 0]).expand(n, 4), x.new_zeros((n, 3)),
        one.bool(), cam, near_z=cfg.rasterizer.near_z)
    W, H = ds.sensor_size
    Wc, Hc = ds.train_crop_size
    x0, y0 = (W - Wc) // 2, (H - Hc) // 2
    mx, my = prep.mx, prep.my
    keep = ((prep.depth > cfg.rasterizer.near_z) & (mx >= x0)
            & (mx < x0 + Wc) & (my >= y0) & (my < y0 + Hc))
    return keep.cpu().numpy()


def sampler(name: str):
    """The ``sample`` function of ``gcbench/samplers/<name>.py``."""
    return importlib.import_module(f"gcbench.samplers.{name}").sample


def samples(cell, cfg, seed: int, device) -> list:
    """A train cell's samples: its traffic's ``sampler`` over its city."""
    t = cell.traffic
    return sampler(t["sampler"])(cfg, t, seed, device,
                                 city_from(t, cell.root))


def orbit(traffic: dict, seed: int) -> List[dict]:
    """The traffic's orbit over the city's centre, the same poses for
    every seed, starting at a seed-drawn pose."""
    P = traffic["city"]["size"]
    poses = get_orbit_camera_poses(P, traffic["n_poses"], traffic["radius"],
                                   traffic["altitude"])
    return rotate(poses, seed)
