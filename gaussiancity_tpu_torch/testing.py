# -*- coding: utf-8 -*-
"""Test-size inputs shared by the port's tests and the smoke script: the
small PTv3 of the JAX test suite (``tests/test_ptv3.py``) and a BLDG batch
that it finds neighbours in."""

from __future__ import annotations

import numpy as np

# keyword arguments of ``PTv3Config`` in either package: three levels at
# widths 8-32, one block each, patches of 32
TINY_PTV3 = dict(order=("cord",), stride=(2, 2), enc_depths=(1, 1, 1),
                 enc_channels=(8, 16, 32), enc_n_head=(1, 2, 4),
                 enc_patch_size=(32, 32, 32), dec_depths=(1, 1),
                 dec_channels=(8, 16), dec_n_head=(1, 2),
                 dec_patch_size=(32, 32), mlp_ratio=2.0)


def tiny_bldg_batch(cfg, n_pts: int = 128, seed: int = 1) -> dict:
    """A numpy batch of one sample for ``cfg``'s train crop: ``n_pts``
    points 5-30 m ahead of a camera at the origin that looks along +x,
    building instance ids 100-103, and PTv3 coordinates on the faces of a
    16-voxel cube (voxel 0.01), so that the sparse convolutions find
    neighbours; random RGB and seg targets, empty projections."""
    ds = cfg.dataset
    Wc, Hc = ds.train_crop_size
    P = ds.proj_size
    rng = np.random.default_rng(seed)
    depth = rng.uniform(5.0, 30.0, (1, n_pts))
    abs_xyz = np.stack([depth, rng.uniform(-0.8, 0.8, (1, n_pts)) * depth,
                        rng.uniform(-0.3, 0.3, (1, n_pts)) * depth], -1)
    lattice = rng.integers(0, 16, (n_pts, 3))
    face = rng.integers(0, 6, n_pts)
    lattice[np.arange(n_pts), face % 3] = np.where(face < 3, 0, 15)
    rel = ((lattice + 0.5) * 0.01 - 0.08)[None]
    pts = np.concatenate([
        abs_xyz, rng.uniform(0.3, 1.0, (1, n_pts, 1)),
        rng.integers(100, 104, (1, n_pts, 1)).astype(np.float64), rel,
        np.zeros((1, n_pts, 1))], -1).astype(np.float32)
    return {
        "pts": pts, "pts_mask": np.ones((1, n_pts), bool),
        "rgb": rng.uniform(-1, 1, (1, Hc, Wc, 3)).astype(np.float32),
        "seg": np.eye(ds.n_classes, dtype=np.float32)[
            rng.integers(0, ds.n_classes, (1, Hc, Wc))],
        "msk": np.ones((1, Hc, Wc, 1), np.float32),
        "proj_hf": np.zeros((1, P, P, 1), np.float32),
        "proj_seg": np.zeros((1, P, P, ds.n_classes), np.float32),
        "cam_pos": np.zeros((1, 3), np.float32),
        "cam_quat": np.array([[0.0, 0, 0, 1]], np.float32),
        "crp_xy": np.array([[16, 8]], np.int32)}
