# -*- coding: utf-8 -*-
"""Dataset cleaning utilities (counterpart of
``gaussiancity_tpu/data/cleaning.py``; reference:
scripts/seg_map_discretizator.py,
scripts/google_earth_roof_cleaner.py, scripts/google_earth_asphalt_cleaner.py).

Offline NumPy tools for preparing the Google-Earth footage:
  - ``discretize_seg_map``: nearest-reference-color quantization of SEEM
    RGB segmentation output into class ids
  - ``clean_roofs``: replace noisy roof pixels with a re-colorized texture,
    dominant facade color per building (kmeans clustering)
  - ``clean_asphalt``: replace road pixels with an asphalt texture crop and
    mark them trainable in the Points msk
"""

from __future__ import annotations

import logging
import os
import pickle
import random
from typing import Dict, List, Optional

import numpy as np

# (reference: scripts/seg_map_discretizator.py:30-62)
_SEG_REF_COLORS = [
    ((0, 0, 0), 0), ((200, 200, 200), 0),
    ((210, 5, 20), 1), ((155, 0, 10), 1),
    ((220, 220, 40), 2),
    ((20, 220, 40), 3), ((0, 170, 0), 3),
    ((0, 160, 160), 4), ((50, 200, 200), 4),
    ((10, 10, 10), 5),
    ((15, 15, 200), 6), ((0, 0, 150), 6),
    ((150, 105, 25), 7), ((120, 80, 5), 7),
    ((230, 60, 215), 8), ((160, 0, 160), 8),
]

N_COLOR_CLUSTERS = 5
DEFAULT_ROOF_COLOR = 128
MIN_BLDG_INS = 100


def discretize_seg_map(img: np.ndarray) -> np.ndarray:
    """RGB [H, W, 3] -> class-id map by L1 nearest reference color
    (reference: seg_map_discretizator.py:30-67)."""
    img = img.astype(np.int16)
    colors = np.array([c for c, _ in _SEG_REF_COLORS], dtype=np.int16)
    ids = np.array([i for _, i in _SEG_REF_COLORS])
    dists = np.abs(img[:, :, None, :] - colors[None, None]).sum(-1)
    return ids[np.argmin(dists, axis=-1)]


def downsample_texture(roof_img: np.ndarray) -> np.ndarray:
    """Grayscale tiled roof texture in [0, 1] (reference:
    google_earth_roof_cleaner.py:36-46)."""
    import cv2

    texture = cv2.GaussianBlur(roof_img.astype(np.uint8), (0, 0),
                               sigmaX=3, sigmaY=3)
    texture = cv2.resize(np.tile(texture, (48, 48, 1)),
                         (roof_img.shape[1], roof_img.shape[0]))
    texture = np.tile(texture, (8, 8, 1))
    gray = cv2.cvtColor(texture, cv2.COLOR_BGR2GRAY).astype(np.float32) / 255.0
    return gray[..., None].repeat(3, axis=2)


def _dominant_facade_color(footage, facade_mask) -> Optional[np.ndarray]:
    """(reference: google_earth_roof_cleaner.py:49-82)"""
    import cv2
    import scipy.cluster.vq as vq

    default = np.array((DEFAULT_ROOF_COLOR,) * 3)
    nz = cv2.findNonZero(facade_mask.astype(np.uint8))
    if nz is None:
        return None
    fx, fy, fw, fh = cv2.boundingRect(nz)
    building = footage.copy()
    building[~facade_mask[..., None].repeat(3, axis=2)] = 0
    building = building[fy: fy + fh, fx: fx + fw]
    building = cv2.resize(building, (16, 16))
    colors = building.reshape(-1, 3).astype(np.float32)
    codebook, _ = vq.kmeans(colors, N_COLOR_CLUSTERS)
    code, _ = vq.vq(colors, codebook)
    counts, _ = np.histogram(code, len(codebook))
    dom = default
    while (dom <= DEFAULT_ROOF_COLOR).all() and (counts != -1).any():
        mi = int(np.argmax(counts))
        counts[mi] = -1
        dom = codebook[mi]
    return dom if (dom > DEFAULT_ROOF_COLOR).any() else None


def clean_roofs(footages: List[np.ndarray], ins_segs: List[np.ndarray],
                roof_textures: List[np.ndarray],
                rng: Optional[random.Random] = None) -> List[np.ndarray]:
    """Replace roof pixels across a trajectory
    (reference: google_earth_roof_cleaner.py:102-175)."""
    import cv2
    import scipy.cluster.vq as vq

    rng = rng or random.Random(0)
    roof_colors: Dict[int, List[np.ndarray]] = {}
    for footage, seg in zip(footages, ins_segs):
        for i in np.unique(seg):
            i = int(i)
            if i <= MIN_BLDG_INS or i % 2 != 0:
                continue
            dom = _dominant_facade_color(footage, seg == i)
            roof_colors.setdefault(i, [])
            if dom is not None:
                roof_colors[i].append(dom)

    textures: Dict[int, np.ndarray] = {}
    for ins, colors in roof_colors.items():
        tex = rng.choice(roof_textures).copy()
        if not colors:
            color = np.array((DEFAULT_ROOF_COLOR,) * 3)
        else:
            codebook, _ = vq.kmeans(
                np.array(colors), min(N_COLOR_CLUSTERS, len(colors)))
            code, _ = vq.vq(colors, codebook)
            counts, _ = np.histogram(code, len(codebook))
            color = codebook[int(np.argmax(counts))]
        textures[ins] = (tex * color).astype(np.uint8)

    out = []
    for footage, seg in zip(footages, ins_segs):
        footage = footage.copy()
        for i, tex in textures.items():
            roof_mask = (seg == i + 1)[..., None]
            nz = cv2.findNonZero(roof_mask[..., 0].astype(np.uint8))
            if nz is None:
                continue
            rot = cv2.getRotationMatrix2D(
                (tex.shape[1] // 2, tex.shape[0] // 2),
                rng.randint(0, 45), 1)
            tex_r = cv2.warpAffine(tex, rot, (tex.shape[0], tex.shape[1]),
                                   borderMode=cv2.BORDER_REPLICATE)
            rh, rw, _ = tex_r.shape
            mx, my, mw, mh = cv2.boundingRect(nz)
            if rh <= mh or rw <= mw:
                continue
            ry, rx = rh // 2 - mh // 2, rw // 2 - mw // 2
            roof_img = np.zeros(footage.shape, dtype=np.uint8)
            roof_img[my: my + mh, mx: mx + mw] = tex_r[ry: ry + mh,
                                                       rx: rx + mw]
            footage = footage * (1 - roof_mask) + roof_img * roof_mask
        out.append(footage.astype(np.uint8))
    return out


def clean_asphalt(city_dir: str, asphalt_img: np.ndarray,
                  rng: Optional[np.random.Generator] = None) -> int:
    """Replace road pixels with asphalt texture and mark them trainable
    (reference: google_earth_asphalt_cleaner.py:20-59). Returns #frames."""
    from PIL import Image

    rng = rng or np.random.default_rng(0)
    footage_dir = os.path.join(city_dir, "footage")
    ins_dir = os.path.join(city_dir, "InstanceImage")
    pts_dir = os.path.join(city_dir, "Points")
    if not (os.path.isdir(ins_dir) and os.path.isdir(pts_dir)):
        logging.warning("missing InstanceImage/Points in %s", city_dir)
        return 0
    ah, aw, _ = asphalt_img.shape
    n = 0
    for f, i, p in zip(sorted(os.listdir(footage_dir)),
                       sorted(os.listdir(ins_dir)),
                       sorted(os.listdir(pts_dir))):
        footage = np.array(Image.open(os.path.join(footage_dir, f)))
        seg = np.array(Image.open(os.path.join(ins_dir, i)))
        with open(os.path.join(pts_dir, p), "rb") as fp:
            pts = pickle.load(fp)
        fh, fw, _ = footage.shape
        road_mask = (seg == 1)[..., None].astype(np.uint8)
        y = int(rng.integers(0, ah - fh))
        x = int(rng.integers(0, aw - fw))
        patch = asphalt_img[y: y + fh, x: x + fw]
        footage = patch * road_mask + footage * (1 - road_mask)
        Image.fromarray(footage.astype(np.uint8)).save(
            os.path.join(footage_dir, f))
        pts["msk"][road_mask[..., 0].astype(bool)] = 1
        with open(os.path.join(pts_dir, p), "wb") as fp:
            pickle.dump(pts, fp)
        n += 1
    return n
