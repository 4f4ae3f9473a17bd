# -*- coding: utf-8 -*-
"""Datasets and the host data loader (counterpart of
``gaussiancity_tpu/data/datasets.py``; upstream utils/datasets.py).

``GoogleEarthDataset`` and ``Kitti360Dataset`` read the on-disk layout of
upstream's offline generator (CameraPoses.csv, CENTERS.pkl, footage,
InstanceImage, Projection, Points); ``SyntheticDataset`` makes procedural
city crops with no download.  Items are numpy batch dicts
(``transforms.ToBatchArrays``); the trainer moves them to its device.

``DataLoader`` replaces torch's DataLoader and DistributedSampler: a
multi-epoch host iterator that shards the items over ranks and prefetches
with threads.  Its rank and world size come from the caller, else from an
initialised ``torch.distributed``, else 0 and 1.  Train items draw their
augmentation from a numpy generator seeded by (loader seed, epoch, item),
so an epoch's batches do not depend on the run that made the epochs
before it (the JAX package seeds a train item from the OS)."""

from __future__ import annotations

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional

import numpy as np

from gaussiancity_tpu_torch.config import Config, DatasetConfig
from gaussiancity_tpu_torch.data import transforms as T
from gaussiancity_tpu_torch.data.io import IO
from gaussiancity_tpu_torch.utils import helpers


def instances_to_classes_np(instances: np.ndarray, ds: DatasetConfig):
    """Instance id -> class id on the host (upstream utils/datasets.py
    :265-282, 334-352)."""
    inst = instances.astype(np.int64)
    out = inst.copy()
    in_bldg = (inst >= ds.bldg_range[0]) & (inst < ds.bldg_range[1])
    out[in_bldg & (inst % 2 == 0)] = ds.bldg_facade_clsid
    out[in_bldg & (inst % 2 == 1)] = ds.bldg_roof_clsid
    if ds.car_range is not None:
        in_car = (inst >= ds.car_range[0]) & (inst < ds.car_range[1])
        out[in_car] = ds.car_clsid
    return out


class Dataset:
    """Base dataset (upstream utils/datasets.py:50-253)."""

    def __init__(self, cfg: Config, split: str):
        self.cfg = cfg
        self.ds = cfg.dataset
        self.split = split
        self.pipeline = (
            T.train_pipeline(self.ds, cfg.train.max_points)
            if split == "train"
            else T.test_pipeline(self.ds, cfg.train.max_points))
        self.memcached: Dict[str, object] = {}
        self.renderings: List[Dict[str, str]] = []

    def get_K(self):
        return np.asarray(self.ds.cam_k, np.float32).reshape(3, 3)

    def get_sensor_size(self):
        return self.ds.sensor_size

    def is_flip_ud(self):
        return self.ds.flip_ud

    def get_n_classes(self):
        return self.ds.n_classes

    def get_special_z_scale_classes(self):
        return list(self.ds.z_scale_special_classes)

    def get_proj_size(self):
        return self.ds.proj_size

    def pin_memory(self, files, keys):
        for f in files:
            for k, v in f.items():
                if k in keys and v not in self.memcached:
                    if os.path.exists(v):
                        self.memcached[v] = IO.get(v)

    def __len__(self):
        return len(self.renderings) * (
            self.ds.n_repeat if self.split == "train" else 1)

    def load_raw(self, idx: int) -> Dict[str, np.ndarray]:
        """(upstream utils/datasets.py:96-144)"""
        r = self.renderings[idx % len(self.renderings)]
        view_idx = int(r["name"].split("/")[-1])
        Rt = self.memcached.get(r["Rt"]) or IO.get(r["Rt"])
        centers = self.memcached.get(r["centers"]) or IO.get(r["centers"])
        rgb = np.array(IO.get(r["rgb"]), dtype=np.float32) / 255.0 * 2 - 1
        ins = (helpers.get_ins_id(np.array(IO.get(r["ins"]), np.float64))
               if r.get("ins_rgb_encoded") else np.array(IO.get(r["ins"])))
        seg = instances_to_classes_np(ins, self.ds)
        pts = IO.get(r["pts"])
        rt = Rt[view_idx]
        cam_pos = np.array([rt["tx"], rt["ty"], rt["tz"]],
                           np.float32) / self.ds.scale
        cam_pos[:2] += self.ds.map_size // 2
        data = {
            "cam_pos": cam_pos,
            "cam_quat": np.array([rt["qx"], rt["qy"], rt["qz"], rt["qw"]],
                                 np.float32),
            "centers": centers,
            "rgb": rgb,
            "seg": seg,
            "ins": ins,
            "proj/hf": np.asarray(pts["prj"]["TD_HF"]),
            "proj/seg": np.asarray(pts["prj"]["SEG"]),
            "vpm": pts["vpm"],
            "msk": pts["msk"],
            "pts": pts["pts"],
        }
        if "affmat" in pts["prj"] and "tlp" in pts["prj"]:
            data["proj/affmat"] = pts["prj"]["affmat"]
            data["proj/tlp"] = pts["prj"]["tlp"]
        return data

    def get(self, idx: int, rng: Optional[np.random.Generator] = None):
        """Item ``idx`` through the split's pipeline, its random draws from
        ``rng``; without one, a val item seeds its generator with ``idx``
        and a train item from the OS, as the JAX package does."""
        if rng is None:
            rng = np.random.default_rng(
                None if self.split == "train" else idx)
        return self.pipeline(self.load_raw(idx), rng)

    def __getitem__(self, idx: int):
        return self.get(idx)


class GoogleEarthDataset(Dataset):
    """(upstream utils/datasets.py:256-321)"""

    def __init__(self, cfg: Config, split: str):
        super().__init__(cfg, split)
        ds = self.ds
        cities = (sorted(os.listdir(ds.dir))[: ds.n_cities]
                  if os.path.isdir(ds.dir) else [])
        files = [
            {
                "name": f"{c}/{i:02d}",
                "Rt": os.path.join(ds.dir, c, "CameraPoses.csv"),
                "centers": os.path.join(ds.dir, c, "CENTERS.pkl"),
                "rgb": os.path.join(ds.dir, c, "footage",
                                    f"{c}_{i:02d}.jpeg"),
                "ins": os.path.join(ds.dir, c, "InstanceImage",
                                    f"{i:04d}.png"),
                "proj/hf": os.path.join(ds.dir, c, "Projection",
                                        "REST-TD_HF.png"),
                "proj/seg": os.path.join(ds.dir, c, "Projection",
                                         "REST-SEG.png"),
                "pts": os.path.join(ds.dir, c, "Points", f"{i:04d}.pkl"),
            }
            for c in cities
            for i in range(ds.n_views)
        ]
        if ds.pin_memory:
            self.pin_memory(files, ds.pin_memory)
        # val split: the views ending in 00 (upstream :317-321)
        self.renderings = (files if split == "train" else
                           [f for f in files if f["name"].endswith("00")])


class Kitti360Dataset(Dataset):
    """(upstream utils/datasets.py:324-403)"""

    def __init__(self, cfg: Config, split: str):
        super().__init__(cfg, split)
        ds = self.ds
        import json

        view_idx = {}
        if ds.view_index_file and os.path.exists(ds.view_index_file):
            with open(ds.view_index_file) as fp:
                view_idx = json.load(fp)
        elif os.path.isdir(ds.dir):
            for c in sorted(os.listdir(ds.dir)):
                pts_dir = os.path.join(ds.dir, c, "Points")
                if os.path.isdir(pts_dir):
                    view_idx[c] = [int(f[:-4])
                                   for f in sorted(os.listdir(pts_dir))]
        files = [
            {
                "name": f"{c}/{f:010d}",
                "Rt": os.path.join(ds.dir, c, "CameraPoses.csv"),
                "centers": os.path.join(ds.dir, c, "CENTERS.pkl"),
                "rgb": os.path.join(ds.dir, c, "footage", f"{f:010d}.png"),
                "ins": os.path.join(ds.dir, c, "InstanceImage",
                                    f"{f:010d}.png"),
                "proj/hf": os.path.join(ds.dir, c, "Projection",
                                        "REST-TD_HF.png"),
                "proj/seg": os.path.join(ds.dir, c, "Projection",
                                         "REST-SEG.png"),
                "pts": os.path.join(ds.dir, c, "Points", f"{f:010d}.pkl"),
            }
            for c, v in view_idx.items()
            for f in v
        ]
        if ds.pin_memory:
            self.pin_memory(files, ds.pin_memory)
        # val: every 1000th view (upstream :399-403)
        self.renderings = (files if split == "train" else
                           [f for i, f in enumerate(files) if i % 1000 == 0])


class SyntheticDataset(Dataset):
    """Procedural city crops, no download (the JAX package's
    ``SyntheticDataset``): random BEV maps of four box buildings on a road
    (64 x 64), extruded with ``ops.extrusion.extrude_points_np``, and the
    same item dict as the real datasets."""

    def __init__(self, cfg: Config, split: str, n_items: int = 8,
                 seed: int = 0):
        super().__init__(cfg, split)
        self.n_items = n_items
        self.seed = seed
        self.renderings = [{"name": f"synthetic/{i:02d}"}
                           for i in range(n_items)]

    def load_raw(self, idx: int) -> Dict[str, np.ndarray]:
        from gaussiancity_tpu_torch.data.dataset_generator import (
            class_scale_table)
        from gaussiancity_tpu_torch.ops.extrusion import (
            SegInsRelation, extrude_points_np)

        ds = self.ds
        rng = np.random.default_rng(self.seed * 1000 + idx)
        W, H = ds.sensor_size
        P = 64
        ins = np.ones((P, P), np.int32)
        for b in range(4):
            x0, y0 = rng.integers(4, P - 20, 2)
            w0, h0 = rng.integers(6, 14, 2)
            ins[y0: y0 + h0, x0: x0 + w0] = 100 + 2 * b
        td = np.where(ins >= 100, rng.integers(8, 24), 2).astype(np.int32)
        bu = np.zeros((P, P), np.int32)
        ptsm = np.ones((P, P), bool)
        pts5 = extrude_points_np(ins, td, bu, ptsm, SegInsRelation(),
                                 class_scale_table("GOOGLE_EARTH"))
        n = len(pts5)
        centers = {
            int(i): (float(P / 2), float(P / 2), float(P), float(P), 24.0)
            for i in np.unique(np.concatenate([ins.reshape(-1),
                                               pts5[:, 4]]))
        }
        vpm = rng.integers(0, n, (H, W)).astype(np.int64)
        msk = np.ones((H, W), bool)
        rgb = rng.uniform(-1, 1, (H, W, 3)).astype(np.float32)
        ins_px = ins[np.clip(vpm % P, 0, P - 1),
                     np.clip(vpm // P % P, 0, P - 1)]
        return {
            "cam_pos": np.array([-40.0, P / 2, 12.0], np.float32),
            "cam_quat": np.array([0, 0, 0, 1.0], np.float32),
            "centers": centers,
            "rgb": rgb,
            "seg": instances_to_classes_np(ins_px, ds).astype(np.int32),
            "ins": ins_px.astype(np.int64),
            "proj/hf": td.astype(np.float32),
            "proj/seg": instances_to_classes_np(ins, ds).astype(np.int32),
            "vpm": vpm,
            "msk": msk,
            "pts": pts5.astype(np.int64),
        }


DATASETS = {
    "GOOGLE_EARTH": GoogleEarthDataset,
    "KITTI_360": Kitti360Dataset,
    "SYNTHETIC": SyntheticDataset,
}


def get_dataset(cfg: Config, name: str, split: str) -> Dataset:
    """(upstream utils/datasets.py:22-28)"""
    if name not in DATASETS:
        raise ValueError(f"Unknown dataset: {name}")
    if cfg.memcached.enabled and IO._cache is None:
        raise NotImplementedError(
            "the PyTorch port has no memcached client yet: install a byte "
            "cache with data.io.IO.configure_cache, or set "
            "memcached.enabled False")
    return DATASETS[name](cfg, split)


def _dist_rank_world() -> tuple:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class DataLoader:
    """Multi-epoch host loader: per-epoch shuffled order shared by every
    rank (seed + epoch), items ``rank::world`` of it cut to
    ``len(dataset) // world`` so that every rank takes ``len(self)``
    batches, batches of ``batch_size`` stacked along a new first axis, the
    ragged tail dropped (upstream's drop_last sampler).  ``num_workers`` threads load items
    ahead of the step, at most ``prefetch`` batches in flight; batches come
    out in order whatever the workers' completion order."""

    def __init__(self, dataset: Dataset, batch_size: int = 1,
                 shuffle: bool = True, seed: int = 0,
                 rank: Optional[int] = None, world_size: Optional[int] = None,
                 num_workers: int = 8, prefetch: int = 8):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.prefetch = max(1, prefetch)
        d_rank, d_world = _dist_rank_world()
        self.rank = rank if rank is not None else d_rank
        self.world_size = world_size if world_size is not None else d_world

    def __len__(self):
        return len(self.dataset) // self.world_size // self.batch_size

    def _batch_starts(self, epoch_idx: int):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + epoch_idx).shuffle(order)
        # every rank takes the same count, len(self) batches
        local = order[self.rank:: self.world_size][
            : len(order) // self.world_size]
        return local, range(0, len(local) - self.batch_size + 1,
                            self.batch_size)

    def _item(self, epoch_idx: int, j: int):
        rng = (np.random.default_rng((self.seed, epoch_idx, j))
               if self.dataset.split == "train" else None)
        return self.dataset.get(j, rng)

    def _load_batch(self, epoch_idx: int, local, start: int
                    ) -> Dict[str, np.ndarray]:
        items = [self._item(epoch_idx, int(j))
                 for j in local[start: start + self.batch_size]]
        return {k: np.stack([it[k] for it in items]) for k in items[0]}

    def epoch(self, epoch_idx: int) -> Iterator[Dict[str, np.ndarray]]:
        local, starts = self._batch_starts(epoch_idx)
        if self.num_workers <= 0:
            for i in starts:
                yield self._load_batch(epoch_idx, local, i)
            return
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            pending = deque()
            it = iter(starts)
            for i in it:
                pending.append(pool.submit(self._load_batch, epoch_idx,
                                           local, i))
                if len(pending) >= self.prefetch:
                    break
            while pending:
                batch = pending.popleft().result()
                nxt = next(it, None)
                if nxt is not None:
                    pending.append(pool.submit(self._load_batch, epoch_idx,
                                               local, nxt))
                yield batch
