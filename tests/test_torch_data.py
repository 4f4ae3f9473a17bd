# -*- coding: utf-8 -*-
"""PyTorch port vs the JAX package: the data layer (file reads, the
transforms, the synthetic dataset, the loader), the host helpers and the
logging utilities; and the port's training loop on the CPU: two epochs
straight end with the weights of one epoch, a resume and one more."""

import functools
import json
import os
import pickle

import numpy as np
import pytest
import torch

from gaussiancity_tpu.config import bldg_recipe as jbldg_recipe
from gaussiancity_tpu.config import rest_recipe as jrest_recipe
from gaussiancity_tpu.data import datasets as jdatasets
from gaussiancity_tpu.data.io import IO as JIO
from gaussiancity_tpu.utils import helpers as jhelpers
from gaussiancity_tpu.utils.average_meter import AverageMeter as JMeter

from gaussiancity_tpu_torch import config as C
from gaussiancity_tpu_torch.config import (
    Config, DatasetConfig, DiscriminatorOptim, GaussianNetworkConfig,
    PTv3Config, RasterizerConfig, TrainConfig)
from gaussiancity_tpu_torch.data import datasets
from gaussiancity_tpu_torch.data.io import IO
from gaussiancity_tpu_torch.data.memcache import MemcachedClient
from gaussiancity_tpu_torch.training import checkpoint
from gaussiancity_tpu_torch.training.train import train
from gaussiancity_tpu_torch.utils import helpers
from gaussiancity_tpu_torch.utils.average_meter import AverageMeter
from gaussiancity_tpu_torch.utils.summary_writer import SummaryWriter
from gaussiancity_tpu_torch.testing import share_cpu_cores

share_cpu_cores()

RECIPES = {"REST": jrest_recipe, "BLDG": jbldg_recipe}


def _recipe_pair(name):
    """A recipe of the JAX package on the synthetic dataset, and the same
    config in the port."""
    jcfg = RECIPES[name]()
    jcfg = jcfg.replace(dataset=jcfg.dataset.replace(name="SYNTHETIC",
                                                     pin_memory=()))
    return jcfg, Config.from_dict(jcfg.to_dict())


class TestSyntheticBatches:
    @pytest.mark.parametrize("split", ["train", "val"])
    @pytest.mark.parametrize("recipe", ["REST", "BLDG"])
    def test_items_equal_jax(self, recipe, split):
        """The same item and generator seed give the same arrays in both
        packages, at the recipe's crops and instance ranges."""
        jcfg, cfg = _recipe_pair(recipe)
        jds = jdatasets.SyntheticDataset(jcfg, split, n_items=3, seed=2)
        ds = datasets.SyntheticDataset(cfg, split, n_items=3, seed=2)
        assert len(ds) == len(jds) == 3
        Wc, Hc = (cfg.dataset.train_crop_size if split == "train"
                  else cfg.dataset.test_crop_size)
        for i in range(2):
            want = jds.pipeline(jds.load_raw(i),
                                np.random.default_rng(40 + i))
            got = ds.get(i, np.random.default_rng(40 + i))
            if split == "val":  # seeded by the item, as the JAX one is
                want_default = jds[i]
                for k in want_default:
                    np.testing.assert_array_equal(ds[i][k], want_default[k])
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            assert got["rgb"].shape == (Hc, Wc, 3)
            assert got["pts"].shape == (cfg.train.max_points, 9)
            assert got["pts_mask"].sum() > 0 and got["msk"].sum() > 0

    def test_get_dataset(self):
        _, cfg = _recipe_pair("REST")
        assert isinstance(datasets.get_dataset(cfg, "SYNTHETIC", "val"),
                          datasets.SyntheticDataset)
        with pytest.raises(ValueError):
            datasets.get_dataset(cfg, "NOPE", "train")
        mc = cfg.replace(memcached=cfg.memcached.replace(enabled=True))
        try:
            datasets.get_dataset(mc, "SYNTHETIC", "train")
            assert isinstance(IO._cache, MemcachedClient)
        finally:
            IO.configure_cache(None)
        ds = datasets.get_dataset(cfg, "GOOGLE_EARTH", "train")
        assert len(ds) == 0 and ds.get_K().shape == (3, 3)


class TestDataLoader:
    def test_order_and_sharding_by_rank(self):
        _, cfg = _recipe_pair("REST")
        cfg = cfg.replace(dataset=cfg.dataset.replace(
            sensor_size=(256, 64), train_crop_size=(128, 32),
            test_crop_size=(128, 32), train_min_pixels=4),
            train=cfg.train.replace(max_points=64))
        jcfg = jdatasets.Config.from_dict(cfg.to_dict())
        val = datasets.SyntheticDataset(cfg, "val", n_items=7)
        jval = jdatasets.SyntheticDataset(jcfg, "val", n_items=7)
        seen = []
        for rank in (0, 1):
            loader = datasets.DataLoader(val, batch_size=1, shuffle=True,
                                         seed=3, rank=rank, world_size=2,
                                         num_workers=2, prefetch=2)
            jloader = jdatasets.DataLoader(jval, batch_size=1, shuffle=True,
                                           seed=3, process_index=rank,
                                           process_count=2, num_workers=0)
            assert len(loader) == len(jloader) == 3
            got, want = list(loader.epoch(1)), list(jloader.epoch(1))
            # every rank takes len(loader) batches (the JAX loader gives
            # rank 0 a fourth); the first three are the JAX loader's
            assert len(got) == 3
            for a, b in zip(got, want):
                for k in b:
                    np.testing.assert_array_equal(a[k], b[k])
            local, _ = loader._batch_starts(1)
            seen += list(local)
        assert len(set(seen)) == 6 and set(seen) <= set(range(7))
        # train items: their generator seeded by (seed, epoch, item)
        ds = datasets.SyntheticDataset(cfg, "train", n_items=4)
        loader = datasets.DataLoader(ds, batch_size=2, seed=5, rank=0,
                                     world_size=1, num_workers=0)
        local, _ = loader._batch_starts(2)
        batch = next(iter(loader.epoch(2)))
        for row, j in enumerate(local[:2]):
            item = ds.get(int(j), np.random.default_rng((5, 2, int(j))))
            for k in item:
                np.testing.assert_array_equal(batch[k][row], item[k])
        again = next(iter(datasets.DataLoader(
            ds, batch_size=2, seed=5, rank=0, world_size=1,
            num_workers=3).epoch(2)))
        for k in batch:
            np.testing.assert_array_equal(again[k], batch[k])

    def test_rank_from_torch_distributed(self, tmp_path):
        import torch.distributed as dist

        _, cfg = _recipe_pair("REST")
        ds = datasets.SyntheticDataset(cfg, "val", n_items=4)
        plain = datasets.DataLoader(ds)
        assert (plain.rank, plain.world_size) == (0, 1)
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                                rank=0, world_size=1)
        try:
            loader = datasets.DataLoader(ds, rank=None, world_size=None)
            assert (loader.rank, loader.world_size) == (0, 1)
            assert datasets.DataLoader(ds, world_size=4).world_size == 4
        finally:
            dist.destroy_process_group()


def tiny_train_cfg(kind: str, out_dir: str) -> Config:
    """The JAX suite's smoke config (tests/test_pipeline.py) for REST, or
    the same with a tiny PTv3 BLDG generator and the BLDG instance
    range."""
    ds = DatasetConfig(
        name="SYNTHETIC", sensor_size=(256, 64), train_crop_size=(128, 32),
        test_crop_size=(128, 32), train_min_pixels=4, n_classes=8,
        proj_size=64, map_size=0,
        cam_k=(100.0, 0, 128.0, 0, 100.0, 32.0, 0, 0, 1), pin_memory=())
    net = GaussianNetworkConfig(
        scale_factor=0.5, encoder="GLOBAL", encoder_out_dim=5,
        global_encoder_n_blocks=2, pos_emd="HASH_GRID",
        hash_grid_n_levels=4, hash_grid_level_dim=4, hash_grid_map_size=10,
        mlp_hidden_dim=32, dis_n_channel_base=8,
        ptv3=PTv3Config(enabled=False))
    if kind == "BLDG":
        ds = ds.replace(train_n_instances=1, train_instance_range=(10, 16384),
                        test_n_instances=1, test_instance_range=(10, 16384))
        net = net.replace(
            scale_factor=0.65, encoder=None, encoder_out_dim=3,
            pos_emd="SIN_COS", sin_cos_freq_bends=4, z_dim=16,
            ptv3=PTv3Config(
                stride=(2, 2), enc_depths=(1, 1, 1),
                enc_channels=(8, 16, 32), enc_n_head=(1, 2, 4),
                enc_patch_size=(32, 32, 32), dec_depths=(1, 1),
                dec_channels=(8, 16), dec_n_head=(1, 2),
                dec_patch_size=(32, 32), mlp_ratio=2.0))
    return Config(
        exp_name=f"smoke_{kind}", dataset=ds, network=net,
        rasterizer=RasterizerConfig(tile_capacity=128),
        train=TrainConfig(
            n_epochs=2, max_points=256, log_freq=2, ckpt_save_freq=1,
            perceptual_loss_layers=("relu_1_1",),
            perceptual_loss_weights=(1.0,), n_workers=2, prefetch_batches=2,
            discriminator=DiscriminatorOptim(n_warmup_iters=2)),
        test=C.TestConfig(test_freq=1), output_dir=out_dir)


class TestTrainLoop:
    @pytest.mark.parametrize("kind", ["REST", "BLDG"])
    def test_resume_gives_the_weights_of_a_straight_run(self, kind,
                                                        tmp_path,
                                                        monkeypatch):
        monkeypatch.setitem(datasets.DATASETS, "SYNTHETIC", functools.partial(
            datasets.SyntheticDataset, n_items=2))
        straight_cfg = tiny_train_cfg(kind, str(tmp_path / "straight"))
        straight = train(straight_cfg, device="cpu")
        assert straight.step == 4
        ckpt_dir = tmp_path / "straight" / "ckpt" / straight_cfg.exp_name
        assert checkpoint.latest_epoch(str(ckpt_dir)) == 2
        log_dir = tmp_path / "straight" / "logs" / straight_cfg.exp_name
        rows = [json.loads(line) for line in
                (log_dir / "scalars.jsonl").read_text().splitlines()]
        assert any("Loss/Epoch/L1Loss/Val" in r for r in rows)
        assert any(r.get("Raster/Batch/PTv3PoolOverflow") == 0 for r in rows)
        assert len(os.listdir(log_dir / "images")) == 4  # 2 val x 2 epochs

        cfg = tiny_train_cfg(kind, str(tmp_path / "resumed"))
        train(cfg.replace(train=cfg.train.replace(n_epochs=1)), device="cpu")
        resumed_dir = tmp_path / "resumed" / "ckpt" / cfg.exp_name
        assert checkpoint.latest_epoch(str(resumed_dir)) == 1
        resumed = train(cfg, resume_from=str(resumed_dir), device="cpu")
        assert resumed.step == 4
        assert checkpoint.latest_epoch(str(resumed_dir)) == 2
        want, got = straight.state_dict(), resumed.state_dict()
        for part in ("generator", "discriminator", "ploss"):
            assert want[part].keys() == got[part].keys()
            for k, v in want[part].items():
                assert torch.equal(got[part][k], v), f"{part} {k}"
        for part in ("g_opt", "d_opt"):
            for pid, s in want[part]["state"].items():
                for k, v in s.items():
                    assert torch.equal(got[part]["state"][pid][k], v), part

    def test_max_steps_stops_and_saves(self, tmp_path, monkeypatch):
        monkeypatch.setitem(datasets.DATASETS, "SYNTHETIC", functools.partial(
            datasets.SyntheticDataset, n_items=3))
        cfg = tiny_train_cfg("REST", str(tmp_path))
        t = train(cfg, max_steps=2, device="cpu")
        assert t.step == 2
        ckpt_dir = str(tmp_path / "ckpt" / cfg.exp_name)
        assert checkpoint.latest_epoch(ckpt_dir) == 1
        with pytest.raises(FileNotFoundError):
            checkpoint.restore_checkpoint(str(tmp_path / "none"), t)


class TestFileReads:
    def test_reads_equal_jax_and_cache_hook(self, tmp_path):
        from PIL import Image

        rng = np.random.default_rng(0)
        files = {
            "a.npy": rng.normal(size=(3, 4)),
            "b.pkl": {"pts": rng.integers(0, 9, (5, 5))},
            "c.json": {"x": [1, 2]},
            "d.png": rng.integers(0, 255, (6, 7, 3)).astype(np.uint8),
        }
        np.save(tmp_path / "a.npy", files["a.npy"])
        with open(tmp_path / "b.pkl", "wb") as f:
            pickle.dump(files["b.pkl"], f)
        (tmp_path / "c.json").write_text(json.dumps(files["c.json"]))
        Image.fromarray(files["d.png"]).save(tmp_path / "d.png")
        (tmp_path / "e.csv").write_text("id,tx,ty\n0,1.5,2\n3,4,5.25\n")
        for name in ("a.npy", "b.pkl", "c.json", "d.png", "e.csv"):
            path = str(tmp_path / name)
            got, want = IO.get(path), JIO.get(path)
            if name.endswith((".npy", ".png")):
                np.testing.assert_array_equal(np.asarray(got),
                                              np.asarray(want))
            elif name == "b.pkl":
                np.testing.assert_array_equal(got["pts"], want["pts"])
            else:
                assert got == want
        assert IO.get(str(tmp_path / "e.csv"))[3] == {"tx": 4.0, "ty": 5.25}
        with pytest.raises(ValueError):
            IO.get(str(tmp_path / "x.bin"))

        class DictCache:
            def __init__(self):
                self.blobs = {}

            def get_file(self, path):
                return self.blobs.get(path)

            def set_file(self, path, blob):
                self.blobs[path] = blob

        cache = DictCache()
        IO.configure_cache(cache)
        try:
            path = str(tmp_path / "a.npy")
            first = IO.get(path)
            assert path in cache.blobs
            os.remove(path)  # the second read comes from the cache
            np.testing.assert_array_equal(IO.get(path), first)
        finally:
            IO.configure_cache(None)


class TestHostHelpers:
    def test_palettes_and_instance_codes_equal_jax(self):
        np.testing.assert_array_equal(helpers.get_seg_map_palette(),
                                      jhelpers.get_seg_map_palette())
        for random in (True, False):
            np.testing.assert_array_equal(
                helpers.get_ins_seg_map_palette(
                    helpers.get_seg_map_palette(), random, seed=3),
                jhelpers.get_ins_seg_map_palette(
                    jhelpers.get_seg_map_palette(), random, seed=3))
        ids = np.random.default_rng(1).integers(0, 20000, (5, 6))
        np.testing.assert_array_equal(helpers.get_ins_colors(ids),
                                      jhelpers.get_ins_colors(ids))
        img = np.random.default_rng(2).integers(0, 256, (4, 5, 3))
        np.testing.assert_array_equal(helpers.get_ins_id(img),
                                      jhelpers.get_ins_id(img))

    def test_tensor_helpers_equal_jax(self, tmp_path):
        import jax.numpy as jnp

        rng = np.random.default_rng(3)
        pts = rng.normal(size=(2, 5, 3)).astype(np.float32)
        np.testing.assert_array_equal(
            helpers.repeat_pts(torch.from_numpy(pts), 3).numpy(),
            np.asarray(jhelpers.repeat_pts(jnp.asarray(pts), 3)))
        onehot = rng.random((2, 4, 4, 6)).astype(np.float32)
        np.testing.assert_array_equal(
            helpers.onehot_to_mask(torch.from_numpy(onehot), (2, 4)).numpy(),
            np.asarray(jhelpers.onehot_to_mask(jnp.asarray(onehot), (2, 4))))
        chw = rng.uniform(-1, 1, (3, 4, 5)).astype(np.float32)
        np.testing.assert_array_equal(
            helpers.tensor_to_image(torch.from_numpy(chw), "RGB"),
            jhelpers.tensor_to_image(chw, "RGB"))
        np.testing.assert_array_equal(
            helpers.get_camera_look_at([1, 2, 3], [0, 0, 0.6, 0.8], 10),
            jhelpers.get_camera_look_at([1, 2, 3], [0, 0, 0.6, 0.8], 10))
        xyz = rng.uniform(0, 50, (6, 3))
        rgb = rng.integers(0, 255, (6, 3))
        attrs = {"opacity": rng.random(6)}
        helpers.dump_ptcloud_ply(str(tmp_path / "a.ply"), xyz, rgb, attrs)
        jhelpers.dump_ptcloud_ply(str(tmp_path / "b.ply"), xyz, rgb, attrs)
        assert ((tmp_path / "a.ply").read_text()
                == (tmp_path / "b.ply").read_text())

    def test_meter_and_writer(self, tmp_path):
        for items in (None, ["a", "b"]):
            m, jm = AverageMeter(items), JMeter(items)
            for v in ([1.0, 2.0], [4.0, 8.0]):
                arg = v if items else v[0]
                m.update(arg)
                jm.update(arg)
            assert (m.val(), m.avg(), m.count()) == (jm.val(), jm.avg(),
                                                     jm.count())
        assert m.as_dict() == {"a": 2.5, "b": 5.0}
        w = SummaryWriter(str(tmp_path), "exp")
        w.add_config({"k": 1})
        w.add_scalars({"x": 1.5}, 3)
        w.add_images({"Images/a": np.zeros((4, 5, 3))}, 3)
        w.close()
        log = tmp_path / "logs" / "exp"
        row = json.loads((log / "scalars.jsonl").read_text())
        assert row["step"] == 3 and row["x"] == 1.5
        assert json.loads((log / "config.json").read_text()) == {"k": 1}
        assert len(os.listdir(log / "images")) == 1
