# -*- coding: utf-8 -*-
"""The port's command line (``python3 -m gaussiancity_tpu_torch``,
``gaussiancity_tpu_torch/run.py``) and its checkpoint loader
(``inference/loader.py``): the JAX ``run.py``'s flags and defaults, the
refusals (malformed multi-process flags, no card), data-parallel training
on two CPU processes, train and ``--test`` on a city the port generated, and ``--inference`` against the JAX ``run.run_inference``,
each package reading its own checkpoints of the same weights.

The inference reference is the JAX pipeline with its visible points and
road mask taken from the corrected raycast of
``test_torch_dataset_generator.exact_visible_from_volume``: the orbit of
two frames looks along the map's axes, where the JAX march's near-axis
fault shows (ROADMAP Queue 3); it also takes the points straight from the
point map, as ``test_torch_pipeline._JaxPipelineExactIds`` does."""

import argparse
import importlib.util
import json
import os
import re
import socket
import subprocess
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiancity_tpu.inference import pipeline as jpipeline
from gaussiancity_tpu.training import checkpoint as jckpt

from gaussiancity_tpu_torch import config as C
from gaussiancity_tpu_torch import run
from gaussiancity_tpu_torch.data import dataset_generator as dg
from gaussiancity_tpu_torch.inference import loader
from gaussiancity_tpu_torch.inference import pipeline
from gaussiancity_tpu_torch.training import checkpoint
from gaussiancity_tpu_torch.training import orbax_reader
from gaussiancity_tpu_torch.testing import share_cpu_cores

from test_dataset_generator import synthetic_city
from test_inference import synthetic_projections
from test_torch_dataset_generator import (_poses, exact_visible_from_volume,
                                          record_calls)
from test_torch_pipeline import bldg_pair, rest_pair  # noqa: F401 fixtures

share_cpu_cores()

ROOT = Path(__file__).resolve().parents[1]


def _jax_run():
    """The repository's JAX ``run.py`` as a module."""
    spec = importlib.util.spec_from_file_location("jax_run", ROOT / "run.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_args(monkeypatch, argv):
    """(the JAX ``get_args()`` namespace for ``argv``, its parser)."""
    mod = _jax_run()
    seen = []
    parse = argparse.ArgumentParser.parse_args
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args",
                        lambda self, *a, **k: (seen.append(self),
                                               parse(self, *a, **k))[1])
    monkeypatch.setattr("sys.argv", ["run.py", *argv])
    args = mod.get_args()
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse)
    return mod, args, seen[0]


def _actions(parser):
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_parser_takes_the_jax_flags(monkeypatch):
    _, jargs, jparser = _jax_args(monkeypatch, [])
    want, got = _actions(jparser), _actions(run.build_parser())
    assert set(got) == set(want) | {"device"}
    for dest, a in want.items():
        b = got[dest]
        assert b.option_strings == a.option_strings, dest
        assert type(b) is type(a), dest
        for attr in ("default", "type", "choices", "nargs", "const"):
            assert getattr(b, attr) == getattr(a, attr), (dest, attr)
    targs = vars(run.get_args([]))
    assert targs.pop("device") == "cuda"
    assert targs == vars(jargs)
    assert got["device"].option_strings == ["--device"]


def test_config_follows_the_jax_run(tmp_path, monkeypatch):
    """Recipe, then ``-c`` in its place, then ``-e`` and ``-d``."""
    path = tmp_path / "cfg.json"
    path.write_text(C.bldg_recipe().replace(exp_name="FromFile").to_json())
    cfg = run.get_config(run.get_args(["-r", "rest", "-c", str(path), "-e",
                                       "Mine", "-d", "SYNTHETIC"]))
    assert cfg.exp_name == "Mine" and cfg.network.ptv3.enabled
    assert cfg.dataset.name == "SYNTHETIC"
    cfg = run.get_config(run.get_args(["-r", "bldg", "-d", "KITTI_360"]))
    assert cfg.dataset == C.kitti_360_dataset()
    assert cfg.network == C.bldg_recipe().network
    assert run.get_config(run.get_args(["-r", "car"])) == C.car_recipe()


def test_refusals(monkeypatch):
    """Several processes without a rendezvous or with an out-of-range
    rank, inference on several processes, and no card."""
    for argv, what in ((["--num-processes", "2"], "--coordinator"),
                       (["--num-processes", "2", "--coordinator", "h:1",
                         "--process-id", "2"], "process id"),
                       (["--inference", "--num-processes", "2"],
                        "one process")):
        with pytest.raises(ValueError, match=what):
            run.main(argv + ["--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--test", "-p", "x"], ["--inference", "-p", "x"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            run.main(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        loader.load_generator("x")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_train_on_the_cpu(tmp_path):
    """``--num-processes 2`` with ``--device cpu``: two gloo ranks train
    the tiny REST widths on the synthetic dataset, rank 0 alone writes the
    checkpoint, and both ranks log the digest of the checkpoint's state."""
    from gaussiancity_tpu_torch.training.step import Trainer
    from test_torch_data import tiny_train_cfg

    cfg = tiny_train_cfg("REST", str(tmp_path / "out")).replace(
        exp_name="ddp")
    cfg_path = tmp_path / "tiny.json"
    cfg_path.write_text(cfg.to_json())
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "gaussiancity_tpu_torch", "-r", "rest",
         "-c", str(cfg_path), "-d", "SYNTHETIC", "--max-steps", "2",
         "--device", "cpu", "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", "2", "--process-id", str(r)],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, log[-3000:]
        assert "backend gloo" in log, log[-3000:]
    digests = [re.search(r"replica digest (\w+)", log).group(1)
               for log in logs]
    ckpt_dir = tmp_path / "out" / "ckpt" / "ddp"
    assert [f.name for f in ckpt_dir.iterdir()] == ["epoch-00001.pt"]
    t = Trainer(cfg, device="cpu")
    checkpoint.restore_checkpoint(str(ckpt_dir), t)
    assert t.step == 2
    assert digests == [checkpoint.state_digest(t)] * 2


def _tiny_ge_cfg(root: str, out_dir: str) -> C.Config:
    """The tiny REST widths of the training tests on a generated Google
    Earth city: its 960x540 views, a 128-pixel projection window."""
    net = C.GaussianNetworkConfig(
        scale_factor=0.5, encoder="GLOBAL", encoder_out_dim=5,
        global_encoder_n_blocks=2, pos_emd="HASH_GRID",
        hash_grid_n_levels=4, hash_grid_level_dim=4, hash_grid_map_size=10,
        mlp_hidden_dim=32, dis_n_channel_base=8,
        ptv3=C.PTv3Config(enabled=False))
    return C.Config(
        exp_name="cli", output_dir=out_dir,
        dataset=C.DatasetConfig(
            dir=root, n_cities=1, n_views=2, train_crop_size=(128, 64),
            test_crop_size=(128, 64), train_min_pixels=1, proj_size=128,
            map_size=0),
        network=net, rasterizer=C.RasterizerConfig(tile_capacity=128),
        train=C.TrainConfig(
            n_epochs=1, max_points=1024, log_freq=1, ckpt_save_freq=1,
            allow_random_vgg=True, perceptual_loss_layers=("relu_1_1",),
            perceptual_loss_weights=(1.0,), n_workers=2, prefetch_batches=2,
            discriminator=C.DiscriminatorOptim(n_warmup_iters=1)),
        test=C.TestConfig(test_freq=1))


def test_train_and_test_modes_on_a_generated_city(tmp_path, monkeypatch,
                                                  caplog):
    from PIL import Image

    monkeypatch.setitem(dg.CONSTANTS["GOOGLE_EARTH"], "PROJECTION_SIZE", 128)
    city = tmp_path / "data" / "City"
    (city / "footage").mkdir(parents=True)
    dg.dump_projections(synthetic_city(str(tmp_path / "maps")),
                        str(city / "Projection"))
    dg.save_camera_poses(str(city / "CameraPoses.csv"), _poses())
    dg.generate_city("GOOGLE_EARTH", str(city), vol_shape=(128, 128, 48),
                     device="cpu")
    rng = np.random.default_rng(0)
    for i in range(2):
        Image.fromarray(rng.integers(0, 255, (540, 960, 3), np.uint8)).save(
            city / "footage" / f"City_{i:02d}.jpeg")
    cfg_path = tmp_path / "tiny.json"
    cfg_path.write_text(_tiny_ge_cfg(str(tmp_path / "data"),
                                     str(tmp_path / "out")).to_json())

    common = ["-r", "rest", "-d", "GOOGLE_EARTH", "-c", str(cfg_path),
              "--device", "cpu"]
    with caplog.at_level("INFO"):
        assert run.main(common + ["-e", "cli", "--max-steps", "2",
                                  "--run-id", "abc"]) == 0
    assert "--run-id abc has no effect" in caplog.text
    ckpt_dir = tmp_path / "out" / "ckpt" / "cli"
    assert checkpoint.latest_epoch(str(ckpt_dir)) == 1
    with open(tmp_path / "out" / "logs" / "cli" / "scalars.jsonl") as f:
        rows = [json.loads(line) for line in f]
    losses = [r["Loss/Batch/GenLoss"] for r in rows
              if "Loss/Batch/GenLoss" in r]
    assert len(losses) == 2 and np.isfinite(losses).all()
    for name in ("RasterDroppedPairs", "RasterTruncated",
                 "RasterGradTruncated", "PTv3PoolOverflow"):
        assert all(r[f"Raster/Batch/{name}"] == 0 for r in rows
                   if f"Raster/Batch/{name}" in r), name
    val = [r["Loss/Epoch/L1Loss/Val"] for r in rows
           if "Loss/Epoch/L1Loss/Val" in r]
    assert len(val) == 1 and np.isfinite(val[0])

    caplog.clear()
    with caplog.at_level("INFO"):
        assert run.main(common + ["--test", "-p", str(ckpt_dir)]) == 0
    assert "[Val][Epoch 1] L1Loss" in caplog.text

    # the loader takes the generator of the trained checkpoint, in eval
    # mode, and leaves the optimiser state on the host
    cfg, gen, z_bank = loader.load_generator(str(ckpt_dir), device="cpu")
    saved = torch.load(checkpoint.epoch_path(str(ckpt_dir), 1),
                       weights_only=True)["state"]["generator"]
    assert cfg.exp_name == "cli" and z_bank is None and not gen.training
    state = gen.state_dict()
    assert state.keys() == saved.keys()
    assert all(torch.equal(state[k], saved[k]) for k in saved)


class _JaxPipelineCorrected(jpipeline.InferencePipeline):
    """The JAX pipeline with its visible points and road mask taken from
    the corrected raycast; everything else is the JAX package's code."""

    def visible_points(self, points, cam_pos, cam_quat):
        super().visible_points(points, cam_pos, cam_quat)  # the volume
        W, H = self.ds.sensor_size
        K = np.asarray(self.ds.cam_k).reshape(3, 3)
        mins = points[:, :3].min(0)
        offsets = np.array([mins[0], mins[1], mins[2] - 1], np.int32)
        vp, ins = exact_visible_from_volume(
            self._vol, self._pts_dev, jnp.asarray(cam_pos, jnp.float32),
            jnp.asarray(cam_quat, jnp.float32), float(K[0, 0]),
            (float(K[1, 2]), float(K[0, 2])), (H, W), jnp.asarray(offsets),
            occupancy=self._occ)
        return points[np.unique(vp[vp >= 0])], jnp.asarray(ins == 1)


def _inference_checkpoints(rest_pair, bldg_pair, tmp_path):
    """The REST and BLDG generators of the pipeline tests saved by each
    package (``jax_rest`` / ``jax_bldg``: Orbax, ``port_rest`` /
    ``port_bldg``: the port's files), a city and the CLI's frame flags."""
    from gaussiancity_tpu.config import Config as JConfig

    cfg, tcfg, gen, params, tgen = rest_pair
    bgen, bvars, tbgen, z_dim = bldg_pair
    jbcfg = JConfig(dataset=cfg.dataset, network=bgen.cfg,
                    rasterizer=cfg.rasterizer)
    jckpt.save_checkpoint(str(tmp_path / "jax_rest"), 0,
                          {"g_params": params}, cfg)
    jckpt.save_checkpoint(str(tmp_path / "jax_bldg"), 0,
                          {"g_params": bvars["params"],
                           "g_stats": bvars["batch_stats"]}, jbcfg)
    for name, jc, module in (("rest", cfg, tgen), ("bldg", jbcfg, tbgen)):
        checkpoint.save_epoch(
            str(tmp_path / f"port_{name}"), 1, types.SimpleNamespace(
                cfg=C.Config.from_dict(jc.to_dict()),
                state_dict=lambda m=module: {"generator": m.state_dict()}))
    city = tmp_path / "City"
    dg.dump_projections(synthetic_projections(cfg.dataset.proj_size),
                        str(city / "Projection"))
    return ["--city-dir", str(city), "--frames", "2", "--radius", "30",
            "--altitude", "30", "--max-points", "2048"]


def test_inference_matches_jax(rest_pair, bldg_pair, tmp_path, monkeypatch):
    """REST + BLDG from checkpoints, two orbit frames, both packages'
    CLIs: the frames before encoding agree to the pipeline tests'
    tolerance, and the port writes the video and the jpgs."""
    flags = _inference_checkpoints(rest_pair, bldg_pair, tmp_path)

    jfloat, jframes = [], []

    class Recording(_JaxPipelineCorrected):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            to_u8 = self.frame_to_uint8
            self.frame_to_uint8 = lambda img: (
                jfloat.append(np.asarray(img)), to_u8(img))[1]

    monkeypatch.setattr(jpipeline, "InferencePipeline", Recording)
    record_calls(monkeypatch, Recording, "render_trajectory", jframes)
    jrun, jargs, _ = _jax_args(monkeypatch, ["--inference", "--ckpt-rest",
                                             str(tmp_path / "jax_rest"),
                                             "--ckpt-bldg",
                                             str(tmp_path / "jax_bldg"),
                                             "--output",
                                             str(tmp_path / "jax.mp4"),
                                             *flags])
    assert jrun.run_inference(jargs) == 0

    tfloat, tframes = [], []
    u8 = pipeline.frame_to_uint8
    monkeypatch.setattr(pipeline, "frame_to_uint8", lambda img: (
        tfloat.append(img.numpy().copy()), u8(img))[1])
    record_calls(monkeypatch, pipeline.InferencePipeline, "render_trajectory",
                 tframes)
    out = tmp_path / "port" / "video.mp4"
    assert run.main(["--inference", "--ckpt-rest",
                     str(tmp_path / "port_rest"), "--ckpt-bldg",
                     str(tmp_path / "port_bldg"), "--output", str(out),
                     "--device", "cpu", *flags]) == 0

    assert len(jframes) == len(tframes) == 1
    assert len(jfloat) == len(tfloat) == 2
    for i in range(2):
        np.testing.assert_allclose(tfloat[i], jfloat[i], atol=1e-4)
        a, b = jframes[0][i].astype(int), tframes[0][i].astype(int)
        diff = np.abs(a - b)
        assert (diff == 0).mean() >= 0.999 and diff.max() <= 1
        assert a.std() > 1
    assert out.stat().st_size > 0
    jpgs = sorted(os.listdir(tmp_path / "port" / "video_frames"))
    assert jpgs == ["0000.jpg", "0001.jpg"]


def test_inference_from_orbax_checkpoints(rest_pair, bldg_pair, tmp_path,
                                          monkeypatch):
    """``--inference`` straight from the JAX package's Orbax directories:
    the same frames, to the bit, as from the port's own checkpoints of
    the same weights, and the same jpgs."""
    flags = _inference_checkpoints(rest_pair, bldg_pair, tmp_path)
    frames = {}
    u8 = pipeline.frame_to_uint8
    for kind in ("jax", "port"):
        got = frames[kind] = []
        monkeypatch.setattr(pipeline, "frame_to_uint8", lambda img, got=got: (
            got.append(img.numpy().copy()), u8(img))[1])
        assert run.main(["--inference", "--ckpt-rest",
                         str(tmp_path / f"{kind}_rest"), "--ckpt-bldg",
                         str(tmp_path / f"{kind}_bldg"), "--output",
                         str(tmp_path / kind / "video.mp4"), "--device",
                         "cpu", *flags]) == 0
    assert len(frames["jax"]) == len(frames["port"]) == 2
    for a, b in zip(frames["jax"], frames["port"]):
        assert np.array_equal(a, b) and a.std() > 0
    for i in range(2):
        name = f"{i:04d}.jpg"
        assert (tmp_path / "jax" / "video_frames" / name).read_bytes() == \
            (tmp_path / "port" / "video_frames" / name).read_bytes()


def test_test_mode_and_resume_from_an_orbax_checkpoint(tmp_path, caplog):
    """``--test -p`` and a training resume from the REST fixture of
    ``test_torch_orbax.py`` (a JAX train state after two steps, epoch 1):
    the validation L1 equals the one from the port's own file of the same
    state; the resumed run goes on at epoch 2 and step 3 and writes the
    port's epoch file; a run that would write into the Orbax directory
    is refused."""
    from test_torch_orbax import FIXTURES

    src = FIXTURES["rest"]
    cfg = C.Config.from_dict(
        orbax_reader.OrbaxCheckpoint(str(src)).config.to_dict())
    cfg = cfg.replace(output_dir=str(tmp_path / "out"), exp_name="resumed",
                      dataset=cfg.dataset.replace(
                          test_crop_size=cfg.dataset.train_crop_size),
                      train=cfg.train.replace(n_epochs=2, n_workers=1,
                                              ckpt_save_freq=1,
                                              log_freq=1))
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(cfg.to_json())
    common = ["-c", str(cfg_path), "-d", "SYNTHETIC", "--device", "cpu"]

    def val_l1(ckpt_dir) -> str:
        caplog.clear()
        with caplog.at_level("INFO"):
            assert run.main(common + ["--test", "-p", str(ckpt_dir)]) == 0
        return re.search(r"\[Val\]\[Epoch 1\] L1Loss (\S+)",
                         caplog.text).group(1)

    from gaussiancity_tpu_torch.training.step import Trainer

    t = Trainer(cfg, device="cpu")
    checkpoint.restore_checkpoint(str(src), t)
    checkpoint.save_epoch(str(tmp_path / "port"), 1, t)
    assert val_l1(src) == val_l1(tmp_path / "port")

    with caplog.at_level("INFO"):
        assert run.main(common + ["-p", str(src), "--max-steps", "3"]) == 0
    assert f"Resumed from {src} at epoch 1" in caplog.text
    ckpt_dir = tmp_path / "out" / "ckpt" / "resumed"
    assert sorted(os.listdir(ckpt_dir)) == ["epoch-00002.pt"]
    blob = torch.load(ckpt_dir / "epoch-00002.pt", weights_only=True)
    assert blob["state"]["step"] == 3
    assert {float(s["step"]) for s in
            blob["state"]["g_opt"]["state"].values()} == {3.0}
    # the next run of this experiment resumes from the port's file
    assert checkpoint.latest_epoch(str(ckpt_dir)) == 2
    import shutil
    shutil.copytree(src, tmp_path / "out" / "ckpt" / "jaxdir")
    with pytest.raises(ValueError, match="Orbax"):
        run.main(common + ["-e", "jaxdir", "--max-steps", "3"])
