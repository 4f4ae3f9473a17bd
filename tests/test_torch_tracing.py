# -*- coding: utf-8 -*-
"""The port's tracer (``utils.profiling``) on the CPU: a span outside a
profiler is a no-op that never opens ``record_function``; under
``profiling.trace()`` a tiny two-model frame and a tiny BLDG train step
write their unit spans with the stage, layer and ``sync.*`` spans nested
inside; the stage timers keep their keys."""

import json

import numpy as np
import pytest
import torch

from gaussiancity_tpu_torch.config import (
    Config, DatasetConfig, DiscriminatorOptim, GaussianNetworkConfig,
    PTv3Config, RasterizerConfig, TrainConfig)
from gaussiancity_tpu_torch.inference import pipeline
from gaussiancity_tpu_torch.models.generator import Generator
from gaussiancity_tpu_torch.testing import (TINY_PTV3, share_cpu_cores,
                                            tiny_bldg_batch)
from gaussiancity_tpu_torch.training.step import Trainer
from gaussiancity_tpu_torch.utils import profiling

share_cpu_cores()

TRAIN_STAGES = {"generator", "render", "d_step", "g_loss", "backward",
                "adam"}
FRAME_STAGES = {"raycast", "points", "generator", "generator_REST",
                "generator_BLDG", "rasterize", "blur"}
N_POSES = 2


def rest_net() -> GaussianNetworkConfig:
    return GaussianNetworkConfig(
        scale_factor=0.5, encoder="GLOBAL", encoder_out_dim=5,
        global_encoder_n_blocks=2, pos_emd="HASH_GRID",
        hash_grid_n_levels=2, hash_grid_level_dim=2, hash_grid_map_size=8,
        mlp_hidden_dim=16, dis_n_channel_base=8,
        ptv3=PTv3Config(enabled=False))


def bldg_net() -> GaussianNetworkConfig:
    return rest_net().replace(
        scale_factor=0.65, encoder=None, encoder_out_dim=3,
        pos_emd="SIN_COS", sin_cos_freq_bends=4, z_dim=16,
        ptv3=PTv3Config(dense_nbr_extent=64, **TINY_PTV3))


def tiny_config(net: GaussianNetworkConfig) -> Config:
    return Config(
        dataset=DatasetConfig(
            sensor_size=(128, 64), train_crop_size=(64, 48),
            test_crop_size=(64, 48), proj_size=64,
            cam_k=(60.0, 0, 64.0, 0, 60.0, 32.0, 0, 0, 1)),
        network=net,
        rasterizer=RasterizerConfig(tile_h=16, tile_w=16, tile_capacity=128),
        train=TrainConfig(
            allow_random_vgg=True,
            perceptual_loss_layers=("relu_1_1", "relu_2_1"),
            perceptual_loss_weights=(0.5, 1.0),
            discriminator=DiscriminatorOptim(n_warmup_iters=4)))


def projections(P: int = 64):
    ins = np.ones((P, P), np.int16)
    ins[10:20, 10:20] = 100
    ins[30:42, 30:44] = 102
    td = np.where(ins >= 100, 18, 2).astype(np.int16)
    return {"REST": {"INS": ins, "SEG": np.where(ins >= 100, 2, ins).astype(
        np.int16), "TD_HF": td, "BU_HF": np.zeros((P, P), np.int16),
        "PTS": np.ones((P, P), bool)}}


def tiny_frames():
    """A two-model pipeline on the compact path and its trajectory's
    arguments."""
    torch.manual_seed(0)
    cfg = tiny_config(rest_net())
    models = {name: Generator(net, n_classes=8, proj_size=64)
              for name, net in (("REST", rest_net()), ("BLDG", bldg_net()))}
    pipe = pipeline.InferencePipeline(
        cfg, models, max_points=4096, vol_shape=(72, 72, 24),
        class_budgets={"REST": 2048, "BLDG": 1024}, device="cpu")
    centers = {100: (15.0, 15.0, 10.0, 10.0, 18.0),
               102: (36.0, 37.0, 12.0, 14.0, 18.0)}
    poses = pipeline.get_orbit_camera_poses(64, n_points=N_POSES, radius=20,
                                            altitude=30)
    lut = pipeline.get_style_lut(centers, 16, seed=0)
    return pipe, (projections(), centers, poses), lut


def tiny_trainer():
    cfg = tiny_config(bldg_net())
    batch = {k: torch.as_tensor(v) for k, v in
             tiny_bldg_batch(cfg, n_pts=128, seed=1).items()}
    return Trainer(cfg, device="cpu", seed=0), batch


def run_both():
    pipe, args, lut = tiny_frames()
    frames = pipe.render_trajectory(*args, style_lut=lut)
    trainer, batch = tiny_trainer()
    trainer.train_step(batch)
    return pipe, frames, trainer


def test_disabled_span_is_shared_and_never_records(monkeypatch):
    """(a) outside a profiler a span is one shared no-op context, and a
    frame and a train step never open ``record_function``."""
    assert profiling.span("x") is profiling.span("y")
    assert profiling.step_annotation("frame", 3) is profiling.span("x")

    def refuse(*args, **kwargs):
        raise AssertionError("record_function opened with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    pipe, frames, trainer = run_both()
    assert len(frames) == N_POSES and frames[0].dtype == np.uint8
    assert trainer.step == 1


def _spans(path):
    with open(path) as fp:
        events = json.load(fp)["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("ph") == "X"
            and str(e.get("name", "")).startswith(profiling.PREFIX)]


def _inside(spans, unit):
    """The ``gct/`` names of the spans within each span named ``unit``
    (a prefix when it ends in '#')."""
    units = [(s, e) for n, s, e in spans
             if (n.startswith(unit) if unit.endswith("#") else n == unit)]
    assert units, unit
    return [{n for n, s, e in spans if us <= s and e <= ue
             and (s, e) != (us, ue)} for us, ue in units]


def test_trace_nests_stage_layer_and_sync_spans(tmp_path):
    """(b) the exported Chrome trace holds each frame's and step's unit
    span, and inside it the stage, layer and ``sync.*`` spans."""
    with profiling.trace(str(tmp_path)):
        run_both()
    spans = _spans(tmp_path / "trace.json")
    g = profiling.PREFIX
    frames = _inside(spans, g + "frame#")
    assert len(frames) == N_POSES
    want_frame = {g + n for n in FRAME_STAGES | {
        "hash_grid", "encoder", "attr_mlp", "ptv3", "ptv3.enc0",
        "ptv3.enc2", "ptv3.dec0", "raster.preprocess", "raster.binning",
        "raster.blend", "sync.visible_ids", "sync.ptv3_pack",
        "sync.frame_counters"}}
    for inner in frames:
        assert want_frame <= inner, want_frame - inner
    for inner in _inside(spans, g + "frame.readback"):
        assert g + "sync.frame" in inner
    (prepare,) = _inside(spans, g + "prepare")
    assert {g + "extrude", g + "volume"} <= prepare
    (step,) = _inside(spans, g + "train_step#")
    want_step = {g + n for n in TRAIN_STAGES | {
        "ptv3", "ptv3.enc1", "ptv3.dec1", "attr_mlp", "disc", "vgg",
        "adam_d", "adam_g", "raster.preprocess", "raster.binning",
        "raster.blend", "sync.crop_origin", "sync.ptv3_pack"}}
    assert want_step <= step, want_step - step


def test_trainer_stage_ms_keys():
    """(c) ``Trainer.stage_ms`` stays empty with ``time_stages`` off and
    has one entry a step under each stage with it on."""
    trainer, batch = tiny_trainer()
    trainer.train_step(batch)
    assert trainer.stage_ms == {}
    trainer.time_stages = True
    for _ in range(2):
        trainer.train_step(batch)
    trainer.time_stages = False
    assert set(trainer.stage_ms) == TRAIN_STAGES
    assert all(len(v) == 2 and min(v) >= 0
               for v in trainer.stage_ms.values())
    trainer.train_step(batch)
    assert all(len(v) == 2 for v in trainer.stage_ms.values())


def test_pipeline_stage_ms_keys():
    """(d) ``InferencePipeline.stage_ms`` after a tiny trajectory: the
    set-up stages once, every frame stage (per model on the compact
    path) and the readback once a frame."""
    pipe, args, lut = tiny_frames()
    pipe.render_trajectory(*args, style_lut=lut)
    ms = pipe.stage_ms
    assert set(ms) == FRAME_STAGES | {"extrude", "volume", "readback"}
    assert len(ms["extrude"]) == len(ms["volume"]) == 1
    for stage in FRAME_STAGES | {"readback"}:
        assert len(ms[stage]) == N_POSES, stage
    # the generator stage spans the per-model ones
    for i in range(N_POSES):
        assert ms["generator"][i] >= (ms["generator_REST"][i]
                                      + ms["generator_BLDG"][i]) * 0.999
    assert len(pipe.frame_stats) == N_POSES
    assert set(pipe.frame_stats[0]) == {
        "n_visible", "n_REST", "n_BLDG", "n_dropped_pairs", "n_truncated",
        "n_grad_truncated"}


@pytest.mark.parametrize("timed", [False, True])
def test_stages_chain_and_restart(timed):
    """A timed stage starts where the owner's previous one ended; after
    ``restart`` it starts anew.  Untimed stages record nothing."""
    st = profiling.Stages("cpu", timed=timed)
    st.restart()
    with st("a"):
        pass
    end_a = st._end
    with st("b"):
        pass
    if not timed:
        assert st.ms == {} and end_a is None
        return
    assert set(st.ms) == {"a", "b"} and end_a is not None
    st.restart()
    assert st._end is None
    with pytest.raises(ValueError):
        with st("c"):
            raise ValueError
    assert "c" not in st.ms and st._end is None


def test_parallel_step_allreduce_stage(tmp_path):
    """With ``time_stages`` on, one rank of a gloo group keeps one
    ``allreduce`` entry a step (its collectives, taken out of ``d_step``
    and ``adam``) beside the step's own stages; off, none."""
    import torch.distributed as dist

    from gaussiancity_tpu_torch.parallel import mesh
    from gaussiancity_tpu_torch.training.step import make_parallel_train_step

    trainer, batch = tiny_trainer()
    mesh.init_group(dist.FileStore(str(tmp_path / "store"), 1), 0, 1,
                    torch.device("cpu"))
    try:
        step = make_parallel_train_step(trainer)
        step(batch)
        assert trainer.stage_ms == {}
        trainer.time_stages = True
        for _ in range(2):
            step(batch)
    finally:
        dist.destroy_process_group()
    assert set(trainer.stage_ms) == TRAIN_STAGES | {"allreduce"}
    assert all(len(v) == 2 and min(v) >= 0
               for v in trainer.stage_ms.values())
