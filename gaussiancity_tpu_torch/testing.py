# -*- coding: utf-8 -*-
"""Test-size inputs shared by the port's tests and the smoke script: the
small PTv3 of the JAX test suite (``tests/test_ptv3.py``), a BLDG batch
that it finds neighbours in, and the rank workers of their runs on
several ranks (``parallel.launch.spawn_ranks``), which live here so that
a spawned rank imports no test module and nothing of JAX."""

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


# ---------------------------------------------------------------------------
# rank workers of the two-rank runs (``parallel.launch.spawn_ranks``): each
# is called as ``fn(rank, world, device, *args)`` in a process of its own
# ---------------------------------------------------------------------------


def calls_in_turn(rank: int, world: int, device, calls):
    """Several rank workers in one spawned process, one after the other:
    ``calls`` is a list of (worker, args); returns their results in
    order."""
    return [fn(rank, world, device, *args) for fn, args in calls]


def _no_tf32(device) -> None:
    """A rank on the card is held to the CPU: no TF32 matmuls or
    convolutions."""
    import torch

    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def _fixed_z(table):
    """Make ``helpers.get_z`` gather from ``table`` [M, z] (numpy)."""
    import torch

    from gaussiancity_tpu_torch.utils import helpers

    def get_z(generator, instances, z_dim, max_instances=None):
        if z_dim is None:
            return None
        t = torch.as_tensor(table, device=instances.device)
        return t[instances.long() % t.shape[0]]

    helpers.get_z = get_z


def ddp_steps(rank: int, world: int, device, cfg, batches, n_steps: int,
              states=None, z_tables=None):
    """``n_steps`` data-parallel steps of a ``Trainer(cfg, seed 0)`` on
    ``batches[rank]`` (numpy).  ``states`` (optional) holds the
    ``generator``, ``discriminator`` and ``vgg`` (the perceptual loss's
    network) state dicts to start from; ``z_tables`` [world, M, z]
    (optional) fixes rank r's style codes to table r and turns drop path
    off, so that another device or package draws the same.  Returns per
    step the metrics, the sums of the style codes drawn, the weights and
    buffers of G and D, their averaged gradients and the replica digest.
    ``helpers.get_z`` is restored on return."""
    from gaussiancity_tpu_torch.utils import helpers

    _no_tf32(device)
    own_get_z = helpers.get_z
    try:
        if z_tables is not None:
            _fixed_z(z_tables[rank])
        return _ddp_steps(rank, device, cfg, batches, n_steps, states,
                          z_tables is not None)
    finally:
        helpers.get_z = own_get_z


def _ddp_steps(rank, device, cfg, batches, n_steps, states, no_drop_path):
    import torch

    from gaussiancity_tpu_torch.models import ptv3
    from gaussiancity_tpu_torch.training.checkpoint import state_digest
    from gaussiancity_tpu_torch.training.step import (
        Trainer, make_parallel_train_step)
    from gaussiancity_tpu_torch.utils import helpers

    z_sums = []
    get_z = helpers.get_z

    def recording_get_z(*args, **kwargs):
        z = get_z(*args, **kwargs)
        if z is not None:
            z_sums.append(float(z.double().sum()))
        return z

    helpers.get_z = recording_get_z
    t = Trainer(cfg, device=device, seed=0)
    if states is not None:
        t.generator.load_state_dict(states["generator"])
        if t.use_disc:
            t.discriminator.load_state_dict(states["discriminator"])
        t.ploss.model.load_state_dict(states["vgg"])
    if no_drop_path:
        ptv3.no_drop_path(t.generator)
    step = make_parallel_train_step(t)
    batch = {k: torch.as_tensor(v).to(device)
             for k, v in batches[rank].items()}

    def cpu(named):
        return {n: v.detach().cpu().clone() for n, v in named}

    out = []
    for _ in range(n_steps):
        z_sums.clear()
        m = step(batch)
        rec = {"metrics": {k: float(v) for k, v in m.items()},
               "z_sums": list(z_sums),
               "generator": cpu(t.generator.state_dict().items()),
               "g_grads": cpu((n, p.grad) for n, p in
                              t.generator.named_parameters()
                              if p.grad is not None),
               "digest": state_digest(t)}
        if t.use_disc:
            rec["discriminator"] = cpu(t.discriminator.state_dict().items())
            rec["d_grads"] = cpu((n, p.grad) for n, p in
                                 t.discriminator.named_parameters()
                                 if p.grad is not None)
        out.append(rec)
    return out


def train_loop_rank(rank: int, world: int, device, cfg, n_items: int,
                    resume_dir: str):
    """``train(cfg)`` on the synthetic dataset of ``n_items`` items, then a
    run into ``resume_dir`` resumed from the first epoch's checkpoint of
    that run (rank 0 copies it there; the other ranks wait at ``train``'s
    barrier before the resume reads it).  Returns both runs' steps and
    replica digests, and the ``pts`` of every batch the straight run's
    steps took."""
    import functools
    import os
    import shutil

    from gaussiancity_tpu_torch.data import datasets
    from gaussiancity_tpu_torch.training import train as train_mod
    from gaussiancity_tpu_torch.training.checkpoint import (epoch_path,
                                                            state_digest)

    datasets.DATASETS["SYNTHETIC"] = functools.partial(
        datasets.SyntheticDataset, n_items=n_items)
    fed = []
    to_device = train_mod.to_device

    def recording(batch, dev):
        fed.append(batch["pts"].copy())
        return to_device(batch, dev)

    train_mod.to_device = recording
    straight = train_mod.train(cfg, device=device)
    train_mod.to_device = to_device
    name = cfg.exp_name or "default"
    ckpt_dir = f"{resume_dir}/ckpt/{name}"
    if rank == 0:
        os.makedirs(ckpt_dir)
        shutil.copy(epoch_path(f"{cfg.output_dir}/ckpt/{name}", 1), ckpt_dir)
    resumed = train_mod.train(cfg.replace(output_dir=resume_dir),
                              resume_from=ckpt_dir, device=device)
    return {"step": straight.step, "digest": state_digest(straight),
            "resumed_step": resumed.step,
            "resumed_digest": state_digest(resumed), "fed": fed}


def _on(cam, device):
    """``cam`` (a ``CameraParams``) with its tensors on ``device``."""
    import torch

    return cam._replace(**{k: v.to(device) for k, v in cam._asdict().items()
                           if torch.is_tensor(v)})


def sharded_raster_rank(rank: int, world: int, device, scene, valid, bg,
                        cam, cfg, probe=None):
    """The band-sharded rasterizer on rank ``rank``'s shard of ``scene``
    (means, opacities, scales, quats, colours: numpy, the whole set), seen
    by ``cam`` (a ``CameraParams`` on the host): the image, the bands'
    counters, and the gradients of the image's sum of squares with respect
    to the shard and to ``bg``.  ``probe(rank, run)``, when given, takes
    the place of the one ``run()`` (a render and its backward, the
    gradients cleared first): it calls ``run`` as it needs and returns
    (the last run's output, a dict added to the result)."""
    import torch

    from gaussiancity_tpu_torch.parallel.sharded_raster import (
        make_sharded_rasterizer)

    _no_tf32(device)
    n = scene[0].shape[0] // world
    rows = slice(rank * n, (rank + 1) * n)
    args = [torch.as_tensor(a[rows], device=device).requires_grad_(True)
            for a in scene]
    bg_t = torch.as_tensor(bg, device=device).requires_grad_(True)
    valid_t = torch.as_tensor(valid[rows], device=device)
    render = make_sharded_rasterizer(_on(cam, device), cfg)

    def run():
        for a in args + [bg_t]:
            a.grad = None
        out = render(*args, valid_t, bg_t)
        (out.image ** 2).sum().backward()
        return out

    out, extra = (run(), {}) if probe is None else probe(rank, run)
    return {"image": out.image.detach().cpu(),
            "counts": [int(c) for c in out[1:]],
            "grads": [a.grad.cpu() for a in args], "bg_grad": bg_t.grad.cpu(),
            **extra}


def _pipeline(cfg, models, device):
    """An ``InferencePipeline`` of ``models``: class name -> (network
    config, generator state dict)."""
    from gaussiancity_tpu_torch.inference.pipeline import InferencePipeline
    from gaussiancity_tpu_torch.models.generator import Generator

    gens = {}
    for name, (net, state) in models.items():
        g = Generator(net, n_classes=cfg.dataset.n_classes,
                      proj_size=cfg.dataset.proj_size)
        g.load_state_dict(state)
        gens[name] = g
    return InferencePipeline(cfg, gens, device=device)


def sharded_frame_rank(rank: int, world: int, device, cfg, models, frames,
                       maps, probe=None):
    """The sharded two-model frame of each of ``frames`` on a black
    background.  ``models`` maps a class name to (network config,
    generator state dict), or is a function ``(cfg, device) ->
    InferencePipeline``.  A frame is a dict with ``buckets`` (class name
    -> (pts9 numpy, count): the first ``count`` rows are real; rows that
    do not divide over the ranks are padded with masked copies of the
    first) and ``cam`` (a ``CameraParams`` on the host); ``maps`` is
    (proj_hf, proj_seg, style_lut).  Returns per frame the image and the
    bands' counters, or, with ``probe``, what ``probe(rank, i, run,
    frame, pipe)`` returns in place of frame i's one ``run()``."""
    import numpy as np
    import torch

    from gaussiancity_tpu_torch.parallel.sharded_infer import (
        make_sharded_frame)

    _no_tf32(device)
    pipe = (models(cfg, device) if callable(models)
            else _pipeline(cfg, models, device))
    proj_hf, proj_seg, lut = (torch.as_tensor(m, device=device)
                              for m in maps)
    bg = torch.zeros(3, device=device)
    out = []
    with torch.inference_mode():
        for i, fr in enumerate(frames):
            buckets = {}
            for name, (pts, count) in fr["buckets"].items():
                pts = np.concatenate([pts, np.repeat(pts[:1],
                                                     -len(pts) % world, 0)])
                buckets[name] = (torch.as_tensor(pts, device=device), count)
            frame = make_sharded_frame(pipe, _on(fr["cam"], device),
                                       cfg.rasterizer)

            def run():
                return frame(buckets, proj_hf, proj_seg, lut, bg)

            if probe is None:
                o = run()
                out.append({"image": o.image.cpu(),
                            "counts": [int(c) for c in o[1:]]})
            else:
                out.append(probe(rank, i, run, fr, pipe))
    return out


def mesh_rank(rank: int, world: int, device):
    """The ranks' meshes: ``make_data_mesh(world, 1)``'s and
    ``make_simple_mesh()``'s dims, names and the size of each dim's
    group, and a row gather over the "data" group."""
    import torch
    import torch.distributed as dist

    from gaussiancity_tpu_torch.parallel import mesh

    out = {}
    for what, m in (("data", mesh.make_data_mesh(world, 1)),
                    ("simple", mesh.make_simple_mesh())):
        out[what] = (m.mesh.tolist(), m.mesh_dim_names,
                     [dist.get_world_size(m.get_group(n))
                      for n in m.mesh_dim_names])
    rows = torch.full((2, 3), float(rank))
    out["gathered"] = mesh.all_gather_rows(
        rows, mesh.make_data_mesh(world, 1).get_group("data"))
    return out
