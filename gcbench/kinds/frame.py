"""Frame cells: a closed loop of ``InferencePipeline.render_pose`` and the
uint8 readback over the traffic's orbit, after ``prepare`` at set-up, as
``python3 -m gaussiancity_tpu_torch --inference`` renders a fly-through.

The cell's configuration, the configurations it names as companions and
the entries of its ``models`` each give one generator (their ``model``:
REST, BLDG or CAR); the pipeline takes the REST configuration's
settings, as the command line does, and with more than one model gives
each the traffic's ``point_budget`` of its own class's points.  A
seed-drawn sample of the window's frames is kept (visible rows,
Gaussians, frame) and held against the reference once the window has
closed."""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from gcbench import compare, devices, inputs, precision, weights
from gcbench.harness import Context, log, read_per_layer
from gcbench.reference.frame import ReferencePipeline, get_style_lut
from gcbench.trace import profiled
from gcbench.work import k1 as k1_work
from gcbench.work.flops import WorkCounter

# seed tags of the generators' weights and of the style table: no two alike
MODEL_TAGS = {"REST": 10, "BLDG": 11, "CAR": 13}
STYLE_TAG = 12


def _confs(cell) -> dict:
    """model name -> configuration file, REST first."""
    confs = {c["model"]: c for c in [cell.config,
                                     *cell.companions.values()]}
    return {k: confs[k] for k in sorted(confs, key=lambda k: k != "REST")}


class Plan:
    """What a frame cell's run draws from the seed and its files, the
    same for the program, the reference and the control: the models'
    configurations (``confs`` files, ``rcfgs`` as the reference's), the
    city, the orbit, the style table, the budgets and the sampled
    frames."""

    def __init__(self, cell, seed: int):
        traffic = cell.traffic
        self.confs = _confs(cell)
        self.rcfgs = {k: weights.reference_config(c)
                      for k, c in self.confs.items()}
        self.projections, self.centers = inputs.city_from(traffic,
                                                          cell.root)
        self.poses = inputs.orbit(traffic, seed)
        z_dim = max([c.network.z_dim or 1 for c in self.rcfgs.values()])
        self.lut = get_style_lut(z_dim, inputs.sub_seed(seed, STYLE_TAG))
        self.budget = int(traffic["point_budget"])
        self.budgets = ({k: self.budget for k in self.confs}
                        if len(self.confs) > 1 else None)
        rng = np.random.default_rng(inputs.sub_seed(seed, 3))
        k = min(int(traffic["sample_frames"]), len(self.poses))
        self.sampled = sorted(
            rng.choice(len(self.poses), k, replace=False).tolist())


class _Capture:
    """Keeps the visible rows and Gaussians of the frames it is armed
    for, by wrapping two methods on the program's pipeline instance."""

    def __init__(self, pipe):
        self.pipe = pipe
        self.armed = False
        self.got = {}
        self._vis, self._raster = pipe.visible_points, pipe.raster_view
        pipe.visible_points = self._visible_points
        pipe.raster_view = self._raster_view

    def _visible_points(self, *a, **kw):
        rows, road = self._vis(*a, **kw)
        if self.armed:
            self.got["rows"] = rows.copy()
        return rows, road

    def _raster_view(self, gs, *a, **kw):
        if self.armed:
            self.got["gauss"] = gs.detach().clone()
        return self._raster(gs, *a, **kw)

    def take(self) -> dict:
        got, self.got = self.got, {}
        return got

    def remove(self) -> None:
        del self.pipe.visible_points, self.pipe.raster_view


def run(cell, seed: int, seconds: float, readers: dict, device: str,
        t_start: float):
    from gaussiancity_tpu_torch.config import Config
    from gaussiancity_tpu_torch.inference.pipeline import (
        InferencePipeline, frame_to_uint8)
    from gaussiancity_tpu_torch.models.generator import Generator

    precision.float32()
    traffic = cell.traffic
    plan = Plan(cell, seed)
    confs, rcfgs, poses = plan.confs, plan.rcfgs, plan.poses
    projections, centers = plan.projections, plan.centers
    cfg = Config.from_dict(next(iter(confs.values()))["config"])

    models = {}
    for name, rc in rcfgs.items():
        made = weights.generator_model(rc, seed, MODEL_TAGS[name], device)
        pc = Config.from_dict(confs[name]["config"])
        g = Generator(pc.network, n_classes=pc.dataset.n_classes,
                      proj_size=pc.dataset.proj_size)
        weights.load_into(g, made)
        models[name] = g
        del made
    pipe = InferencePipeline(cfg, models, max_points=plan.budget,
                             vol_shape=tuple(traffic["vol_shape"]),
                             class_budgets=plan.budgets, device=device)
    devices.reset_peak(device)
    with torch.inference_mode():
        state = pipe.prepare(projections, centers, style_lut=plan.lut)
        cap = _Capture(pipe)

        def frame(pose):
            img, _ = pipe.render_pose(state[0], centers, *state[1:], pose)
            return frame_to_uint8(img)

        for pose in poses:  # every shape of the orbit once
            frame(pose)
        devices.sync(device)
        setup_s = time.perf_counter() - t_start
        log(f"set-up {setup_s:.3f} s")

        sampled, k = plan.sampled, len(plan.sampled)
        kept = {}
        pipe.stage_ms.clear()
        pipe.frame_stats.clear()
        lat, n, t0 = [], 0, time.perf_counter()
        while True:
            cap.armed = n in sampled
            t = time.perf_counter()
            img = frame(poses[n % len(poses)])
            lat.append(time.perf_counter() - t)
            if cap.armed:
                kept[n] = dict(cap.take(), frame=img)
            n += 1
            if time.perf_counter() - t0 >= seconds and n > sampled[-1]:
                break
        window = time.perf_counter() - t0
        cap.armed = False
        cap.remove()
        frame_s = window / n
        failed = sum(1 for st in pipe.frame_stats
                     if st["n_truncated"] or st["n_dropped_pairs"])
        stage_ms = {k_: list(v) for k_, v in pipe.stage_ms.items()}
        log(f"window: {n} frames in {window:.3f} s, "
            f"{frame_s * 1e3:.3f} ms a frame; sampled {sampled}")

        ctx = None
        if readers:
            # the instrumented pass: one whole orbit; then the profiled
            # pass, the sampled frames, whose work the reference counts
            # (the profiler last, so that nothing it leaves behind is timed)
            ctx = Context(kind="frame",
                          modules=lambda: list(pipe.models.values()),
                          unit_s=frame_s, n_traced=len(poses),
                          stage_ms=stage_ms)
            for name, r in readers.items():
                if hasattr(r, "install"):
                    ctx.hooks[name] = r.install(ctx)
            for pose in poses:
                frame(pose)
            devices.sync(device)
            for h in ctx.hooks.values():
                h.remove()
            ctx.profile = profiled(lambda j: frame(poses[sampled[j]]), k,
                                   device)
    memory_peak = devices.peak_bytes(device)
    del pipe, models, state, cap
    gc.collect()
    devices.free(device)

    ref_frames, work = _reference(plan, traffic, seed, device,
                                  counting=bool(readers))
    numbers = compare.frame_numbers([kept[i] for i in sampled], ref_frames)
    correct, compared = compare.judge(numbers, cell.limits)
    metrics = {"frame_ms": {"value": frame_s * 1e3, "unit": "ms"},
               "frame_p95_ms": {"value": float(np.percentile(lat, 95)) * 1e3,
                                "unit": "ms"},
               "setup_s": {"value": setup_s, "unit": "s"}}
    result = {"correct": correct, "attempted": n, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu",
                         "kind": devices.name(device), "count": 1,
                         "memory_peak_bytes": int(memory_peak)}}
    if ctx is not None:
        ctx.work = work
        read_per_layer(cell, ctx, readers, result)
    return result, compared


def _reference(plan: Plan, traffic, seed, device, counting: bool):
    """The reference's sampled frames, and with ``counting`` the work of
    each (model FLOPs, K1's operations and bytes)."""
    base = next(iter(plan.rcfgs.values()))
    models = {name: weights.generator_model(rc, seed, MODEL_TAGS[name],
                                            device)
              for name, rc in plan.rcfgs.items()}
    ref = ReferencePipeline(base, models, plan.budget,
                            tuple(traffic["vol_shape"]), plan.budgets, device)
    ref.prepare(plan.projections, plan.centers, plan.lut)
    out, work = [], {"k1": [], "flops": []}
    for pose in [plan.poses[i] for i in plan.sampled]:
        if counting:
            with WorkCounter(list(models.values())) as wc:
                rows, gs, img = ref.render_pose(pose)
            work["flops"].append(wc.flops())
            cam = ref.camera.params_f32(
                torch.tensor([pose["tx"], pose["ty"], pose["tz"]],
                             dtype=torch.float32, device=device),
                torch.tensor([pose["qx"], pose["qy"], pose["qz"],
                              pose["qw"]], dtype=torch.float32,
                             device=device))
            work["k1"].append(k1_work.frame_work(gs, cam, base.rasterizer))
        else:
            rows, gs, img = ref.render_pose(pose)
        out.append({"rows": rows, "gauss": gs, "frame": img})
    if counting:
        work["flops_per_unit"] = float(np.mean(work["flops"]))
    return out, work
