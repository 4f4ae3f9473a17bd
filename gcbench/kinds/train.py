"""Train-step cells: a closed loop of ``Trainer.train_step`` at the
traffic's batch, cycling its samples.

Set-up builds one trainer, loads the benchmark's weights into it and
drives it through the first ``followed_steps`` steps on samples that all
differ, keeping what the comparison reads (losses, the first step's
Gaussian attributes and crop, Adam's first moments after one step, each
leaf's change, D's Adam state and learning rates); the window then
drives the same trainer.  Once the window has closed and the trainer is
freed, the reference follows the same steps from the same weights and
draws."""

from __future__ import annotations

import gc
import time
from typing import Dict

import torch

from gcbench import compare, devices, inputs, precision, weights
from gcbench.harness import Context, log, read_per_layer
from gcbench.reference.train import ReferenceTrainer
from gcbench.trace import profiled
from gcbench.work.flops import WorkCounter


def step_rng(seed: int, i: int, device) -> torch.Generator:
    """The draws of step ``i`` (style codes, then drop-path masks)."""
    return torch.Generator(device=device).manual_seed(
        inputs.sub_seed(seed, 20, i))


def _losses(m: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(m[k]) for k in compare.LOSS_KEYS}


def _snapshot(modules: Dict[str, torch.nn.Module]):
    return {k: {n: p.detach().clone() for n, p in m.named_parameters()}
            for k, m in modules.items()}


def _grads(opts, modules, beta1) -> Dict[str, Dict[str, float]]:
    return {k: compare.adam_grad_norms(opts[k], compare.named_params(m),
                                       beta1)
            for k, m in modules.items()}


def _follow(step, modules, opts, samples, rngs, n, capture, beta1) -> dict:
    """Drive ``step(batch, rng)`` through steps 0..n-1 on ``samples[i]``
    and ``rngs(i)``; ``capture()`` gives the first step's attributes and
    crop."""
    start = _snapshot(modules)
    out = {"losses": [], "lr_D": []}
    for i in range(n):
        m = step(samples[i % len(samples)], rngs(i))
        out["losses"].append(_losses(m))
        out["lr_D"].append(float(opts["D"].param_groups[0]["lr"]))
        if i == 0:
            out.update(capture())
            out["grad"] = _grads(opts, modules, beta1)
    out["change"] = {k: compare.change_norms(compare.named_params(m),
                                             start[k])
                     for k, m in modules.items()}
    out["adam_D"] = compare.adam_state(opts["D"],
                                       compare.named_params(modules["D"]))
    return out


class _Capture:
    """The first step's attributes (a forward hook on the generator) and
    rendered crop (the trainer's ``_render_fake``, wrapped on the
    instance) of the program's trainer."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.got = {}
        self.h = trainer.generator.register_forward_hook(self._attrs)
        self.orig = trainer._render_fake
        trainer._render_fake = self._render

    def _attrs(self, module, args, out):
        self.got.setdefault("attrs", {k: v.detach().clone()
                                      for k, v in out.items()})

    def _render(self, *a, **kw):
        fake, diag = self.orig(*a, **kw)
        self.got.setdefault("crop", fake.detach().clone())
        return fake, diag

    def __call__(self):
        self.h.remove()
        del self.trainer._render_fake
        return dict(self.got)


def run(cell, seed: int, seconds: float, readers: dict, device: str,
        t_start: float):
    from gaussiancity_tpu_torch.config import Config
    from gaussiancity_tpu_torch.training.step import Trainer

    precision.float32()
    traffic = cell.traffic
    cfg = Config.from_dict(cell.config["config"])
    rcfg = weights.reference_config(cell.config)
    beta1 = float(rcfg.train.betas[0])
    samples = inputs.samples(cell, rcfg, seed, device)
    n_follow = int(traffic["followed_steps"])
    made = weights.train_models(rcfg, seed, device)
    trainer = Trainer(cfg, device=device)
    weights.load_into(trainer.generator, made["generator"])
    weights.load_into(trainer.discriminator, made["discriminator"])
    weights.load_into(trainer.ploss.model, made["ploss"].model)
    del made
    gc.collect()
    devices.reset_peak(device)
    modules = {"G": trainer.generator, "D": trainer.discriminator}
    opts = {"G": trainer.g_opt, "D": trainer.d_opt}
    prog = _follow(trainer.train_step, modules, opts, samples,
                   lambda i: step_rng(seed, i, device), n_follow,
                   _Capture(trainer), beta1)
    devices.sync(device)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s; followed {n_follow} steps: "
        f"{prog['losses']}")

    bad = torch.zeros((), dtype=torch.int64, device=device)
    n, t0 = 0, time.perf_counter()
    while True:
        i = n_follow + n
        m = trainer.train_step(samples[i % len(samples)],
                               step_rng(seed, i, device))
        bad += (sum(m[k].long() for k in compare.COUNTER_KEYS) > 0).long()
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    devices.sync(device)
    window = time.perf_counter() - t0
    step_s = window / n
    log(f"window: {n} steps in {window:.3f} s, {step_s * 1e3:.3f} ms a step")

    ctx = None
    if readers:
        ctx = _traced(cell, trainer, samples, seed, device, readers, step_s,
                      n_follow + n)
    memory_peak = devices.peak_bytes(device)
    failed = int(bad)
    del trainer, modules, opts
    gc.collect()
    devices.free(device)

    ref, work = _reference(rcfg, samples, seed, n_follow, device, beta1,
                           counting=bool(readers))
    numbers = compare.train_numbers(prog, ref)
    log(f"not compared: change.D {compare.worst_leaf(prog['change']['D'], ref['change']['D'])!r}")
    correct, compared = compare.judge(numbers, cell.limits)
    metrics = {"train_step_ms": {"value": step_s * 1e3, "unit": "ms"},
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


def _traced(cell, trainer, samples, seed, device, readers, step_s,
            i0) -> Context:
    """The instrumented pass (stage timers and the readers' hooks), then
    the profiled pass, each over the first ``traced_steps`` samples.  The
    profiler goes last, so that nothing it leaves behind is timed."""
    n = int(cell.traffic["traced_steps"])
    ctx = Context(kind="train",
                  modules=lambda: [trainer.generator, trainer.discriminator,
                                   trainer.ploss],
                  unit_s=step_s, n_traced=n)

    def step(k):
        trainer.train_step(samples[k % n], step_rng(seed, i0 + k, device))

    trainer.stage_ms.clear()
    trainer.time_stages = True
    for name, r in readers.items():
        if hasattr(r, "install"):
            ctx.hooks[name] = r.install(ctx)
    for k in range(n):
        step(k)
    devices.sync(device)
    trainer.time_stages = False
    for h in ctx.hooks.values():
        h.remove()
    ctx.stage_ms = {k: list(v) for k, v in trainer.stage_ms.items()}
    ctx.profile = profiled(lambda k: step(n + k), n, device)
    return ctx


def _reference(rcfg, samples, seed, n_follow, device, beta1,
               counting: bool):
    made = weights.train_models(rcfg, seed, device)
    rt = ReferenceTrainer(rcfg, made)
    return follow_reference(rt, samples, lambda i: step_rng(seed, i, device),
                            n_follow, beta1, counting)


def follow_reference(rt, samples, rngs, n_follow, beta1, counting: bool):
    """``_follow`` of the reference trainer ``rt``, and with ``counting``
    the work of its steps."""
    modules = {"G": rt.generator, "D": rt.discriminator}
    opts = {"G": rt.g_opt, "D": rt.d_opt}

    def capture():
        return {"attrs": rt.last["attrs"], "crop": rt.last["fake"]}

    work = {}
    if counting:
        with WorkCounter([rt.generator]) as wc:
            ref = _follow(rt.train_step, modules, opts, samples, rngs,
                          n_follow, capture, beta1)
        work = {"flops_per_unit": wc.flops() / n_follow,
                "submconv": wc.submconv(), "units": n_follow}
    else:
        ref = _follow(rt.train_step, modules, opts, samples, rngs, n_follow,
                      capture, beta1)
    return ref, work
