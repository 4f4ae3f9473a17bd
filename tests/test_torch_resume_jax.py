# -*- coding: utf-8 -*-
"""A port ``Trainer`` resumed from the JAX package's Orbax checkpoint
against the JAX ``Trainer`` restored from it: the fixtures of
``test_torch_orbax.py`` hold the state after two JAX train steps, and
each side takes one more step on the same batch.

The port carries Adam's moments and counts of G and D and the step (and
so D's warm-up position); its step is held to the tolerances of the
JAX-against-port step tests (``test_torch_training.py`` for REST,
``test_torch_bldg_training.py`` for BLDG), and a resume with fresh
moments lands outside them.  For BLDG both sides draw one style table and
run without drop path, as in ``test_torch_bldg_training.py``."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gaussiancity_tpu.models.ptv3 as jptv3_mod
import gaussiancity_tpu.utils.helpers as jhelpers
from gaussiancity_tpu.training import checkpoint as jckpt
from gaussiancity_tpu.training.step import Trainer as JTrainer

from gaussiancity_tpu_torch import interop
from gaussiancity_tpu_torch.config import Config
from gaussiancity_tpu_torch.models import ptv3
from gaussiancity_tpu_torch.testing import share_cpu_cores
from gaussiancity_tpu_torch.training import checkpoint
from gaussiancity_tpu_torch.training.step import Trainer
from gaussiancity_tpu_torch.utils import helpers
from test_torch_bldg_training import _JPTv3NoDropPath
from test_torch_orbax import (FIXTURE_EPOCH, FIXTURES, abstract_state,
                              fixture_batch, fixture_config)

share_cpu_cores()

# losses: float32 sums taken in another order than XLA's
LOSS_ATOL, LOSS_RTOL = 1e-5, 1e-4
# REST: G weights within 1e-3 of the learning rate (test_torch_training)
REST_G_ATOL_LR = 1e-3
# D state, and the BLDG G weights that carry a gradient: within 1e-4 of
# each tensor's largest magnitude
REL = 1e-4
# a BLDG gradient below this share of its tensor's largest is rounding
# noise that Adam turns into a step of up to lr (test_torch_bldg_training)
ZERO_GRAD = 1e-6
Z_DIM = 16


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _z_table():
    return np.random.default_rng(9).normal(
        size=(helpers.MAX_N_INSTANCES, Z_DIM)).astype(np.float32)


def jax_resumed_step(kind: str) -> dict:
    """The JAX side: ``restore_checkpoint`` of the fixture, then one train
    step with the optimizers' gradients captured."""
    jcfg = fixture_config(kind)
    batch_np = fixture_batch(kind, jcfg)
    mp = pytest.MonkeyPatch()
    if kind == "bldg":
        table = _z_table()
        mp.setattr(jptv3_mod, "PointTransformerV3", _JPTv3NoDropPath)
        mp.setattr(jhelpers, "get_z",
                   lambda key, ins, z_dim, m=table.shape[0]:
                   jnp.asarray(table)[(ins % m).astype(jnp.int32)])
    try:
        state, _, epoch = jckpt.restore_checkpoint(str(FIXTURES[kind]),
                                                   abstract_state(kind))
        jt = JTrainer(jcfg)
        captured = {}

        def capture(tx, key):
            def update(grads, opt_state, params=None):
                captured[key] = grads
                return tx.update(grads, opt_state, params)
            return optax.GradientTransformation(tx.init, update)

        jt.g_tx = capture(jt.g_tx, "g")
        jt.d_tx = capture(jt.d_tx, "d")

        @jax.jit
        def jstep(state, batch, rng):
            state, metrics = jt.train_step(state, batch, rng)
            return state, metrics, captured["g"]

        batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
        after, metrics, g = _np(jstep(state, batch, jax.random.PRNGKey(3)))
    finally:
        mp.undo()
    return dict(epoch=epoch, batch=batch_np, after=after, metrics=metrics,
                g_grad=g)


@pytest.fixture(scope="module", params=["rest", "bldg"])
def resumed(request):
    return request.param, jax_resumed_step(request.param)


def _port(kind, run, monkeypatch, fresh_moments: bool = False):
    """The port's trainer resumed from the fixture (optionally with its
    Adam state dropped) and the batch as tensors."""
    if kind == "bldg":
        table = torch.from_numpy(_z_table())
        monkeypatch.setattr(helpers, "get_z",
                            lambda gen, ins, z_dim, m=table.shape[0]:
                            table[ins.long() % m])
    cfg = Config.from_dict(fixture_config(kind).to_dict())
    t = Trainer(cfg, device="cpu", seed=5)
    if kind == "bldg":
        ptv3.no_drop_path(t.generator)
    saved_cfg, epoch = checkpoint.restore_checkpoint(str(FIXTURES[kind]), t)
    assert saved_cfg == cfg and epoch == run["epoch"] == FIXTURE_EPOCH
    if fresh_moments:
        t.g_opt.state.clear()
        t.d_opt.state.clear()
    batch = {k: torch.from_numpy(np.asarray(v)) for k, v in
             run["batch"].items()}
    return t, batch


def _adam_steps(opt):
    return {float(s["step"]) for s in opt.state.values()}


def _g_weight_faults(kind, t, run) -> list:
    """The generator's weights after the step against the JAX ones, under
    the step tests' tolerance; returns the names of those outside it."""
    lr = t.cfg.train.generator.lr
    after = run["after"]
    want = interop.generator_state_from_flax(
        {"params": after.g_params, "batch_stats": after.g_stats or {}},
        t.cfg.network)
    grads = interop.generator_state_from_flax(run["g_grad"], t.cfg.network)
    gmax = max(float(grads[n].abs().max())
               for n, _ in t.generator.named_parameters())
    faults = []
    for n, p in t.generator.named_parameters():
        err = (p.detach() - want[n]).abs()
        if kind == "rest":
            ok = float(err.max()) <= REST_G_ATOL_LR * lr
        else:
            # a tensor whose gradient is 0 in exact arithmetic (below
            # ZERO_GRAD of the generator's largest) carries no signal
            g = grads[n].abs()
            signal = ((g >= ZERO_GRAD * g.max()) & (g != 0)
                      & (g.max() >= ZERO_GRAD * gmax))
            tol = REL * float(want[n].abs().max())
            ok = (bool((err[signal] <= tol).all())
                  and float(err.max()) <= 2 * lr + tol)
        if not ok:
            faults.append(n)
    return faults


def _close_rel(got, want, what):
    for name, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(
            got[name].detach().numpy(), w, rtol=0,
            atol=REL * max(np.abs(w).max(), 1e-30), err_msg=f"{what} {name}")


def test_resumed_step_matches_jax(resumed, monkeypatch):
    """The restored trainer holds both Adam states at the JAX counts (2)
    and the step, and its next step matches the JAX restore's next step:
    losses, G's weights, D's weights and spectral-norm state; each Adam
    step count is then 3."""
    kind, run = resumed
    t, batch = _port(kind, run, monkeypatch)
    assert t.step == 2
    assert _adam_steps(t.g_opt) == {2.0} and _adam_steps(t.d_opt) == {2.0}
    assert len(t.g_opt.state) == len(list(t.generator.parameters()))
    assert len(t.d_opt.state) == len(list(t.discriminator.parameters()))
    m = t.train_step(batch)
    assert t.step == 3
    assert _adam_steps(t.g_opt) == {3.0} and _adam_steps(t.d_opt) == {3.0}
    for k, v in run["metrics"].items():
        np.testing.assert_allclose(float(m[k]), float(v), rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL, err_msg=k)
    assert _g_weight_faults(kind, t, run) == []
    after = run["after"]
    _close_rel(t.discriminator.state_dict(),
               interop.discriminator_state_from_flax(after.d_params,
                                                     after.d_stats), "D")


def test_resume_with_fresh_moments_misses_jax(resumed, monkeypatch):
    """The control: the same weights with Adam restarted land outside
    the tolerance the carried moments meet."""
    kind, run = resumed
    t, batch = _port(kind, run, monkeypatch, fresh_moments=True)
    t.train_step(batch)
    assert len(_g_weight_faults(kind, t, run)) > 0


def test_warmup_count_must_equal_the_step():
    """D's learning rate follows the trainer's step: a state whose
    warm-up count differs raises, as one without optimizer states does."""
    from gaussiancity_tpu_torch.training import orbax_reader

    state = orbax_reader.OrbaxCheckpoint(str(FIXTURES["rest"])).tree()
    cfg = Config.from_dict(fixture_config("rest").to_dict())
    t = Trainer(cfg, device="cpu")
    bad = dict(state, d_opt=(state["d_opt"][0], {"count": np.int32(5)}))
    with pytest.raises(ValueError, match="warm-up"):
        interop.load_train_state(t, bad)
    with pytest.raises(ValueError, match="optimizer state"):
        interop.load_train_state(t, dict(state, g_opt=None))
    # a parameter without its moment, a moment without its parameter
    for edit in ("drop", "add"):
        mu = copy.deepcopy(state["g_opt"][0]["mu"])
        if edit == "drop":
            del mu["ga_mlp"]["fc_1"]["bias"]
        else:
            mu["ga_mlp"]["fc_extra"] = {"kernel": np.zeros((2, 3),
                                                           np.float32)}
        adam = dict(state["g_opt"][0], mu=mu)
        with pytest.raises(ValueError, match="1 parameters without|1 "
                                             "moments without"):
            interop.load_train_state(t, dict(state, g_opt=(adam, None)))
