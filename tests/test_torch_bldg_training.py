# -*- coding: utf-8 -*-
"""PyTorch port vs the JAX package: the BLDG GAN train step (sin/cos, a
style z per instance, PTv3 in training mode).

Two steps of a tiny BLDG config (tiny PTv3, z 16, no encoder) run in the
JAX ``Trainer`` and in the port's, from the same weights carried by
``interop.load_train_state``.  Both draw the same style-code table (each
package's ``helpers.get_z`` is patched to gather from one numpy table),
and drop path is off on both sides (the JAX ``PointTransformerV3`` is
swapped for a subclass at rate 0, the port's blocks are set to rate 0).
Also here: the eval step, PTv3's overflow count, the CAR recipe, drop path
and the trainer's own generators."""

import copy
import functools
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gaussiancity_tpu.models.ptv3 as jptv3_mod
import gaussiancity_tpu.utils.helpers as jhelpers
from gaussiancity_tpu.config import PTv3Config as JPTv3Config
from gaussiancity_tpu.training.step import Trainer as JTrainer

from gaussiancity_tpu_torch import interop
from gaussiancity_tpu_torch.config import Config, PTv3Config, car_recipe
from gaussiancity_tpu_torch.models import ptv3
from gaussiancity_tpu_torch.testing import TINY_PTV3 as TINY
from gaussiancity_tpu_torch.testing import tiny_bldg_batch
from gaussiancity_tpu_torch.training.step import Trainer
from gaussiancity_tpu_torch.utils import helpers
from test_train_step import tiny_config

# losses: float32 sums taken in another order than XLA's
LOSS_ATOL, LOSS_RTOL = 1e-5, 1e-4
# gradients, weights after Adam and running statistics: relative to each
# tensor's largest magnitude
REL = 1e-4
# a gradient below this share of the largest (the generator's for a whole
# tensor, its tensor's for an element) is rounding noise
ZERO_GRAD = 1e-6

Z_DIM = 16


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def bldg_configs():
    """The tiny BLDG config in both packages; the test crop is the train
    crop so that one batch serves both steps."""
    j = tiny_config(use_disc=True, z_dim=Z_DIM, encoder=None)
    j = j.replace(
        dataset=j.dataset.replace(test_crop_size=j.dataset.train_crop_size),
        network=j.network.replace(ptv3=JPTv3Config(**TINY)),
        train=j.train.replace(discriminator=j.train.discriminator.replace(
            n_warmup_iters=1)))
    return j, Config.from_dict(j.to_dict())


class _JPTv3NoDropPath(jptv3_mod.PointTransformerV3):
    drop_path: float = 0.0


def run_jax(jcfg, cfg, batch_np, trainer_cls=JTrainer,
            with_eval: bool = True) -> dict:
    """The JAX side: init, two train steps (gradients captured from the
    optimizers) and, ``with_eval``, an eval step; drop path off, one z
    table (the port's ``_port_trainer`` gathers from the same)."""
    table = np.random.default_rng(9).normal(
        size=(helpers.MAX_N_INSTANCES, Z_DIM)).astype(np.float32)
    mp = pytest.MonkeyPatch()
    mp.setattr(jptv3_mod, "PointTransformerV3", _JPTv3NoDropPath)
    mp.setattr(jhelpers, "get_z", lambda key, ins, z_dim, m=table.shape[0]:
               jnp.asarray(table)[(ins % m).astype(jnp.int32)])
    try:
        jt = trainer_cls(jcfg)
        batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
        state = jt.init_state(jax.random.PRNGKey(0), batch)
        init = _np(state)
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
            return state, metrics, captured["g"], captured["d"]

        steps = []
        for _ in range(2):
            state, m, g, d = jstep(state, batch, jax.random.PRNGKey(2))
            steps.append(_np((state, m, g, d)))
        ev = (_np(jax.jit(jt.eval_step)(state, batch, jax.random.PRNGKey(3)))
              if with_eval else None)
    finally:
        mp.undo()
    return dict(cfg=cfg, table=table, batch=batch_np, init=init,
                steps=steps, eval=ev)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX side of the tiny BLDG config, run once."""
    jcfg, cfg = bldg_configs()
    return run_jax(jcfg, cfg, tiny_bldg_batch(cfg))


def _port_trainer(run, monkeypatch):
    table = torch.from_numpy(run["table"])
    monkeypatch.setattr(helpers, "get_z",
                        lambda gen, ins, z_dim, m=table.shape[0]:
                        table[ins.long() % m])
    t = Trainer(run["cfg"], device="cpu")
    ptv3.no_drop_path(t.generator)
    interop.load_train_state(t, run["init"])
    batch = {k: torch.from_numpy(v) for k, v in run["batch"].items()}
    return t, batch


def _close_rel(got, want, what):
    """Every tensor of ``got`` against ``want``'s of the same name."""
    for name in got:
        assert name in want, f"{what}: {name} has no JAX counterpart"
        w = want[name].numpy()
        np.testing.assert_allclose(
            got[name].detach().numpy(), w, rtol=0,
            atol=REL * max(np.abs(w).max(), 1e-30), err_msg=f"{what} {name}")


def _ptv3_stats(state_dict):
    """Copies of PTv3's running statistics."""
    return {k: v.clone() for k, v in state_dict.items()
            if k.startswith("pt_net.") and k.endswith((".mean", ".var"))}


def _g_grads_checked(t, want, what) -> dict:
    """G's gradients against the JAX ones.  A tensor whose JAX gradient
    stays below ZERO_GRAD of the generator's largest (a bias that feeds a
    train-mode BatchNorm: 0 in exact arithmetic) must be as small in the
    port; every other within REL of its largest magnitude.  Returns the
    JAX gradients by name, those that are 0 in exact arithmetic set to 0."""
    got = {n: p.grad for n, p in t.generator.named_parameters()}
    want = {n: want[n] for n in got}
    gmax = max(float(w.abs().max()) for w in want.values())
    zero = {n for n, w in want.items() if w.abs().max() < ZERO_GRAD * gmax}
    assert 0 < len(zero) < len(want) // 2, zero
    for n in zero:
        assert got[n].abs().max() < ZERO_GRAD * gmax, f"{what} {n}"
    _close_rel({n: g for n, g in got.items() if n not in zero}, want, what)
    return {n: torch.zeros_like(w) if n in zero else w
            for n, w in want.items()}


def check_steps_match_jax(t, batch, steps) -> None:
    """Run ``t.train_step(batch)`` once per JAX step of ``steps`` (each
    (state, metrics, G gradients, D gradients) after that step) and hold
    the port to it, as ``TestBldgTrainStep`` sets out."""
    net = t.cfg.network
    lr, mom = t.cfg.train.generator.lr, ptv3.MaskedBatchNorm.MOMENTUM
    stats0 = _ptv3_stats(t.generator.state_dict())
    assert len(stats0) > 10
    held = None
    for i, (state, jm, jg, jd) in enumerate(steps):
        m = t.train_step(batch)
        assert t.step == i + 1 and t.generator.training
        for k, v in jm.items():
            np.testing.assert_allclose(float(m[k]), float(v),
                                       rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                       err_msg=f"step {i} {k}")
        assert float(m["GenLoss"]) > 0 and float(m["DisLoss"]) > 0
        assert int(m["PTv3PoolOverflow"]) == 0
        want_grad = _g_grads_checked(
            t, interop.generator_state_from_flax(jg, net),
            f"step {i} G grad")
        _close_rel(
            {n: p.grad for n, p in t.discriminator.named_parameters()},
            {k: v for k, v in interop.discriminator_state_from_flax(
                jd, state.d_stats).items()
             if not k.endswith((".u", ".sigma"))}, f"step {i} D grad")
        signal = {n: (g.abs() >= ZERO_GRAD * g.abs().max()) & (g != 0)
                  for n, g in want_grad.items()}
        held = signal if held is None else {
            n: held[n] & signal[n] for n in signal}
        want = interop.generator_state_from_flax(
            {"params": state.g_params, "batch_stats": state.g_stats},
            net)
        for n, v in t.generator.state_dict().items():
            w = want[n]
            err = (v - w).abs()
            tol = REL * float(w.abs().max())
            if n in held:
                assert bool((err[held[n]] <= tol).all()), \
                    f"step {i} G weight {n}"
                assert float(err.max()) <= 2 * lr * (i + 1) + tol, \
                    f"step {i} G weight {n}"
            else:  # a running statistic
                slack = mom * 2 * lr * i if n.endswith(".mean") else 0
                assert float(err.max()) <= tol + slack, \
                    f"step {i} batch_stats {n}"
        _close_rel(t.discriminator.state_dict(),
                   interop.discriminator_state_from_flax(
                       state.d_params, state.d_stats), f"step {i} D")
    # the running statistics moved, once per step
    stats = _ptv3_stats(t.generator.state_dict())
    assert any(not torch.equal(stats[k], stats0[k]) for k in stats)


class TestBldgTrainStep:
    def test_two_steps_match_jax_trainer(self, jax_run, monkeypatch):
        """Losses, counters, G and D gradients, the weights after Adam,
        the spectral-norm state and PTv3's running statistics after each
        of two steps.

        Adam divides each gradient element by its own root mean square, so
        an element whose gradient is rounding noise (below ZERO_GRAD of its
        tensor's largest at some step, or in a tensor that is 0 in exact
        arithmetic) moves by Adam's full step, lr, in whichever direction
        the noise points.  Every other element of the weights is held
        within REL of its tensor's largest magnitude; the noise elements
        within 2 lr a step.  A running mean follows its input's bias, so it
        is held within REL plus momentum times that."""
        t, batch = _port_trainer(jax_run, monkeypatch)
        check_steps_match_jax(t, batch, jax_run["steps"])

    def test_eval_step_matches_jax_and_keeps_the_statistics(self, jax_run,
                                                           monkeypatch):
        t, batch = _port_trainer(jax_run, monkeypatch)
        for _ in range(2):
            t.train_step(batch)
        before = _ptv3_stats(t.generator.state_dict())
        metrics, fake = t.eval_step(batch)
        assert not t.generator.training
        want_m, want_fake = jax_run["eval"]
        for k, v in want_m.items():
            np.testing.assert_allclose(float(metrics[k]), float(v),
                                       rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                       err_msg=k)
        np.testing.assert_allclose(fake.numpy(), want_fake, atol=1e-4)
        after = _ptv3_stats(t.generator.state_dict())
        assert all(torch.equal(before[k], after[k]) for k in before)
        # eval normalises with the running statistics: other statistics
        # give another image
        t.generator.pt_net.net.embedding_norm.mean.add_(0.5)
        assert not torch.equal(t.eval_step(batch)[1], fake)


def test_ptv3_overflow_matches_jax():
    """Points outside a small dense-neighbour extent: the port's count
    equals the sum of the JAX package's sown ``nbr_overflow``."""
    cfg = dict(TINY, dense_nbr_extent=48)
    rng = np.random.default_rng(4)
    n, C = 96, 6
    coord = rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
    feat = rng.normal(size=(n, C)).astype(np.float32)
    jmodel = jptv3_mod.PointTransformerV3(cfg=JPTv3Config(**cfg),
                                          in_channels=C)
    args = (jnp.asarray(feat)[None], jnp.asarray(coord)[None])
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), *args)
    _, diag = jax.jit(functools.partial(jmodel.apply,
                                        mutable=["intermediates"]))(
        variables, *args)
    want = sum(int(np.sum(v)) for v in
               jax.tree_util.tree_leaves(diag["intermediates"]))
    model = ptv3.PointTransformerV3(PTv3Config(**cfg), C).eval()
    with torch.no_grad():
        model(torch.from_numpy(feat)[None], torch.from_numpy(coord)[None])
    assert want > 0 and int(model.overflow) == want


def test_car_recipe_runs_a_step():
    """The CAR recipe's structure (KITTI-360 car range, sin/cos, z, PTv3 at
    drop path 0.3) at CPU-test widths takes a finite step."""
    cfg = car_recipe()
    assert cfg.dataset.train_instance_range == (10000, 16384)
    assert cfg.network.ptv3.enabled and cfg.network.z_dim == 256
    cfg = cfg.replace(
        dataset=cfg.dataset.replace(
            sensor_size=(256, 64), train_crop_size=(128, 32), proj_size=32,
            cam_k=(100.0, 0, 128.0, 0, 100.0, 32.0, 0, 0, 1),
            flip_ud=False),
        network=cfg.network.replace(
            z_dim=8, mlp_hidden_dim=16, dis_n_channel_base=8,
            sin_cos_freq_bends=2,
            ptv3=PTv3Config(
                enabled=True, stride=(2,), enc_depths=(1, 1),
                enc_channels=(8, 16), enc_n_head=(1, 2),
                enc_patch_size=(16, 16), dec_depths=(1,),
                dec_channels=(8,), dec_n_head=(1,), dec_patch_size=(16,))),
        rasterizer=cfg.rasterizer.replace(tile_capacity=128),
        train=cfg.train.replace(perceptual_loss_layers=("relu_1_1",),
                                perceptual_loss_weights=(1.0,)))
    t = Trainer(cfg, device="cpu")
    assert t.generator.pt_net.net.enc1_block0.drop_path == 0.3
    batch = {k: torch.from_numpy(v)
             for k, v in tiny_bldg_batch(cfg).items()}
    batch["pts"][..., 4] = torch.randint(
        10000, 10050, batch["pts"].shape[:2],
        generator=torch.Generator().manual_seed(1)).float()
    m = t.train_step(batch)
    assert t.step == 1
    for k, v in m.items():
        assert np.isfinite(float(v)), k


class TestDropPath:
    def test_rates_match_jax_schedule(self):
        """Every block's rate, decoder order too, as the JAX package
        builds them (read from its modules as they are called)."""
        cfg = dict(TINY, enc_depths=(2, 1, 3), dec_depths=(2, 3))
        jmodel = jptv3_mod.PointTransformerV3(cfg=JPTv3Config(**cfg),
                                              in_channels=4)
        want = {}

        def record(next_fun, args, kwargs, context):
            if isinstance(context.module, jptv3_mod.PTBlock):
                want[context.module.name] = context.module.drop_path
            return next_fun(*args, **kwargs)

        with fnn.intercept_methods(record):
            jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                           jnp.zeros((1, 64, 4)), jnp.zeros((1, 64, 3)))
        model = ptv3.PointTransformerV3(PTv3Config(**cfg), 4)
        got = {name.split(".")[-1]: m.drop_path
               for name, m in model.named_modules()
               if isinstance(m, ptv3.PTBlock)}
        assert len(got) == 11 and got.keys() == want.keys()
        for name in want:
            assert got[name] == pytest.approx(want[name], abs=1e-12), name
        # the decoder's slice-then-reverse: stage 1 holds the ramp's last
        # three rates reversed, stage 0 its first two reversed
        assert [got[f"dec1_block{b}"] for b in range(3)] == pytest.approx(
            [0.3, 0.225, 0.15])
        assert [got[f"dec0_block{b}"] for b in range(2)] == pytest.approx(
            [0.075, 0.0])

    def test_keeps_one_minus_p_scaled_and_seeded(self):
        block = ptv3.PTBlock(4, 1, 8, 2.0, 0, False, drop_path=0.3).train()
        x = torch.ones((20000, 4))

        def draw(seed):
            return block._drop_path(x, torch.Generator().manual_seed(seed))

        y = draw(0)
        kept = y[:, 0] != 0
        assert abs(float(kept.float().mean()) - 0.7) < 0.02
        assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.7))
        assert (y == y[:, :1]).all()  # one mask value per point
        assert torch.equal(draw(0), y) and not torch.equal(draw(1), y)
        with pytest.raises(ValueError, match="Generator"):
            block._drop_path(x, None)
        assert block.eval()._drop_path(x, None) is x

    def test_model_output_fixed_by_seed_identity_in_eval(self):
        rng = np.random.default_rng(2)
        feat = torch.from_numpy(rng.normal(size=(1, 80, 6))
                                .astype(np.float32))
        coord = torch.from_numpy(rng.uniform(-0.3, 0.3, (1, 80, 3))
                                 .astype(np.float32))
        model = ptv3.PointTransformerV3(PTv3Config(**TINY), 6)

        def run(seed=None):
            gen = None if seed is None else torch.Generator().manual_seed(
                seed)
            with torch.no_grad():
                return model(feat, coord, dp_generator=gen)

        a = run(5)  # training mode normalises with the batch statistics
        assert torch.equal(run(5), a) and not torch.equal(run(6), a)
        model.eval()
        b = run()
        assert torch.equal(run(5), b) and not torch.equal(b, a)


def test_shuffle_orders_permutes_the_serialization_orders():
    """With a shuffle generator and two orders, the order rows are
    permuted once after serializing and once after each pooling, and a
    pooled level inherits its parent's rows, as in the JAX package: a
    swap then two identities equals the model with its orders reversed,
    three identities the model as it is.  One order, or shuffle_orders
    False: no change."""
    rng = np.random.default_rng(3)
    feat = torch.from_numpy(rng.normal(size=(1, 90, 5)).astype(np.float32))
    coord = torch.from_numpy(rng.uniform(-0.3, 0.3, (1, 90, 3))
                             .astype(np.float32))
    cfg = PTv3Config(**dict(TINY, order=("cord", "z")))
    model = ptv3.PointTransformerV3(cfg, 5).eval()
    reversed_model = ptv3.PointTransformerV3(
        cfg.replace(order=("z", "cord")), 5).eval()
    reversed_model.load_state_dict(model.state_dict())

    def draws(seed):
        g = torch.Generator().manual_seed(seed)
        return [torch.randperm(2, generator=g).tolist() for _ in range(3)]

    with torch.no_grad():
        plain = model(feat, coord)
        flipped = reversed_model(feat, coord)
        assert not torch.equal(plain, flipped)
        swap = next(s for s in range(200)
                    if draws(s) == [[1, 0], [0, 1], [0, 1]])
        same = next(s for s in range(200) if draws(s) == [[0, 1]] * 3)
        for seed, want in ((swap, flipped), (same, plain)):
            got = model(feat, coord,
                        shuffle_generator=torch.Generator().manual_seed(seed))
            assert torch.equal(got, want), seed
        one = ptv3.PointTransformerV3(PTv3Config(**TINY), 5).eval()
        off = ptv3.PointTransformerV3(cfg.replace(shuffle_orders=False),
                                      5).eval()
        off.load_state_dict(model.state_dict())
        gen = torch.Generator().manual_seed(swap)
        assert torch.equal(one(feat, coord, shuffle_generator=gen),
                           one(feat, coord))
        gen = torch.Generator().manual_seed(swap)
        assert torch.equal(off(feat, coord, shuffle_generator=gen), plain)


class TestStepRandomness:
    def test_step_generators_and_no_global_rng(self):
        """(seed, step) fixes the step's generators; torch's global RNG
        changes nothing in a step."""
        _, cfg = bldg_configs()
        t = Trainer(cfg, device="cpu", seed=4)
        za, dpa = (g.initial_seed() for g in t.step_generators(3))
        zb, dpb = (g.initial_seed() for g in t.step_generators(3))
        assert (za, dpa) == (zb, dpb) and za != dpa
        assert t.step_generators(4)[0].initial_seed() != za
        other_seed = types.SimpleNamespace(seed=5, device=t.device)
        assert Trainer.step_generators(other_seed, 3)[0].initial_seed() != za
        batch = {k: torch.from_numpy(v)
                 for k, v in tiny_bldg_batch(cfg).items()}
        start = copy.deepcopy(t.state_dict())
        runs = []
        for global_seed in (0, 1):
            torch.manual_seed(global_seed)
            t.load_state_dict(copy.deepcopy(start))
            runs.append({k: float(v) for k, v in t.train_step(batch).items()})
        assert runs[0] == runs[1]

    def test_get_z_needs_a_generator_on_the_points_device(self):
        ins = torch.tensor([[0, 5, 16384 + 5]])
        with pytest.raises(ValueError, match="Generator"):
            helpers.get_z(None, ins, 4)
        z = helpers.get_z(torch.Generator().manual_seed(0), ins, 4)
        assert z.shape == (1, 3, 4) and torch.equal(z[0, 1], z[0, 2])
        assert helpers.get_z(None, ins, None) is None
