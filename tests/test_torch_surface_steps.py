# -*- coding: utf-8 -*-
"""PyTorch port vs the JAX package: two tiny bf16 train steps against the
JAX ``Trainer`` (compiled without excess precision, ``strict_compile``;
see ``test_torch_model_surface.py`` for why), and PTv3 in training mode
at batch size 2 against the JAX ``nn.vmap``."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from gaussiancity_tpu.config import PTv3Config as JPTv3Config
from gaussiancity_tpu.models import ptv3 as jptv3
from gaussiancity_tpu.training.step import Trainer as JTrainer

from gaussiancity_tpu_torch import interop
from gaussiancity_tpu_torch.config import Config, PTv3Config
from gaussiancity_tpu_torch.models import ptv3
from gaussiancity_tpu_torch.testing import TINY_PTV3 as TINY
from gaussiancity_tpu_torch.training.step import Trainer
from test_torch_model_surface import BF16_GRAD_RTOL, _max_err
from test_torch_models import strict_compile
from test_torch_training import _np
from test_train_step import synthetic_batch, tiny_config

# float32 sums in another order than XLA's (the B = 2 PTv3 step)
ATOL, RTOL = 1e-5, 1e-4


def _bf16_trainer_pair():
    """The tiny REST config with ``network.compute_dtype`` and
    ``train.compute_dtype`` bf16: the JAX Trainer (strict, its optimizers'
    gradients captured) and the port's Trainer on the CPU, same weights."""
    jcfg = tiny_config()
    jcfg = jcfg.replace(
        network=jcfg.network.replace(compute_dtype="bfloat16"),
        train=jcfg.train.replace(
            compute_dtype="bfloat16",
            discriminator=jcfg.train.discriminator.replace(
                n_warmup_iters=1)))
    cfg = Config.from_dict(jcfg.to_dict())
    jt = JTrainer(jcfg)
    batch = synthetic_batch(jax.random.PRNGKey(1), jcfg)
    state = jt.init_state(jax.random.PRNGKey(0), batch)
    captured = {}

    def capture(tx, key):
        def update(grads, opt_state, params=None):
            captured[key] = grads
            return tx.update(grads, opt_state, params)
        return optax.GradientTransformation(tx.init, update)

    jt.g_tx = capture(jt.g_tx, "g")
    jt.d_tx = capture(jt.d_tx, "d")

    def jstep(state, batch, rng):
        state, metrics = jt.train_step(state, batch, rng)
        return state, metrics, captured["g"], captured["d"]

    t = Trainer(cfg, device="cpu")
    interop.load_train_state(t, _np(state))
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    return jstep, state, batch, t, tbatch


class TestBfloat16TrainStep:
    def test_two_steps_match_jax_trainer(self):
        """Two D + G updates of the tiny REST config in bf16 against the
        JAX Trainer in bf16.  The losses within 1e-3 relative (they
        average bf16 features).  A bf16 backward rounds its cotangents
        where each autodiff puts its ops, and a bias gradient sums a whole
        map of bf16 cotangents, so the gradients are held to the bf16
        noise itself: each within 4 bf16 ulps of its largest value, or
        within twice the distance of the JAX bf16 gradient from the
        float32 gradient (the port's float32 step, which equals the JAX
        float32 step: ``test_torch_training.py``).  The weights after
        Adam within lr / 2 (Adam's first steps are about lr times the
        sign of the gradient) at the entries whose JAX bf16 gradient is
        over twice its distance from the float32 one and over 1e-6."""
        jstep, state, batch, t, tbatch = _bf16_trainer_pair()
        assert t.discriminator.enc1.compute_dtype == torch.bfloat16
        assert t.ploss.model.compute_dtype == torch.bfloat16
        assert t.generator.ga_mlp.fc_1.compute_dtype == torch.bfloat16
        t32 = Trainer(t.cfg.replace(
            network=t.cfg.network.replace(compute_dtype="float32"),
            train=t.cfg.train.replace(compute_dtype="float32")),
            device="cpu")
        t32.load_state_dict(t.state_dict())
        jstep = strict_compile(jstep, state, batch, jax.random.PRNGKey(2))
        lr = t.cfg.train.generator.lr
        for i in range(2):
            state, jm, jg, jd = jstep(state, batch, jax.random.PRNGKey(2))
            t32.load_state_dict(t.state_dict())
            t32.train_step(tbatch)
            m = t.train_step(tbatch)
            for k in ("DisLoss", "GANLossFake", "GANLossReal", "GenLoss",
                      "L1Loss", "PerceptualLoss", "GANLoss"):
                np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                           rtol=1e-3, err_msg=k)
            want_g = interop.generator_state_from_flax(_np(jg),
                                                       t.cfg.network)
            want_d = interop.discriminator_state_from_flax(
                _np(jd), _np(state.d_stats))
            firm = {}
            for port, port32, want in (
                    (t.generator, t32.generator, want_g),
                    (t.discriminator, t32.discriminator, want_d)):
                g32 = {n: p.grad.numpy() for n, p in
                       port32.named_parameters()}
                for name, p in port.named_parameters():
                    w = want[name].numpy()
                    noise = np.abs(w - g32[name]).max()
                    tol = max(BF16_GRAD_RTOL * np.abs(w).max(), 2 * noise)
                    assert _max_err(p.grad, w) <= tol, (i, name)
                    firm[name] = ((np.abs(w) > 2 * np.abs(w - g32[name]))
                                  & (np.abs(w) > 1e-6))
            want_p = interop.generator_state_from_flax(_np(state.g_params),
                                                       t.cfg.network)
            for n, p in t.generator.named_parameters():
                err = np.abs(p.detach().numpy() - want_p[n].numpy())
                assert err[firm[n]].max(initial=0) <= 0.5 * lr, (i, n)


def _batch2(seed=0, n=96, n_pad=32):
    """Two samples of ``n`` rows; the second has ``n_pad`` masked rows."""
    rng = np.random.default_rng(seed)
    feat = rng.normal(size=(2, n, 6)).astype(np.float32)
    coord = rng.uniform(-0.15, 0.15, (2, n, 3)).astype(np.float32)
    valid = np.ones((2, n), bool)
    valid[1, n - n_pad:] = False
    coord[1, n - n_pad:] = 9.0  # far away: they must not matter
    return feat, coord, valid


class TestPTv3Batch2Training:
    def test_train_step_matches_jax_vmap(self):
        """PTv3 in training mode at B = 2 (drop path 0) against the JAX
        ``nn.vmap`` whose BatchNorm ``psum``s span the samples: the output
        on valid rows, the running statistics after the step, and the
        gradients of every parameter and of the input features, within
        1e-5 + 1e-4 relative (outputs, statistics) and 1e-4 of each
        gradient's largest.  A bias that feeds a train-mode BatchNorm has
        gradient 0 in exact arithmetic: in both packages it is rounding
        noise, held below 1e-6 of the largest gradient of the model.
        Masked rows come back 0 with no gradient."""
        feat, coord, valid = _batch2()
        C = feat.shape[-1]
        ct = np.random.default_rng(7).normal(
            size=(2, feat.shape[1], 8)).astype(np.float32)
        jm = jptv3.PointTransformerV3(cfg=JPTv3Config(**TINY),
                                      in_channels=C, drop_path=0.0)
        jargs = (jnp.asarray(feat), jnp.asarray(coord), jnp.asarray(valid))
        variables = _np(jax.jit(jm.init)(jax.random.PRNGKey(3), *jargs))
        rng = np.random.default_rng(4)
        variables["batch_stats"] = jax.tree_util.tree_map(
            lambda a: rng.uniform(0.5, 2.0, a.shape).astype(np.float32),
            variables["batch_stats"])

        def loss(params, x):
            out, upd = jm.apply({"params": params,
                                 "batch_stats": variables["batch_stats"]},
                                x, jargs[1], jargs[2], True,
                                mutable=["batch_stats"])
            out = jnp.where(jargs[2][..., None], out, 0.0)
            return jnp.sum(out * ct), (out, upd["batch_stats"])

        (_, (want, want_stats)), (g_params, g_feat) = jax.jit(
            jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
                variables["params"], jargs[0])

        model = ptv3.PointTransformerV3(PTv3Config(**TINY), C,
                                        drop_path=0.0)
        state = interop.ptv3_state_from_flax(variables["params"])
        interop.ptv3_state_from_flax(variables["batch_stats"], "", state)
        model.load_state_dict(state)
        model.train()
        x = torch.from_numpy(feat).requires_grad_(True)
        got = model(x, torch.from_numpy(coord), torch.from_numpy(valid))
        (got * torch.from_numpy(ct)).sum().backward()
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy()[valid],
                                   want[valid], atol=ATOL, rtol=RTOL)
        assert (got.detach().numpy()[~valid] == 0).all()
        stats = interop.ptv3_state_from_flax(_np(want_stats))
        for name, value in model.state_dict().items():
            if name.endswith((".mean", ".var")):
                np.testing.assert_allclose(value.numpy(),
                                           stats[name].numpy(), atol=ATOL,
                                           rtol=RTOL, err_msg=name)
                assert not np.allclose(value.numpy(),
                                       state[name].numpy()), name
        want_g = interop.ptv3_state_from_flax(_np(g_params))
        top = max(float(np.abs(w.numpy()).max()) for w in want_g.values())
        for name, p in model.named_parameters():
            w = want_g[name].numpy()
            if np.abs(w).max() < 1e-6 * top:
                assert float(p.grad.abs().max()) < 1e-6 * top, name
                continue
            np.testing.assert_allclose(
                p.grad.numpy(), w, rtol=0,
                atol=1e-4 * max(np.abs(w).max(), 1e-30), err_msg=name)
        g_feat = np.asarray(g_feat)
        np.testing.assert_allclose(x.grad.numpy(), g_feat, rtol=0,
                                   atol=1e-4 * np.abs(g_feat).max())
        assert (x.grad.numpy()[~valid] == 0).all()

    def test_eval_batch_equals_samples_alone(self):
        """In eval mode a packed batch of two gives each sample what it
        gives alone, to the bit."""
        feat, coord, valid = _batch2(1)
        model = ptv3.PointTransformerV3(PTv3Config(**TINY), 6).eval()
        with torch.no_grad():
            both = model(torch.from_numpy(feat), torch.from_numpy(coord),
                         torch.from_numpy(valid))
            for b in range(2):
                alone = model(torch.from_numpy(feat[b:b + 1]),
                              torch.from_numpy(coord[b:b + 1]),
                              torch.from_numpy(valid[b:b + 1]))
                assert torch.equal(alone[0], both[b]), b
