# -*- coding: utf-8 -*-
"""PyTorch port vs the JAX package: the discriminator with its spectral-
norm state, the GAN, L1 and perceptual losses, and the REST GAN train step
(two steps of the tiny config of test_train_step.py from the same weights,
carried across by ``interop``).  Also: the train-state checkpoint, the
random-VGG gate, and that the port imports nothing of JAX."""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gaussiancity_tpu.losses import gan_loss as jgan_loss
from gaussiancity_tpu.losses import masked_l1 as jmasked_l1
from gaussiancity_tpu.losses.perceptual import PerceptualLoss as JPLoss
from gaussiancity_tpu.models import Discriminator as JDiscriminator
from gaussiancity_tpu.training.step import Trainer as JTrainer

from gaussiancity_tpu_torch import interop
from gaussiancity_tpu_torch.config import Config
from gaussiancity_tpu_torch.losses import gan_loss, masked_l1
from gaussiancity_tpu_torch.losses.perceptual import (
    PerceptualLoss, check_vgg_weights)
from gaussiancity_tpu_torch.models.discriminator import Discriminator
from gaussiancity_tpu_torch.training import checkpoint
from gaussiancity_tpu_torch.training.step import Trainer
from test_train_step import synthetic_batch, tiny_config

REPO = pathlib.Path(__file__).resolve().parents[1]

# float32 convolutions and sums taken in another order than XLA's
ATOL, RTOL = 1e-5, 1e-4
# gradients after a render, a discriminator and a VGG trunk: tolerance
# relative to each gradient's largest magnitude
GRAD_RTOL = 1e-4


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _images(seed, H=32, W=128):
    rng = np.random.default_rng(seed)
    img = rng.uniform(-1, 1, (1, H, W, 3)).astype(np.float32)
    seg = np.eye(8, dtype=np.float32)[rng.integers(0, 8, (1, H, W))]
    msk = (rng.random((1, H, W, 1)) > 0.1).astype(np.float32)
    return img, seg, msk


class TestDiscriminator:
    @pytest.mark.parametrize("shape", [(32, 128), (24, 40)])
    def test_forward_and_sn_state_match_flax(self, shape):
        img, seg, msk = _images(0, *shape)
        jd = JDiscriminator(n_channel_base=8, n_classes=8)
        jargs = [jnp.asarray(a) for a in (img, seg, msk)]
        v = _np(jd.init(jax.random.PRNGKey(0), *jargs))
        want, vs = jd.apply(v, *jargs, mutable=["batch_stats"])
        d = Discriminator(8, 8)
        d.load_state_dict(interop.discriminator_state_from_flax(
            v["params"], v["batch_stats"]))
        with torch.no_grad():
            got = d(*(torch.from_numpy(a) for a in (img, seg, msk)))
        np.testing.assert_allclose(got["pred"].numpy(),
                                   np.asarray(want["pred"]), atol=ATOL,
                                   rtol=RTOL)
        np.testing.assert_array_equal(got["label"].numpy(),
                                      np.asarray(want["label"]))
        # one power step on the call: u and sigma as flax stores them
        new = interop.discriminator_state_from_flax(v["params"],
                                                    _np(vs["batch_stats"]))
        state = d.state_dict()
        for name in new:
            if name.endswith((".u", ".sigma")):
                np.testing.assert_allclose(state[name].numpy(),
                                           new[name].numpy(), atol=ATOL,
                                           rtol=RTOL, err_msg=name)
                old = interop.discriminator_state_from_flax(
                    v["params"], v["batch_stats"])[name]
                assert not torch.equal(old, new[name]), name


class TestLosses:
    def test_gan_and_l1_match_jax(self):
        rng = np.random.default_rng(1)
        pred = rng.normal(size=(1, 8, 32, 9)).astype(np.float32)
        label = np.eye(8, dtype=np.float32)[rng.integers(0, 8, (1, 8, 32))]
        w = (rng.random((1, 8, 32, 1)) > 0.2).astype(np.float32)
        for t_real, dis_update in ((True, True), (False, True),
                                   (True, False)):
            want = jgan_loss(jnp.asarray(pred), jnp.asarray(label), t_real,
                             jnp.asarray(w), dis_update=dis_update)
            got = gan_loss(torch.from_numpy(pred), torch.from_numpy(label),
                           t_real, torch.from_numpy(w),
                           dis_update=dis_update)
            np.testing.assert_allclose(float(got), float(want), rtol=RTOL)
        with pytest.raises(ValueError):
            gan_loss(torch.from_numpy(pred), torch.from_numpy(label), False,
                     dis_update=False)
        a, b, m = _images(2)
        np.testing.assert_allclose(
            float(masked_l1(torch.from_numpy(a), torch.from_numpy(b[..., :3]),
                            torch.from_numpy(m))),
            float(jmasked_l1(jnp.asarray(a), jnp.asarray(b[..., :3]),
                             jnp.asarray(m))), rtol=RTOL)

    def test_perceptual_matches_jax(self):
        layers, weights = ("relu_1_1", "relu_2_1", "relu_2_2"), (0.5, 1, 2)
        jp = JPLoss(layers=layers, weights=weights)
        params = _np(jp.init(jax.random.PRNGKey(1)))
        tp = PerceptualLoss(layers=layers, weights=weights)
        tp.model.load_state_dict(interop.vgg_state_from_flax(params))
        a, _, _ = _images(3)
        b, _, _ = _images(4)
        ta = torch.from_numpy(a).requires_grad_(True)
        got = tp(ta, torch.from_numpy(b))
        want, want_g = jax.value_and_grad(
            lambda x: jp(params, x, jnp.asarray(b)))(jnp.asarray(a))
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=RTOL)
        got.backward()
        np.testing.assert_allclose(
            ta.grad.numpy(), np.asarray(want_g), rtol=0,
            atol=GRAD_RTOL * np.abs(np.asarray(want_g)).max())

    def test_random_vgg_gate(self, monkeypatch):
        monkeypatch.delenv("GAUSSIANCITY_VGG19_NPZ", raising=False)
        monkeypatch.delenv("GAUSSIANCITY_ALLOW_RANDOM_VGG", raising=False)
        with pytest.raises(ValueError, match="RANDOM VGG"):
            check_vgg_weights(10.0, allow_random_vgg=False)
        assert check_vgg_weights(10.0, allow_random_vgg=True) is None
        assert check_vgg_weights(0.0, allow_random_vgg=False) is None


def _trainer_pair():
    """The JAX Trainer (with its optimizers' gradients captured) and the
    port's Trainer on the CPU, from the same weights."""
    jcfg = tiny_config()
    jcfg = jcfg.replace(train=jcfg.train.replace(
        discriminator=jcfg.train.discriminator.replace(n_warmup_iters=1)))
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

    @jax.jit
    def jstep(state, batch, rng):
        state, metrics = jt.train_step(state, batch, rng)
        return state, metrics, captured["g"], captured["d"]

    t = Trainer(cfg, device="cpu")
    t.generator.load_state_dict(interop.generator_state_from_flax(
        _np(state.g_params), cfg.network))
    t.discriminator.load_state_dict(interop.discriminator_state_from_flax(
        _np(state.d_params), _np(state.d_stats)))
    t.ploss.model.load_state_dict(interop.vgg_state_from_flax(
        _np(state.ploss_params)))
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    return jstep, state, batch, t, tbatch


def _assert_close_rel(got, want, what):
    for name, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(
            got[name].numpy(), w, rtol=0,
            atol=GRAD_RTOL * max(np.abs(w).max(), 1e-30),
            err_msg=f"{what} {name}")


class TestTrainStep:
    def test_two_steps_match_jax_trainer(self):
        jstep, state, batch, t, tbatch = _trainer_pair()
        d0 = {k: v.clone() for k, v in t.discriminator.state_dict().items()}
        for i in range(2):
            state, jm, jg, jd = jstep(state, batch, jax.random.PRNGKey(2))
            m = t.train_step(tbatch)
            assert t.step == i + 1
            for k in ("DisLoss", "GANLossFake", "GANLossReal", "GenLoss",
                      "L1Loss", "PerceptualLoss", "GANLoss",
                      "RasterDroppedPairs", "RasterTruncated",
                      "RasterGradTruncated"):
                np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                           rtol=RTOL, atol=ATOL, err_msg=k)
            assert float(m["GenLoss"]) > 0 and float(m["DisLoss"]) > 0
            _assert_close_rel(
                {n: p.grad for n, p in t.generator.named_parameters()},
                interop.generator_state_from_flax(_np(jg), t.cfg.network),
                f"step {i} G grad")
            # D's gradients come from the D loss alone
            _assert_close_rel(
                {n: p.grad for n, p in t.discriminator.named_parameters()},
                {k: v for k, v in interop.discriminator_state_from_flax(
                    _np(jd), _np(state.d_stats)).items()
                 if not k.endswith((".u", ".sigma"))},
                f"step {i} D grad")
            # weights and SN state after the step; Adam moves a weight by
            # about lr, and by a gradient-sensitive fraction of lr where
            # the gradient is near eps
            want_g = interop.generator_state_from_flax(_np(state.g_params),
                                                       t.cfg.network)
            for n, p in t.generator.named_parameters():
                np.testing.assert_allclose(
                    p.detach().numpy(), want_g[n].numpy(), rtol=0,
                    atol=1e-3 * t.cfg.train.generator.lr,
                    err_msg=f"step {i} G params {n}")
            _assert_close_rel(
                t.discriminator.state_dict(),
                interop.discriminator_state_from_flax(
                    _np(state.d_params), _np(state.d_stats)),
                f"step {i} D state")
            if i == 0:
                # the first D update has learning rate 0: weights stay
                for name, p in t.discriminator.named_parameters():
                    assert torch.equal(p.detach(), d0[name]), name
                    assert p.grad.abs().max() > 0, name

    def test_bfloat16_compute_raises(self):
        """Kept by name: train.compute_dtype "bfloat16" now builds D and
        the perceptual loss in bf16, as the JAX Trainer does
        (``test_torch_model_surface.py`` holds two bf16 steps to it); the
        generator stays float32 unless network.compute_dtype says
        otherwise, parameters stay float32, and an unknown dtype raises."""
        cfg = Config.from_dict(tiny_config().to_dict())
        bf16 = cfg.replace(train=cfg.train.replace(compute_dtype="bfloat16"))
        t = Trainer(bf16, device="cpu")
        assert t.discriminator.enc1.compute_dtype == torch.bfloat16
        assert t.ploss.model.compute_dtype == torch.bfloat16
        assert t.generator.ga_mlp.fc_1.compute_dtype is None
        assert all(p.dtype == torch.float32 for p in
                   list(t.discriminator.parameters())
                   + list(t.generator.parameters()))
        assert Trainer(cfg, device="cpu").discriminator.enc1.compute_dtype \
            is None
        with pytest.raises(ValueError, match="compute_dtype"):
            Trainer(cfg.replace(train=cfg.train.replace(
                compute_dtype="float16")), device="cpu")

    def test_checkpoint_roundtrip(self, tmp_path):
        _, _, _, t, tbatch = _trainer_pair()
        t.train_step(tbatch)
        path = str(tmp_path / "ckpt" / "state.pt")
        checkpoint.save_checkpoint(path, t)
        t2 = Trainer(t.cfg, device="cpu", seed=7)
        cfg = checkpoint.load_checkpoint(path, t2)
        assert cfg == t.cfg and t2.step == 1
        for a, b in ((t.generator, t2.generator),
                     (t.discriminator, t2.discriminator)):
            for (n, x), (_, y) in zip(a.state_dict().items(),
                                      b.state_dict().items()):
                assert torch.equal(x, y), n
        m1, m2 = t.train_step(tbatch), t2.train_step(tbatch)
        for k in m1:
            assert float(m1[k]) == float(m2[k]), k


_FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "gaussiancity_tpu")


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_no_jax():
    files = sorted((REPO / "gaussiancity_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    for path in files:
        bad = set(_imported_roots(path)) & set(_FORBIDDEN)
        assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"
