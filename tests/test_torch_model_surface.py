# -*- coding: utf-8 -*-
"""PyTorch port vs the JAX package: the bfloat16 compute of the generator,
the discriminator and the perceptual loss (the bf16 train steps and PTv3
at batch size 2 are in ``test_torch_surface_steps.py``).

The JAX side of every bf16 comparison is compiled without XLA's excess
precision (``strict_jit``), so that it rounds to bf16 wherever the program
says; by default XLA's CPU fusions may keep float32 between ops, which is
a compiler's liberty, not the program.  Against that, the port's bf16
forward is bit-equal layer by layer, except where a float32 sum taken in
another order lands on the other side of a bf16 rounding boundary: one
such flip moves everything downstream by about one bf16 ulp (2^-8 of a
value).  The tolerances below count those ulps."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gaussiancity_tpu.losses.perceptual import PerceptualLoss as JPLoss
from gaussiancity_tpu.models import Discriminator as JDiscriminator

from gaussiancity_tpu_torch import interop
from gaussiancity_tpu_torch.losses.perceptual import PerceptualLoss
from gaussiancity_tpu_torch.models.discriminator import Discriminator
from gaussiancity_tpu_torch.testing import share_cpu_cores
from test_torch_models import _generator_pair, strict_jit
from test_torch_training import _images, _np

share_cpu_cores()

BF16_ULP = 2.0 ** -8
# a bf16 forward through PTv3: a few flipped roundings, each moving the
# outputs by about one ulp; 8 ulps of the largest output
BF16_OUT_RTOL = 8 * BF16_ULP
# bf16 backward passes: the JAX transposes and torch's backward formulas
# round their bf16 cotangents at different ops; 4 ulps of the largest
BF16_GRAD_RTOL = 4 * BF16_ULP


def _max_err(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max())


class TestBfloat16Models:
    def test_bldg_generator_matches_jax(self):
        """The BLDG shape (sin/cos, style z, the small PTv3) in bf16, in
        eval mode with random running statistics: within 8 bf16 ulps of
        the largest attribute, and not the float32 result."""
        gen, targs, want = _generator_pair("bldg", compute_dtype="bfloat16")
        with torch.no_grad():
            got = gen(*targs)
        f32, _, _ = _generator_pair("bldg")
        with torch.no_grad():
            got32 = f32(*targs)
        for k in want:
            w = np.asarray(want[k])
            assert got[k].dtype == torch.float32
            assert _max_err(got[k], w) <= BF16_OUT_RTOL * np.abs(w).max(), k
            assert _max_err(got[k], got32[k]) > 1e-4, k

    def test_discriminator_and_perceptual_loss_match_jax(self):
        """D in bf16: the bf16 features bit-equal, so the float32 output
        conv's prediction within 1e-6 and the spectral-norm state within
        1e-5.  The perceptual loss in bf16 at criterion "l2" over two
        scales: the loss within 1e-5 relative, its input gradient within
        4 bf16 ulps of the largest."""
        img, seg, msk = _images(0, 32, 128)
        jd = JDiscriminator(n_channel_base=8, n_classes=8,
                            dtype=jnp.bfloat16)
        jargs = [jnp.asarray(a) for a in (img, seg, msk)]
        v = _np(jd.init(jax.random.PRNGKey(0), *jargs))
        want, vs = strict_jit(
            lambda vv, *a: jd.apply(vv, *a, mutable=["batch_stats"]), v,
            *jargs)
        d = Discriminator(8, 8, dtype=torch.bfloat16)
        d.load_state_dict(interop.discriminator_state_from_flax(
            v["params"], v["batch_stats"]))
        with torch.no_grad():
            got = d(*(torch.from_numpy(a) for a in (img, seg, msk)))
        assert got["pred"].dtype == torch.float32
        assert _max_err(got["pred"], want["pred"]) <= 1e-6
        np.testing.assert_array_equal(got["label"].numpy(),
                                      np.asarray(want["label"]))
        new = interop.discriminator_state_from_flax(v["params"],
                                                    _np(vs["batch_stats"]))
        for name, value in d.state_dict().items():
            if name.endswith((".u", ".sigma")):
                np.testing.assert_allclose(value.numpy(), new[name].numpy(),
                                           atol=1e-5, rtol=1e-4)

        layers, weights = ("relu_1_1", "relu_2_1", "relu_2_2"), (0.5, 1, 2)
        kw = dict(layers=layers, weights=weights, criterion="l2",
                  num_scales=2)
        jp = JPLoss(**kw, dtype=jnp.bfloat16)
        params = _np(jp.init(jax.random.PRNGKey(1)))
        tp = PerceptualLoss(**kw, dtype=torch.bfloat16)
        tp.model.load_state_dict(interop.vgg_state_from_flax(params))
        a, _, _ = _images(3)
        b, _, _ = _images(4)
        want, want_g = strict_jit(
            lambda p, x, y: jax.value_and_grad(lambda xx: jp(p, xx, y))(x),
            params, jnp.asarray(a), jnp.asarray(b))
        ta = torch.from_numpy(a).requires_grad_(True)
        got = tp(ta, torch.from_numpy(b))
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-5)
        want_g = np.asarray(want_g)
        assert _max_err(ta.grad, want_g) <= \
            BF16_GRAD_RTOL * np.abs(want_g).max()
