# -*- coding: utf-8 -*-
"""PyTorch port vs the JAX package: the hash-grid encoder and the REST
generator, with the JAX parameters built by ``init`` and carried across by
``interop.generator_state_from_flax``.  Inputs are made with numpy from a
seed and fed to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiancity_tpu.config import GaussianNetworkConfig as JNetConfig
from gaussiancity_tpu.config import PTv3Config as JPTv3Config
from gaussiancity_tpu.models import Generator as JGenerator
from gaussiancity_tpu.ops import hash_grid as jhash

from gaussiancity_tpu_torch import interop
from gaussiancity_tpu_torch.config import Config, GaussianNetworkConfig
from gaussiancity_tpu_torch.config import PTv3Config, rest_recipe
from gaussiancity_tpu_torch.models.generator import Generator
from gaussiancity_tpu_torch.ops import hash_grid

# float32 sums of up to 2^D corner products and matmuls taken in another
# order than XLA's
ATOL, RTOL = 1e-5, 1e-4

GRID_CASES = {
    # in_channels, n_levels, base_res, desired_res, log2 rows
    "xyz_dense_and_hashed": (3, 4, 4, 64, 8),
    "rest_5d": (5, 3, 16, 64, 10),
}


class TestHashGrid:
    @pytest.mark.parametrize("case", sorted(GRID_CASES))
    def test_encoder_matches_jax(self, case):
        D, L, base, desired, log2 = GRID_CASES[case]
        _, _, _, hashed, _ = hash_grid.level_params(D, L, base, desired,
                                                    log2)
        assert hash_grid.level_params(D, L, base, desired, log2) == \
            tuple(jhash.level_params(D, L, base, desired, log2))
        if case == "xyz_dense_and_hashed":
            assert not hashed[0] and hashed[-1]
        shape = hash_grid.table_shape(D, L, base, desired, log2, 2)
        assert shape == jhash.table_shape(D, L, base, desired, log2, 2)
        rng = np.random.default_rng(0)
        emb = rng.uniform(-1, 1, shape).astype(np.float32)
        # a few points outside [-1, 1] give zeros in both
        x = rng.uniform(-1.05, 1.05, (2, 300, D)).astype(np.float32)
        jenc = jhash.GridEncoder(in_channels=D, n_levels=L, lvl_channels=2,
                                 desired_resolution=desired,
                                 base_resolution=base,
                                 log2_hashmap_size=log2)
        want = jenc.apply({"params": {"embeddings": jnp.asarray(emb)}},
                          jnp.asarray(x))
        enc = hash_grid.GridEncoder(D, L, 2, desired, base, log2)
        enc.load_state_dict({"embeddings": torch.from_numpy(emb)})
        with torch.no_grad():
            got = enc(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=RTOL)
        assert np.abs(np.asarray(want)).max() > 0.1

    def test_hash_wraps_like_uint32(self):
        # products of large lattice coordinates and the primes overflow
        # 32 bits; the int64 emulation must keep exactly the low 32 bits
        rng = np.random.default_rng(1)
        pc = rng.integers(-2 ** 20, 2 ** 24, (4096, 5))
        want = np.zeros(len(pc), np.uint32)
        with np.errstate(over="ignore"):
            for d in range(5):
                want ^= pc[:, d].astype(np.uint32) * np.uint32(
                    jhash._PRIMES[d])
        got = hash_grid.hash_u32(torch.from_numpy(pc))
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
        # a hash that kept the high bits would not pass: the wrap matters
        wide = np.zeros(len(pc), np.int64)
        for d in range(5):
            wide ^= pc[:, d] * jhash._PRIMES[d]
        assert (wide != want.astype(np.int64)).any()
        # non-power-of-two row counts see the wrap through the modulo
        rows = 1000
        np.testing.assert_array_equal(got.numpy() % rows,
                                      want.astype(np.int64) % rows)


def _net_kwargs(variant):
    if variant == "rest":
        return dict(scale_factor=0.5, encoder="GLOBAL", encoder_out_dim=5,
                    global_encoder_n_blocks=3, pos_emd="HASH_GRID",
                    hash_grid_n_levels=3, hash_grid_level_dim=2,
                    hash_grid_map_size=10, z_dim=None, mlp_hidden_dim=16)
    # style-modulated MLP over every attribute, sin/cos encoding
    return dict(scale_factor=0.5, encoder="GLOBAL", encoder_out_dim=5,
                global_encoder_n_blocks=2, pos_emd="SIN_COS",
                sin_cos_freq_bends=3, z_dim=6, mlp_hidden_dim=16,
                mlp_n_shared_layers=2,
                attr_factors={"xyz": 0.5, "rgb": 2.0, "scale": 0.3,
                              "opacity": 0.8},
                attr_n_layers={"xyz": 1, "rgb": 2, "scale": 1,
                               "opacity": 1})


def _generator_pair(variant, P=32, N=300, seed=0):
    kw = _net_kwargs(variant)
    jnet = JNetConfig(**kw, ptv3=JPTv3Config(enabled=False))
    tnet = GaussianNetworkConfig(**kw, ptv3=PTv3Config(enabled=False))
    rng = np.random.default_rng(seed)
    z_dim = kw["z_dim"]
    inputs = dict(
        uv=rng.uniform(-1, 1, (1, N, 2)),
        rel=rng.uniform(-1, 1, (1, N, 3)),
        oh=np.eye(8)[rng.integers(0, 8, N)][None],
        z=None if z_dim is None else rng.random((1, N, z_dim)),
        hf=rng.uniform(0, 20, (1, P, P, 1)),
        seg=np.eye(8)[rng.integers(0, 8, (P, P))][None])
    inputs = {k: None if v is None else v.astype(np.float32)
              for k, v in inputs.items()}
    jgen = JGenerator(cfg=jnet, n_classes=8, proj_size=P)

    def jargs():
        return (jnp.asarray(inputs["uv"]), jnp.asarray(inputs["rel"]), None,
                jnp.asarray(inputs["oh"]),
                None if z_dim is None else jnp.asarray(inputs["z"]),
                jnp.asarray(inputs["hf"]), jnp.asarray(inputs["seg"]),
                jnp.ones((1, N), bool))

    params = jax.tree_util.tree_map(
        np.asarray, jgen.init(jax.random.PRNGKey(seed), *jargs())["params"])
    if "pos_encoder" in params:
        # the init table is +-1e-4: widen it so that the lookup matters
        params["pos_encoder"]["embeddings"] = rng.uniform(
            -1, 1, params["pos_encoder"]["embeddings"].shape
        ).astype(np.float32)
    want = jgen.apply({"params": params}, *jargs())
    gen = Generator(tnet, n_classes=8, proj_size=P)
    gen.load_state_dict(interop.generator_state_from_flax(params, tnet))
    targs = [None if inputs[k] is None else torch.from_numpy(inputs[k])
             for k in ("uv", "rel")] + [None] + [
        None if inputs[k] is None else torch.from_numpy(inputs[k])
        for k in ("oh", "z", "hf", "seg")]
    return gen, targs, want


class TestGenerator:
    @pytest.mark.parametrize("variant", ["rest", "styled_all_attrs"])
    def test_matches_jax(self, variant):
        gen, targs, want = _generator_pair(variant)
        with torch.no_grad():
            got = gen(*targs)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       atol=ATOL, rtol=RTOL, err_msg=k)
            assert np.asarray(want[k]).std() > 1e-3, k

    def test_save_load_roundtrip(self, tmp_path):
        gen, targs, _ = _generator_pair("rest")
        base = rest_recipe()
        cfg = Config.from_dict({**base.to_dict(),
                                "network": gen.cfg.to_dict(),
                                "dataset": {**base.dataset.to_dict(),
                                            "proj_size": 32}})
        path = str(tmp_path / "rest.pt")
        interop.save_generator(path, gen.state_dict(), cfg)
        gen2, cfg2 = interop.load_generator(path)
        assert cfg2 == cfg
        with torch.no_grad():
            a, b = gen(*targs), gen2(*targs)
        for k in a:
            assert torch.equal(a[k], b[k])

    def test_rest_recipe_widths_and_seeded_init(self):
        cfg = rest_recipe()
        assert cfg.network.encoder == "GLOBAL"
        assert cfg.network.pos_emd == "HASH_GRID"
        assert not cfg.network.ptv3.enabled
        gen = Generator(cfg.network, n_classes=cfg.dataset.n_classes,
                        proj_size=64)
        assert gen.pos_encoder.embeddings.shape[0] == 16
        assert gen.pos_encoder.embeddings.shape[2] == 8
        assert len(gen.proj_encoder.blocks) == 5
        assert gen.ga_mlp.fc_1.out_features == 512
        a = [p.clone() for p in gen.parameters()]
        gen.reset_parameters(torch.Generator().manual_seed(3))
        b = [p.clone() for p in gen.parameters()]
        gen.reset_parameters(torch.Generator().manual_seed(3))
        assert all(torch.equal(x, y) for x, y in zip(b, gen.parameters()))
        assert not all(torch.equal(x, y) for x, y in zip(a, b))

    @pytest.mark.parametrize("change", ["local", "ptv3"])
    def test_later_slices_raise(self, change):
        kw = _net_kwargs("rest")
        if change == "local":
            kw["encoder"] = "LOCAL"
            net = GaussianNetworkConfig(**kw,
                                        ptv3=PTv3Config(enabled=False))
        else:
            net = GaussianNetworkConfig(**kw, ptv3=PTv3Config(enabled=True))
        with pytest.raises(NotImplementedError):
            Generator(net, n_classes=8, proj_size=32)
