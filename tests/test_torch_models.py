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

from gaussiancity_tpu_torch import _kernels, interop
from gaussiancity_tpu_torch.config import Config, GaussianNetworkConfig
from gaussiancity_tpu_torch.config import (PTv3Config, bldg_recipe,
                                           rest_recipe)
from gaussiancity_tpu_torch.models import generator
from gaussiancity_tpu_torch.models.generator import Generator
from gaussiancity_tpu_torch.ops import gather_rowsum, hash_grid, hash_grid_bwd
from gaussiancity_tpu_torch.testing import share_cpu_cores

from test_torch_ptv3 import TINY as TINY_PTV3

share_cpu_cores()

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

    @pytest.mark.parametrize("case", sorted(GRID_CASES))
    def test_gradients_match_jax_vjp(self, case):
        """Embedding and input gradients against the JAX custom VJP (its
        CPU scatter path): the embedding gradient through the sorted
        segment sum, the input gradient through the multilinear chain."""
        D, L, base, desired, log2 = GRID_CASES[case]
        shape = hash_grid.table_shape(D, L, base, desired, log2, 2)
        rng = np.random.default_rng(3)
        emb = rng.uniform(-1, 1, shape).astype(np.float32)
        x = rng.uniform(-1.05, 1.05, (300, D)).astype(np.float32)
        w_out = rng.normal(size=(300, L * 2)).astype(np.float32)

        def jloss(xj, ej):
            return jnp.sum(jhash.hash_encode(xj, ej, D, L, base, desired,
                                             log2) * w_out)

        want_x, want_e = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x),
                                                         jnp.asarray(emb))
        tx = torch.from_numpy(x).requires_grad_(True)
        te = torch.from_numpy(emb).requires_grad_(True)
        (hash_grid.hash_encode(tx, te, D, L, base, desired, log2)
         * torch.from_numpy(w_out)).sum().backward()
        for got, want in ((tx.grad, want_x), (te.grad, want_e)):
            want = np.asarray(want)
            assert np.abs(want).max() > 0.1
            # the input gradient sums 2^D corner terms per level, scaled
            # by the level's resolution (up to 63 here): 10x the forward's
            # absolute tolerance
            np.testing.assert_allclose(got.numpy(), want, atol=ATOL * 10,
                                       rtol=RTOL)
        # out-of-bound points take no gradient
        oob = (np.abs(x) > 1).any(-1)
        assert oob.any() and (tx.grad.numpy()[oob] == 0).all()

    @pytest.mark.parametrize("case", sorted(GRID_CASES))
    def test_backward_plain_matches_jax_residuals(self, case):
        """G1b's plain version against the JAX custom VJP's own pieces:
        the corner rows and weights of its forward residuals (``idx_all``,
        ``w``), the masked per-level gradient, ``_hash_encode_bwd``'s
        input gradient, and the embedding gradient K3 makes of them.  The
        REST shape has every level hashed, the xyz one dense and hashed
        levels; some points lie out of bound."""
        D, L, base, desired, log2 = GRID_CASES[case]
        _, _, _, hashed, _ = hash_grid.level_params(D, L, base, desired,
                                                    log2)
        assert all(hashed) if D == 5 else (not hashed[0] and hashed[-1])
        C = 4
        shape = hash_grid.table_shape(D, L, base, desired, log2, C)
        rng = np.random.default_rng(11)
        emb = rng.uniform(-1, 1, shape).astype(np.float32)
        x = rng.uniform(-1.05, 1.05, (300, D)).astype(np.float32)
        g = rng.normal(size=(300, L * C)).astype(np.float32)
        oob = (np.abs(x) > 1).any(-1)
        assert oob.any()
        _, res = jhash._hash_encode_fwd(jnp.asarray(x), jnp.asarray(emb), D,
                                        L, base, desired, log2, 1.0)
        want_dx, want_de = jhash._hash_encode_bwd(D, L, base, desired, log2,
                                                  1.0, res, jnp.asarray(g))
        idx_all, _, w_all = (np.asarray(r) for r in res[:3])
        args = (torch.from_numpy(x), torch.from_numpy(emb),
                torch.from_numpy(g), L, base, desired, log2)
        keys, w, g_l, d_inputs = hash_grid.hash_encode_bwd(*args)
        # the same float32 geometry: rows exact, weights to an ulp or two
        # (XLA may fuse x01 * scale + 0.5)
        np.testing.assert_array_equal(keys.numpy(), idx_all)
        np.testing.assert_allclose(w.numpy(), w_all, rtol=0, atol=1e-6)
        want_gl = np.where(oob[:, None], 0.0, g).reshape(300, L, C)
        np.testing.assert_array_equal(g_l.numpy(), want_gl.transpose(1, 0, 2))
        # the input gradient sums 2^D corner terms per level, scaled by
        # the level's resolution: the gradient tests' tolerance
        want_dx = np.asarray(want_dx)
        assert np.abs(want_dx).max() > 0.1
        np.testing.assert_allclose(d_inputs.numpy(), want_dx, atol=ATOL * 10,
                                   rtol=RTOL)
        assert (d_inputs.numpy()[oob] == 0).all()
        d_emb = hash_grid_bwd.hash_grad_embeddings(keys, w, g_l, shape[1])
        np.testing.assert_allclose(d_emb.numpy(), np.asarray(want_de),
                                   atol=ATOL, rtol=RTOL)
        # only what is asked for
        none_x = hash_grid.hash_encode_bwd(*args, need_inputs=False)
        assert none_x[3] is None and torch.equal(none_x[0], keys)
        none_e = hash_grid.hash_encode_bwd(*args, need_embeddings=False)
        assert none_e[:3] == (None, None, None)
        assert torch.equal(none_e[3], d_inputs)
        assert _kernels.launches["hash_encode_bwd"] == 0  # CPU: plain

    def test_backward_rejects_bad_inputs(self):
        """G1b's wrapper checks devices, dtypes and shapes before it
        picks a path."""
        D, L, base, desired, log2 = GRID_CASES["rest_5d"]
        shape = hash_grid.table_shape(D, L, base, desired, log2, 2)
        x, emb = torch.zeros((4, D)), torch.zeros(shape)
        g = torch.zeros((4, L * 2))
        args = (L, base, desired, log2)
        with pytest.raises(ValueError, match="g"):
            hash_grid.hash_encode_bwd(x, emb, g[:, :-1], *args)
        with pytest.raises(ValueError, match="embeddings"):
            hash_grid.hash_encode_bwd(x, emb, g, L + 1, *args[1:])
        with pytest.raises(TypeError, match="float32"):
            hash_grid.hash_encode_bwd(x, emb, g.double(), *args)
        with pytest.raises(ValueError, match="g on meta"):
            hash_grid.hash_encode_bwd(x, emb, g.to("meta"), *args)

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


class TestGatherRowsum:
    def test_plain_matches_the_probe_kernel_body(self):
        """K4's CPU path against the body of the JAX package's probe
        kernel (scripts/bench_gather3.py:64-69, defined inside the
        script's main and not importable): the channel sums in float32
        of the bf16 rows gathered at the indices."""
        rng = np.random.default_rng(7)
        table = rng.normal(size=(4096, 8)).astype(np.float32)
        idx = rng.integers(0, 4096, (8, 512)).astype(np.int32)
        jtab = jnp.asarray(table, jnp.bfloat16)
        want = jnp.sum(jtab[jnp.asarray(idx).reshape(-1)].astype(
            jnp.float32), axis=-1).reshape(idx.shape)
        got = gather_rowsum.gather_rowsum(
            torch.from_numpy(table).to(torch.bfloat16),
            torch.from_numpy(idx))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
        assert _kernels.launches["gather_rowsum"] == 0  # CPU: plain


def _net_kwargs(variant):
    if variant == "bldg":
        # the BLDG recipe's shape: no encoder, sin/cos, style z, PTv3
        return dict(scale_factor=0.65, encoder=None, encoder_out_dim=3,
                    pos_emd="SIN_COS", sin_cos_freq_bends=2, z_dim=16,
                    mlp_hidden_dim=32)
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


def strict_compile(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` without XLA's excess
    precision, so that a bf16 program rounds to bf16 wherever it is
    written to (by default a CPU fusion may keep float32 between ops)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


def strict_jit(fn, *args):
    """``strict_compile(fn, *args)`` called on ``args``."""
    return strict_compile(fn, *args)(*args)


def _generator_pair(variant, P=32, N=300, seed=0, **overrides):
    kw = {**_net_kwargs(variant), **overrides}
    on = variant == "bldg"
    if on:
        N = 288  # the JAX PTv3 takes whole patches of 32
    ptv3_kw = TINY_PTV3 if on else {}
    jnet = JNetConfig(**kw, ptv3=JPTv3Config(enabled=on, **ptv3_kw))
    tnet = GaussianNetworkConfig(**kw, ptv3=PTv3Config(enabled=on,
                                                       **ptv3_kw))
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

    variables = jax.tree_util.tree_map(
        np.asarray, dict(jax.jit(jgen.init)(jax.random.PRNGKey(seed),
                                            *jargs())))
    params = variables["params"]
    if "batch_stats" in variables:
        # random running statistics, so that the eval BatchNorm matters
        variables["batch_stats"] = jax.tree_util.tree_map(
            lambda a: rng.uniform(0.5, 2.0, a.shape).astype(np.float32),
            variables["batch_stats"])
    if "pos_encoder" in params:
        # the init table is +-1e-4: widen it so that the lookup matters
        params["pos_encoder"]["embeddings"] = rng.uniform(
            -1, 1, params["pos_encoder"]["embeddings"].shape
        ).astype(np.float32)
    want = strict_jit(jgen.apply, variables, *jargs())
    gen = Generator(tnet, n_classes=8, proj_size=P)
    gen.load_state_dict(interop.generator_state_from_flax(variables, tnet))
    gen.eval()
    targs = [None if inputs[k] is None else torch.from_numpy(inputs[k])
             for k in ("uv", "rel")] + [None] + [
        None if inputs[k] is None else torch.from_numpy(inputs[k])
        for k in ("oh", "z", "hf", "seg")]
    return gen, targs, want


class TestGenerator:
    @pytest.mark.parametrize("variant", ["rest", "styled_all_attrs", "bldg"])
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
        gen2, cfg2 = interop.load_generator(path, device="cpu")
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

    def test_bldg_recipe_builds_at_full_width(self):
        cfg = bldg_recipe()
        assert cfg.network.ptv3.enabled and cfg.network.z_dim == 256
        gen = Generator(cfg.network, n_classes=cfg.dataset.n_classes,
                        proj_size=cfg.dataset.proj_size)
        net = gen.pt_net.net
        assert net.enc4_block1.attn.qkv.in_features == 512
        assert net.enc0_block0.attn.patch_size == 1024
        assert gen.ga_mlp.fc_1.in_features == 3 * 2 * 10 + 64
        a = [p.clone() for p in gen.parameters()]
        gen.reset_parameters(torch.Generator().manual_seed(1))
        b = [p.clone() for p in gen.parameters()]
        assert all(not torch.equal(x, y) for x, y in zip(a, b)
                   if x.numel() > 1 and x.std() > 0)

    @pytest.mark.parametrize("change", ["local", "bfloat16"])
    def test_later_slices_raise(self, change):
        """Kept by name: the options that once raised now run and
        match the JAX generator.  "local": the LOCAL encoder (its map
        sampled at each point's uv, the hash grid over per-point encoder
        dimensions) in float32, within 1e-5 + 1e-4 relative.
        "bfloat16": the REST generator in bf16 against the JAX one
        compiled without excess precision (``strict_jit``): the bf16
        roundings land on the same values, so the float32 attributes agree
        within 1e-6, and they are not the float32 generator's."""
        kw = {"encoder": "LOCAL"} if change == "local" else {
            "compute_dtype": "bfloat16"}
        gen, targs, want = _generator_pair("rest", **kw)
        with torch.no_grad():
            got = gen(*targs)
        atol, rtol = (ATOL, RTOL) if change == "local" else (1e-6, 0)
        for k in want:
            assert got[k].dtype == torch.float32
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       atol=atol, rtol=rtol, err_msg=k)
            assert np.asarray(want[k]).std() > 1e-3, k
        if change == "bfloat16":
            assert gen.ga_mlp.fc_1.compute_dtype == torch.bfloat16
            f32, _, _ = _generator_pair("rest")
            with torch.no_grad():
                assert (f32(*targs)["rgb"] - got["rgb"]).abs().max() > 1e-4
        else:
            assert isinstance(gen.proj_encoder,
                              generator.LocalEncoder)
