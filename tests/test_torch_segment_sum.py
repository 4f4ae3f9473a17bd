# -*- coding: utf-8 -*-
"""The sorted segment sum of the port (``ops/hash_grid_bwd.py``, the
module of kernel K3) against the JAX package on the CPU: the hash-grid
embedding gradient, the per-Gaussian row reduction of the rasterizer and
the plain segment sum itself.  The JAX side runs its Pallas kernel in
interpret mode with (32, 32) tiles, as tests/test_hash_grid_bwd.py runs
it; the port's wrappers take the plain version (``index_add_``) for CPU
tensors.  The kernel-vs-plain checks are in test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiancity_tpu.ops import hash_grid_bwd as jbwd
from gaussiancity_tpu.ops.rasterizer.blend import _reduce_rows_mxu

from gaussiancity_tpu_torch.ops import hash_grid_bwd

# the JAX kernel sums through a one-hot matmul on a hi/lo bf16 split of
# the payload, exact to about 2^-16 relative: tolerance relative to the
# largest output
RTOL = 1e-4


@pytest.mark.parametrize("C", [8, 9])
def test_hash_grad_embeddings_matches_jax(C):
    L, NC, N, R = 3, 8, 64, 256
    rng = np.random.default_rng(C)
    idx = rng.integers(0, R, (L, NC, N)).astype(np.int32)
    idx[0, :, :8] = 5  # one row named by 64 corners: a long run
    w = rng.random((L, NC, N)).astype(np.float32)
    g = rng.normal(size=(L, N, C)).astype(np.float32)
    want = np.asarray(jbwd.hash_grad_embeddings(
        jnp.asarray(idx), jnp.asarray(w), jnp.asarray(g), R,
        tile_sizes=(32, 32)))
    got = hash_grid_bwd.hash_grad_embeddings(
        torch.from_numpy(idx), torch.from_numpy(w), torch.from_numpy(g),
        R).numpy()
    assert got.shape == want.shape == (L, R, C)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * np.abs(want).max())
    named = np.zeros((L, R), bool)
    for lvl in range(L):
        named[lvl, idx[lvl].reshape(-1)] = True
    assert (~named).any() and (got[~named] == 0).all()


def test_reduce_rows_matches_jax():
    """The rasterizer's per-Gaussian use: keys in any order, the key N
    marks a dropped slot."""
    M, N, C = 700, 96, 9
    rng = np.random.default_rng(0)
    keys = rng.integers(0, N + 1, M).astype(np.int32)
    keys[:200] = N  # a block of dropped slots
    rows = rng.normal(size=(M, C)).astype(np.float32)
    want = np.asarray(_reduce_rows_mxu(jnp.asarray(keys), jnp.asarray(rows),
                                       N))
    got = hash_grid_bwd.reduce_rows(torch.from_numpy(keys),
                                    torch.from_numpy(rows), N).numpy()
    assert got.shape == (N, C)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("C", [1, 16])
def test_segment_sum_plain_matches_jax(C):
    """``segment_sum_sorted_plain`` on sorted keys with negative keys and
    keys >= R (dropped by both), held to the JAX reduction of the same
    rows (one corner of weight 1, as ``_reduce_rows_mxu`` calls it)."""
    L, M, R = 2, 400, 160
    rng = np.random.default_rng(C)
    keys = np.sort(rng.integers(-20, R + 30, (L, M)), axis=1).astype(np.int32)
    rows = rng.normal(size=(L, M, C)).astype(np.float32)
    want = np.stack([np.asarray(jbwd.hash_grad_embeddings(
        jnp.asarray(keys[lvl]).reshape(1, 1, M), jnp.ones((1, 1, M)),
        jnp.asarray(rows[lvl])[None], R, tile_sizes=(32, 32)))[0]
        for lvl in range(L)])
    got = hash_grid_bwd.segment_sum_sorted_plain(
        torch.from_numpy(keys), torch.from_numpy(rows), R).numpy()
    assert got.shape == (L, R, C)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * np.abs(want).max())
