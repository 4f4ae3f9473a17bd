# -*- coding: utf-8 -*-
"""PyTorch port vs the JAX package: PTv3 and its point serialization.

The same numpy-seeded inputs go to both packages; the JAX parameters (and
``batch_stats``, given random values so that the eval BatchNorm matters)
are carried across by ``interop.ptv3_state_from_flax``.  The port runs on
the valid points alone, unpadded; the JAX package on padded slabs."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaussiancity_tpu.config import PTv3Config as JPTv3Config
from gaussiancity_tpu.models import ptv3 as jptv3
from gaussiancity_tpu.ops import serialization as jser

from gaussiancity_tpu_torch import interop
from gaussiancity_tpu_torch.config import PTv3Config
from gaussiancity_tpu_torch.models import ptv3
from gaussiancity_tpu_torch.ops import serialization as ser
from gaussiancity_tpu_torch.testing import TINY_PTV3 as TINY, share_cpu_cores

share_cpu_cores()

# float32 matmuls, softmaxes and norms taken in another order than XLA's
ATOL, RTOL = 1e-5, 1e-4

ORDERS = ("cord", "z", "z-trans", "hilbert", "hilbert-trans")



def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _with_random_stats(variables, rng):
    """Init variables with random running statistics in place of the
    init's mean 0, var 1."""
    def draw(path, leaf):
        if jax.tree_util.keystr(path).endswith("['mean']"):
            return rng.normal(0, 0.2, leaf.shape).astype(np.float32)
        return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
    return {"params": _np_tree(variables["params"]),
            "batch_stats": jax.tree_util.tree_map_with_path(
                draw, _np_tree(variables["batch_stats"]))}


def _port(module, variables):
    """Load a JAX module's variables into the port's module (eval)."""
    state = interop.ptv3_state_from_flax(variables["params"])
    interop.ptv3_state_from_flax(variables.get("batch_stats", {}), "",
                                 state)
    module.load_state_dict(state)
    return module.eval()


def _points(seed, n, n_pad=0, scale=1.0):
    """n valid points (some sharing a voxel) then n_pad invalid ones."""
    rng = np.random.default_rng(seed)
    coord = rng.uniform(-scale, scale, (n + n_pad, 3)).astype(np.float32)
    coord[n // 4:n // 4 + n // 8] = coord[:n // 8]  # co-voxel duplicates
    valid = np.arange(n + n_pad) < n
    return coord, valid


class TestSerialization:
    @pytest.mark.parametrize("order", ORDERS)
    def test_codes_order_inverse_equal_jax(self, order):
        coord, valid = _points(0, 2000)
        valid &= np.random.default_rng(1).random(len(valid)) > 0.1
        want = jser.serialize(jnp.asarray(coord), jnp.asarray(valid), 0.01,
                              (order,), 10)
        got = ser.serialize(torch.from_numpy(coord), torch.from_numpy(valid),
                            0.01, (order,), 10)
        for w, g, what in zip(want, got,
                              ("grid", "codes", "order", "inverse")):
            assert g.dtype == torch.int32, what
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=what)
        codes = got[1].numpy()[0]
        assert (codes[~valid] == ser.INVALID_CODE).all()
        # points that share a voxel share a code
        both = valid[:250] & valid[500:750]
        assert both.any()
        np.testing.assert_array_equal(codes[:250][both], codes[500:750][both])


class TestNeighbors:
    @pytest.mark.parametrize("k", [3, 5])
    def test_dense_neighbors_equal_jax(self, k):
        rng = np.random.default_rng(k)
        N = 600
        # duplicates (co-voxel points keep the lowest id) and points
        # outside the 16^3 extent
        grid = rng.integers(0, 20, (N, 3)).astype(np.int32)
        valid = rng.random(N) > 0.1
        nb_w, fnd_w, ovf_w = jptv3.subm_neighbors_dense(
            jnp.asarray(grid), jnp.asarray(valid), k, 10, extent=16)
        nb, fnd, ovf = ptv3.subm_neighbors_dense(
            torch.from_numpy(grid), torch.from_numpy(valid), k, extent=16)
        assert int(ovf) == int(ovf_w) > 0
        np.testing.assert_array_equal(fnd.numpy(), np.asarray(fnd_w))
        f = np.asarray(fnd_w)
        assert f.mean() > 0.02
        np.testing.assert_array_equal(nb.numpy()[f], np.asarray(nb_w)[f])


def _shell(seed, n, side):
    """n distinct voxels on the faces of a [side]^3 box, in random order:
    a building's shell, on which most neighbour slots are unfound."""
    rng = np.random.default_rng(seed)
    face, uv = rng.integers(0, 6, 4 * n), rng.integers(0, side, (4 * n, 2))
    axis, rows = face // 2, np.arange(4 * n)
    g = np.empty((4 * n, 3), np.int64)
    g[rows, axis] = face % 2 * (side - 1)
    g[rows, (axis + 1) % 3] = uv[:, 0]
    g[rows, (axis + 2) % 3] = uv[:, 1]
    g = np.unique(g, axis=0)
    assert len(g) >= n
    return g[rng.permutation(len(g))[:n]].astype(np.int32)


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("search", ["dense", "sorted"])
def test_unfound_slots_name_their_own_row(search, k):
    """Found slots name the JAX package's rows; a slot not found names the
    query's own row (the JAX package's N - 1 or clamped rank there), so
    that no row collects the unfound slots of an offset."""
    grid = _shell(20 + k, 1500, 30)
    grid[:40] = grid[40:80]  # co-voxel duplicates: the lowest id wins
    valid = np.random.default_rng(k).random(len(grid)) > 0.05
    args = (jnp.asarray(grid), jnp.asarray(valid), k, 10)
    targs = (torch.from_numpy(grid), torch.from_numpy(valid), k)
    if search == "dense":
        nb_w, fnd_w = jptv3.subm_neighbors_dense(*args, extent=32)[:2]
        nb, fnd = ptv3.subm_neighbors_dense(*targs, extent=32)[:2]
    else:
        nb_w, fnd_w = jptv3.subm_neighbors(*args)
        nb, fnd = ptv3.subm_neighbors(*targs, 10)
    assert nb.dtype == torch.int32
    f = np.asarray(fnd_w)
    np.testing.assert_array_equal(fnd.numpy(), f)
    assert 0.8 < 1 - f.mean() < 0.97
    np.testing.assert_array_equal(nb.numpy()[f], np.asarray(nb_w)[f])
    own = np.broadcast_to(np.arange(len(grid)), f.shape)
    np.testing.assert_array_equal(nb.numpy()[~f], own[~f])
    # a row is named at most twice an offset: as a neighbour, and as a
    # query of its own whose slot is unfound (duplicates: once more)
    runs = [np.bincount(row, minlength=len(grid)).max()
            for row in nb.numpy()]
    assert max(runs) <= 3


def test_subm_conv_on_a_shell_equals_the_clamped_map():
    """On a shell with over 80 % of the slots unfound, the port's map and
    the JAX package's (unfound slots on row N - 1) give a SubMConv forward
    equal to the bit, and gradients of the features and the kernel equal
    but for the order of the feature gradients' sums."""
    grid = _shell(3, 4000, 40)
    N = len(grid)
    valid = np.ones(N, bool)
    for k in (3, 5):
        nb_w, fnd_w, _ = jptv3.subm_neighbors_dense(
            jnp.asarray(grid), jnp.asarray(valid), k, 10)
        nb, fnd, _ = ptv3.subm_neighbors_dense(
            torch.from_numpy(grid), torch.from_numpy(valid), k)
        assert (~fnd).float().mean() > 0.8
        clamped = torch.from_numpy(np.array(nb_w))
        assert (clamped == N - 1).float().mean() > 0.8
        torch.manual_seed(k)
        conv = ptv3.SubMConv(16, 24, k)
        feat, ct = torch.randn(N, 16), torch.randn(N, 24)
        got = []
        for m in (nb, clamped):
            x = feat.clone().requires_grad_(True)
            conv.zero_grad()
            y = conv(x, (m, fnd))
            (y * ct).sum().backward()
            got.append((y.detach(), x.grad, conv.kernel.grad.clone()))
        (y, dx, dw), (y_w, dx_w, dw_w) = got
        assert torch.equal(y, y_w)
        torch.testing.assert_close(dx, dx_w, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(dw, dw_w, rtol=1e-6, atol=1e-6)
        assert dx.abs().max() > 0.1 and dw.abs().max() > 0.1


@pytest.mark.parametrize("extent", [256, 0], ids=["dense", "sorted"])
def test_packed_neighbors_keep_unfound_slots_in_their_sample(extent):
    """Two samples packed: every slot, found or not, names a row of its
    own sample (the unfound ones their own row)."""
    net = ptv3.PTv3Single(PTv3Config(**TINY, dense_nbr_extent=extent), 4)
    counts = [700, 500]
    grid = torch.from_numpy(np.concatenate([_shell(8, 700, 20),
                                            _shell(9, 500, 20)]))
    net.overflow = torch.zeros((), dtype=torch.int64)
    net.unfound = torch.zeros_like(net.overflow)
    nb, fnd = net._neighbors(grid, counts, 3)
    assert nb.shape == fnd.shape == (27, 1200)
    sample = (torch.arange(1200) >= 700).expand(27, -1)
    assert torch.equal(nb >= 700, sample)
    own = torch.arange(1200).expand(27, -1)
    assert torch.equal(nb[~fnd], own[~fnd])
    assert 0.5 < (~fnd).float().mean() < 1


def test_ptv3_counts_its_unfound_slots():
    """``unfound`` is (~found).sum() over the neighbour maps of a forward,
    ``slots`` their sizes; both start again at the next forward."""
    maps = []
    net = ptv3.PTv3Single(PTv3Config(**TINY), 12).eval()
    search = net._neighbors

    def keep(*a):
        nb, found = search(*a)
        maps.append(found)
        return nb, found

    net._neighbors = keep
    rng = np.random.default_rng(4)
    coord = torch.from_numpy(rng.uniform(-0.2, 0.2, (300, 3)).astype(
        np.float32))
    feat = torch.randn(300, 12)
    with torch.no_grad():
        for _ in range(2):
            maps.clear()
            net(feat, coord, counts=[200, 100])
            assert len(maps) == 1 + len(TINY["enc_depths"])
            assert int(net.unfound) == sum(int((~f).sum()) for f in maps)
            assert net.slots == sum(f.numel() for f in maps)
            assert 0 < int(net.unfound) < net.slots
            assert net.unfound.dtype == torch.int64 and net.unfound.dim() == 0


def test_subm_conv_matches_jax():
    rng = np.random.default_rng(2)
    N, C, F = 400, 6, 10
    grid = rng.integers(0, 12, (N, 3)).astype(np.int32)
    valid = np.ones(N, bool)
    feat = rng.normal(size=(N, C)).astype(np.float32)
    nbrs = jptv3.subm_neighbors_dense(jnp.asarray(grid), jnp.asarray(valid),
                                      3, 10, extent=16)[:2]
    jconv = jptv3.SubMConv(F, 3)
    variables = _np_tree(jconv.init(jax.random.PRNGKey(0), jnp.asarray(feat),
                                    jnp.asarray(grid), jnp.asarray(valid),
                                    nbrs))
    want = jconv.apply(variables, jnp.asarray(feat), jnp.asarray(grid),
                       jnp.asarray(valid), nbrs)
    conv = _port(ptv3.SubMConv(C, F, 3), variables)
    tnbrs = ptv3.subm_neighbors_dense(torch.from_numpy(grid),
                                      torch.from_numpy(valid), 3, 16)[:2]
    with torch.no_grad():
        got = conv(torch.from_numpy(feat), tnbrs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("count", [77, 20], ids=["partial_last", "below"])
def test_patch_attention_matches_jax(count):
    rng = np.random.default_rng(count)
    N, C, H, K = 96, 16, 4, 32
    feat = rng.normal(size=(N, C)).astype(np.float32)
    codes = np.where(np.arange(N) < count, rng.integers(0, 1000, N),
                     ser.INVALID_CODE).astype(np.int32)
    order = np.argsort(codes, kind="stable").astype(np.int32)
    inverse = np.argsort(order).astype(np.int32)
    args = (jnp.asarray(feat), jnp.asarray(order), jnp.asarray(inverse),
            jnp.int32(count))
    jattn = jptv3.PatchAttention(C, H, K)
    variables = _np_tree(jattn.init(jax.random.PRNGKey(1), *args))
    want = np.asarray(jattn.apply(variables, *args))
    attn = _port(ptv3.PatchAttention(C, H, K), variables)
    with torch.no_grad():
        got = attn(torch.from_numpy(feat), torch.from_numpy(order),
                   torch.from_numpy(inverse), count).numpy()
    valid = codes != ser.INVALID_CODE
    np.testing.assert_allclose(got[valid], want[valid], atol=ATOL,
                               rtol=RTOL)
    # the port on the valid points alone, unpadded, gives the same
    keep = np.nonzero(valid)[0]
    sub_order = np.argsort(codes[keep], kind="stable").astype(np.int32)
    with torch.no_grad():
        alone = attn(torch.from_numpy(feat[keep]),
                     torch.from_numpy(sub_order),
                     torch.from_numpy(np.argsort(sub_order).astype(np.int32)),
                     count).numpy()
    np.testing.assert_allclose(alone, want[keep], atol=ATOL, rtol=RTOL)


def test_pooling_and_unpooling_match_jax():
    rng = np.random.default_rng(3)
    coord, valid = _points(4, 300)
    N, C, F = len(coord), 8, 12
    feat = rng.normal(size=(N, C)).astype(np.float32)
    g, codes, order, inverse = jser.serialize(
        jnp.asarray(coord), jnp.asarray(valid), 0.01, ("cord", "z"), 10)
    jpool = jptv3.SerializedPooling(F, 2)
    pargs = (jnp.asarray(feat), jnp.asarray(coord), g, codes, order,
             jnp.asarray(valid), jnp.int32(N), 0.01, ("cord", "z"), 10)
    pvars = _with_random_stats(
        jpool.init(jax.random.PRNGKey(2), *pargs, train=False), rng)
    want = jpool.apply(pvars, *pargs, train=False)
    nc = int(want["count"])
    assert 20 < nc < N
    pool = _port(ptv3.SerializedPooling(C, F, 2), pvars)
    t = {k: torch.from_numpy(np.array(v)) for k, v in
         dict(feat=feat, coord=coord, grid_coord=g, codes=codes, order=order,
              inverse=inverse).items()}
    with torch.no_grad():
        got, cluster = pool(t)
    np.testing.assert_array_equal(cluster.numpy(),
                                  np.asarray(want["cluster"]))
    np.testing.assert_array_equal(got["grid_coord"].numpy(),
                                  np.asarray(want["grid_coord"])[:nc])
    for k in ("codes", "order", "inverse"):
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.asarray(want[k])[:, :nc], err_msg=k)
    for k in ("feat", "coord"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k])[:nc],
                                   atol=ATOL, rtol=RTOL, err_msg=k)

    child = rng.normal(size=(N, F)).astype(np.float32)
    jup = jptv3.SerializedUnpooling(C)
    uargs = (jnp.asarray(child), jnp.asarray(feat), want["cluster"],
             jnp.asarray(valid), jnp.arange(N) < nc)
    uvars = _with_random_stats(
        jup.init(jax.random.PRNGKey(3), *uargs, train=False), rng)
    want_up = jup.apply(uvars, *uargs, train=False)
    up = _port(ptv3.SerializedUnpooling(F, C, C), uvars)
    with torch.no_grad():
        got_up = up(torch.from_numpy(child[:nc]), torch.from_numpy(feat),
                    cluster)
    np.testing.assert_allclose(got_up.numpy(), np.asarray(want_up),
                               atol=ATOL, rtol=RTOL)


@pytest.fixture(scope="module")
def tiny_ptv3():
    """The small PTv3 in both packages, random running statistics."""
    rng = np.random.default_rng(5)
    n, C = 150, 12
    coord, _ = _points(6, n)
    feat = rng.normal(size=(n, C)).astype(np.float32)
    jmodel = jptv3.PointTransformerV3(cfg=JPTv3Config(**TINY),
                                      in_channels=C)
    # the JAX slab holds whole patches: init at 160 points
    variables = _with_random_stats(jax.jit(jmodel.init)(
        jax.random.PRNGKey(7), jnp.zeros((1, 160, C)),
        jnp.zeros((1, 160, 3))), rng)
    model = _port(ptv3.PointTransformerV3(PTv3Config(**TINY), C), variables)
    with torch.no_grad():
        got = model(torch.from_numpy(feat)[None],
                    torch.from_numpy(coord)[None])[0].numpy()
    return jmodel, variables, feat, coord, got


@pytest.mark.parametrize("n_pad", [10, 106])  # slabs of 160 and 256
def test_ptv3_matches_jax_at_two_paddings(tiny_ptv3, n_pad):
    jmodel, variables, feat, coord, got = tiny_ptv3
    n = len(feat)
    rng = np.random.default_rng(n_pad)
    pfeat = np.concatenate([feat, rng.normal(size=(n_pad, feat.shape[1]))])
    pcoord = np.concatenate([coord, rng.uniform(-1, 1, (n_pad, 3))])
    valid = np.arange(n + n_pad) < n
    apply = jax.jit(functools.partial(jmodel.apply,
                                      mutable=["intermediates"]))
    want, diag = apply(
        variables, jnp.asarray(pfeat, jnp.float32)[None],
        jnp.asarray(pcoord, jnp.float32)[None], jnp.asarray(valid)[None])
    pool_overflow = sum(
        int(np.sum(v)) for p, v in jax.tree_util.tree_leaves_with_path(
            diag["intermediates"]) if "pool_overflow" in
        jax.tree_util.keystr(p))
    assert pool_overflow == 0
    want = np.asarray(want)[0, :n]
    assert got.shape == want.shape == (n, TINY["dec_channels"][0])
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_ptv3_train_mode_forward_backward_match_jax(tiny_ptv3):
    """Training mode, drop path off: the output, the running statistics
    folded from the batch and the input gradient, against the JAX
    package's ``apply(..., train=True, mutable=["batch_stats"])`` on a
    padded slab."""
    jmodel, variables, feat, coord, _ = tiny_ptv3
    n, n_pad = len(feat), 10
    rng = np.random.default_rng(11)
    pfeat = np.concatenate([feat, rng.normal(size=(n_pad, feat.shape[1]))]
                           ).astype(np.float32)
    pcoord = np.concatenate([coord, rng.uniform(-1, 1, (n_pad, 3))]
                            ).astype(np.float32)
    valid = np.arange(n + n_pad) < n
    ct = rng.normal(size=(n, TINY["dec_channels"][0])).astype(np.float32)
    jmodel = jptv3.PointTransformerV3(cfg=JPTv3Config(**TINY),
                                      in_channels=feat.shape[1],
                                      drop_path=0.0)

    def fwd(x):
        return jmodel.apply(variables, x, jnp.asarray(pcoord)[None],
                            jnp.asarray(valid)[None], True,
                            mutable=["batch_stats"])

    @jax.jit
    def run(x):
        (out, vs), vjp = jax.vjp(fwd, x)
        cot = jnp.zeros_like(out).at[0, :n].set(jnp.asarray(ct))
        stats_cot = jax.tree_util.tree_map(jnp.zeros_like, vs)
        return out, vs, vjp((cot, stats_cot))[0]

    want, want_vs, want_grad = _np_tree(run(jnp.asarray(pfeat)[None]))
    model = _port(ptv3.PointTransformerV3(PTv3Config(**TINY),
                                          feat.shape[1], drop_path=0.0),
                  variables).train()
    x = torch.from_numpy(feat)[None].requires_grad_(True)
    got = model(x, torch.from_numpy(coord)[None])
    (got[0] * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(got[0].detach().numpy(), want[0, :n],
                               atol=ATOL, rtol=RTOL)
    g = want_grad[0, :n]
    assert np.abs(g).max() > 1e-3
    np.testing.assert_allclose(x.grad[0].numpy(), g, rtol=0,
                               atol=RTOL * np.abs(g).max())
    new_stats = interop.ptv3_state_from_flax(want_vs["batch_stats"])
    old_stats = interop.ptv3_state_from_flax(variables["batch_stats"])
    state = model.state_dict()
    assert len(new_stats) > 10
    for k, w in new_stats.items():
        np.testing.assert_allclose(state[k].numpy(), w.numpy(), atol=ATOL,
                                   rtol=RTOL, err_msg=k)
        assert not torch.equal(w, old_stats[k]), k


def test_pooling_tie_gradient_matches_jax_segment_max():
    """A cluster whose points have equal features shares the max's
    gradient equally among them, as the JAX package's ``segment_max``
    does; so do features that tie at 0."""
    rng = np.random.default_rng(12)
    coord, valid = _points(13, 64)
    N, C, F = len(coord), 4, 6
    feat = rng.normal(size=(N, C)).astype(np.float32)
    g, codes, order, inverse = jser.serialize(
        jnp.asarray(coord), jnp.asarray(valid), 0.01, ("cord",), 10)
    # the co-voxel duplicates of _points share a cluster: equal features,
    # some of them 0 (after a projection without bias: a tie at 0)
    feat[:4] = 0.0
    feat[N // 4:N // 4 + N // 8] = feat[:N // 8]
    jpool = jptv3.SerializedPooling(F, 2)
    pargs = (jnp.asarray(coord), g, codes, order, jnp.asarray(valid),
             jnp.int32(N), 0.01, ("cord",), 10)
    pvars = _np_tree(jpool.init(jax.random.PRNGKey(4), jnp.asarray(feat),
                                *pargs, train=False))
    pvars["params"]["proj"]["bias"] = np.zeros(F, np.float32)
    ct = rng.normal(size=(N, F)).astype(np.float32)

    @jax.jit
    def run(x):
        def fwd(x):
            out, _ = jpool.apply(pvars, x, *pargs, train=True,
                                 mutable=["batch_stats"])
            return out["feat"], out["count"]
        (out, count), vjp = jax.vjp(fwd, x)
        mask = (jnp.arange(N) < count)[:, None]
        return count, vjp((jnp.where(mask, jnp.asarray(ct), 0.0),
                           jnp.zeros_like(count)))[0]

    count, want = run(jnp.asarray(feat))
    nc = int(count)
    pool = _port(ptv3.SerializedPooling(C, F, 2), pvars).train()
    t = {k: torch.from_numpy(np.array(v)) for k, v in
         dict(coord=coord, grid_coord=g, codes=codes, order=order,
              inverse=inverse).items()}
    t["feat"] = torch.from_numpy(feat).requires_grad_(True)
    got, _ = pool(t)
    assert got["feat"].shape[0] == nc < N
    (got["feat"] * torch.from_numpy(ct[:nc])).sum().backward()
    want = np.asarray(want)
    np.testing.assert_allclose(t["feat"].grad.numpy(), want, rtol=0,
                               atol=RTOL * np.abs(want).max())
    tied = feat[:N // 8] == feat[N // 4:N // 4 + N // 8]
    assert tied.all() and np.abs(want[:N // 8]).max() > 0


def test_ptv3_is_eval_only_and_later_options_raise():
    """Kept by name: nothing raises any more.  Training mode takes B > 1
    (the samples run packed; ``test_torch_model_surface.py`` holds it to
    the JAX vmap), and enable_rpe and the sorted-merge search build and
    run (``test_torch_model_options.py`` holds them to the JAX package)."""
    cfg = PTv3Config(**TINY)
    model = ptv3.PointTransformerV3(cfg, 12)
    x = torch.zeros((1, 40, 12))
    out = model(torch.rand((2, 40, 12)), torch.rand((2, 40, 3)), None,
                torch.Generator().manual_seed(0))  # training, drop path on
    assert out.shape == (2, 40, 8) and torch.isfinite(out).all()
    for change in (dict(enable_rpe=True), dict(dense_nbr_extent=0)):
        other = ptv3.PointTransformerV3(cfg.replace(**change), 12).eval()
        with torch.no_grad():
            assert torch.isfinite(other(torch.rand((1, 40, 12)),
                                        torch.rand((1, 40, 3)))).all()
    # masked rows of a batch come back 0; an empty sample gives [0, C]
    model.eval()
    with torch.no_grad():
        out = model(torch.rand((1, 40, 12)), torch.rand((1, 40, 3)),
                    torch.arange(40)[None] < 30)
        assert (out[0, 30:] == 0).all() and out[0, :30].abs().max() > 0
        assert model.net(x[0, :0], x[0, :0, :3]).shape == (0, 8)
