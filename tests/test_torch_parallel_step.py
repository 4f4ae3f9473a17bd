# -*- coding: utf-8 -*-
"""PyTorch port vs the JAX package: the data-parallel GAN step on two ranks
(two gloo processes on the CPU) against ``make_parallel_train_step`` on a
two-device mesh of the virtual CPU devices.

Each rank takes a sample of its own.  Both sides start from the same
weights (carried by ``interop``); the BLDG step runs PTv3 in training
mode with drop path off, and rank r's style codes are table r on both
sides (the JAX ``helpers.get_z`` is patched to pick the table by the mesh
axis index, the port's by rank).  The port's averaged gradients are held
to the gradients the JAX optimizers take after the step's ``pmean``.
Both cases run in one module fixture: the JAX steps of each, then one
pair of spawned ranks that runs the port's REST and BLDG steps in turn.
The world-size-1 step, the ranks' streams and the loop on two ranks are
in test_torch_parallel_loop.py."""

import concurrent.futures
import functools

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

import gaussiancity_tpu.models.ptv3 as jptv3_mod
import gaussiancity_tpu.utils.helpers as jhelpers
from gaussiancity_tpu.training.step import Trainer as JTrainer
from gaussiancity_tpu.training.step import (
    make_parallel_train_step as jmake_parallel_train_step)

from gaussiancity_tpu_torch import interop, testing
from gaussiancity_tpu_torch.config import Config
from gaussiancity_tpu_torch.parallel.launch import spawn_ranks
from gaussiancity_tpu_torch.testing import tiny_bldg_batch, share_cpu_cores
from gaussiancity_tpu_torch.utils import helpers
from test_torch_bldg_training import (LOSS_ATOL, LOSS_RTOL, REL, ZERO_GRAD,
                                      Z_DIM, _JPTv3NoDropPath, bldg_configs)
from test_train_step import synthetic_batch, tiny_config

share_cpu_cores()

# a spawned rank that deadlocks fails its test within this
RANK_TIMEOUT_S = 240


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def run_jax_parallel(jcfg, batches, tables=None, n_steps=2,
                     after_init=None) -> dict:
    """The JAX data-parallel step on a 2-device mesh, ``batches[r]`` on
    device r, rank r's style codes from ``tables[r]`` (when given), drop
    path off.  Per step: (state, metrics, G gradients, D gradients), the
    gradients those the optimizers take after the step's ``pmean``
    (shipped to the host by a callback inside the step).
    ``after_init(init)`` is called with the initial state before the
    steps."""
    holder = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(jptv3_mod, "PointTransformerV3", _JPTv3NoDropPath)
    if tables is not None:
        m = tables.shape[1]

        def get_z(key, ins, z_dim):
            t = holder["t"]
            return (t() if callable(t) else t)[(ins % m).astype(jnp.int32)]

        mp.setattr(jhelpers, "get_z", get_z)
    try:
        jt = JTrainer(jcfg)
        jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
        tables_j = (jnp.asarray(tables) if tables is not None
                    else jnp.zeros((2, 1, 1)))
        holder["t"] = tables_j[0]
        state = jt.init_state(jax.random.PRNGKey(0), jb[0])
        init = _np(state)
        if after_init is not None:
            after_init(init)
        captured = {}

        def store(key, grads):  # each device's copy: the same pmean
            captured[key] = grads

        def capture(tx, key):
            def update(grads, opt_state, params=None):
                jax.debug.callback(functools.partial(store, key), grads)
                return tx.update(grads, opt_state, params)
            return optax.GradientTransformation(tx.init, update)

        jt.g_tx = capture(jt.g_tx, "g")
        jt.d_tx = capture(jt.d_tx, "d")
        mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
        pstep, repl, shard = jmake_parallel_train_step(jt, mesh)
        gbatch = jax.device_put(jax.tree_util.tree_map(
            lambda *x: jnp.concatenate(x, 0), *jb), shard)
        state = jax.device_put(state, repl)
        holder["t"] = lambda: tables_j[jax.lax.axis_index("data")]
        steps = []
        for _ in range(n_steps):
            state, metrics = pstep(state, gbatch, jax.random.PRNGKey(2))
            jax.effects_barrier()
            steps.append(_np((state, metrics, captured["g"],
                              captured["d"])))
    finally:
        mp.undo()
    return dict(init=init, steps=steps)


def port_states(cfg, init) -> dict:
    """The JAX initial state as the port's state dicts."""
    return {
        "generator": interop.generator_state_from_flax(
            {"params": init.g_params, "batch_stats": init.g_stats or {}},
            cfg.network),
        "discriminator": interop.discriminator_state_from_flax(
            init.d_params, init.d_stats),
        "vgg": interop.vgg_state_from_flax(init.ploss_params)}


def _close(got, want, what, rel=REL):
    w = want.numpy() if torch.is_tensor(want) else np.asarray(want)
    np.testing.assert_allclose(
        got.numpy(), w, rtol=0, atol=rel * max(np.abs(w).max(), 1e-30),
        err_msg=what)


def check_against_jax(cfg, ranks, jrun, g_weight_atol=None) -> None:
    """Hold the port's two ranks to the JAX steps: the ranks bit-equal to
    each other; the averaged metrics within the losses' tolerance; the
    averaged gradients (G: a tensor whose JAX gradient is below ZERO_GRAD
    of the generator's largest is rounding noise and must be as small);
    G's weights within REL of each tensor's largest where the JAX gradient
    carries signal at every step so far, within 2 lr a step elsewhere
    (Adam turns noise into a full step), or within ``g_weight_atol``
    where given (the REST step's tolerance in test_torch_training.py);
    the running statistics within REL plus momentum times that; D's
    weights and spectral-norm state within REL."""
    net, lr = cfg.network, cfg.train.generator.lr
    held = None
    for i, (r0, r1, (state, jm, jg, jd)) in enumerate(
            zip(ranks[0], ranks[1], jrun["steps"])):
        assert r0["digest"] == r1["digest"], f"step {i}: replicas differ"
        for k, v in jm.items():
            np.testing.assert_allclose(r0["metrics"][k], float(v),
                                       rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                       err_msg=f"step {i} {k}")
        assert r0["metrics"]["GenLoss"] > 0 and r0["metrics"]["DisLoss"] > 0
        want = interop.generator_state_from_flax(
            {"params": state.g_params, "batch_stats": state.g_stats or {}},
            net)
        if g_weight_atol is not None:
            for n, v in r0["generator"].items():
                err = float((v - want[n]).abs().max())
                assert err <= g_weight_atol, f"step {i} G weight {n}"
        else:
            held = _check_bldg_generator(r0, state, jg, jd, want, held, i,
                                         net, lr)
        want_d = interop.discriminator_state_from_flax(
            state.d_params, state.d_stats)
        for n, v in r0["discriminator"].items():
            _close(v, want_d[n], f"step {i} D {n}")


def _check_bldg_generator(r0, state, jg, jd, want, held, i, net, lr):
    """The averaged gradients and G's weights and running statistics of
    one step, as ``check_against_jax`` sets out; returns the elements held
    within REL so far."""
    want_g = interop.generator_state_from_flax(
        {"params": jg, "batch_stats": state.g_stats or {}}, net)
    want_g = {n: want_g[n] for n in r0["g_grads"]}
    gmax = max(float(w.abs().max()) for w in want_g.values())
    for n, w in want_g.items():
        got = r0["g_grads"][n]
        if w.abs().max() < ZERO_GRAD * gmax:
            assert got.abs().max() < ZERO_GRAD * gmax, f"{i} G grad {n}"
            want_g[n] = torch.zeros_like(w)
        else:
            _close(got, w, f"step {i} G grad {n}")
    want_d = interop.discriminator_state_from_flax(jd, state.d_stats)
    for n, g in r0["d_grads"].items():
        _close(g, want_d[n], f"step {i} D grad {n}")
    signal = {n: (g.abs() >= ZERO_GRAD * g.abs().max()) & (g != 0)
              for n, g in want_g.items()}
    held = signal if held is None else {
        n: held[n] & signal[n] for n in signal}
    for n, v in r0["generator"].items():
        w = want[n]
        err = (v - w).abs()
        tol = REL * float(w.abs().max())
        if n in held:
            assert bool((err[held[n]] <= tol).all()), f"{i} G weight {n}"
            assert float(err.max()) <= 2 * lr * (i + 1) + tol, \
                f"step {i} G weight {n}"
        else:  # a running statistic
            slack = 0.01 * 2 * lr * i if n.endswith(".mean") else 0
            assert float(err.max()) <= tol + slack, f"step {i} stat {n}"
    return held


def rest_case():
    jcfg = tiny_config()
    jcfg = jcfg.replace(train=jcfg.train.replace(
        discriminator=jcfg.train.discriminator.replace(n_warmup_iters=1)))
    batches = [_np(synthetic_batch(jax.random.PRNGKey(s), jcfg))
               for s in (1, 7)]
    return jcfg, Config.from_dict(jcfg.to_dict()), batches


def bldg_case():
    jcfg, cfg = bldg_configs()
    batches = [tiny_bldg_batch(cfg, seed=s) for s in (1, 2)]
    tables = np.stack([np.random.default_rng(s).normal(
        size=(helpers.MAX_N_INSTANCES, Z_DIM)) for s in (9, 10)]
    ).astype(np.float32)
    return jcfg, cfg, batches, tables


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Per case (REST, BLDG): its config, batches, JAX run and the port's
    two ranks' steps.  The ranks start once the BLDG initial state is
    known and run while the JAX BLDG steps do."""
    rest_j, rest, rest_b = rest_case()
    bldg_j, bldg, bldg_b, tables = bldg_case()
    rest_run = run_jax_parallel(rest_j, rest_b)
    store = str(tmp_path_factory.mktemp("ddp") / "store")
    pool = concurrent.futures.ThreadPoolExecutor(1)
    started = []

    def start_ranks(bldg_init):
        calls = [(testing.ddp_steps,
                  (rest, rest_b, 2, port_states(rest, rest_run["init"]))),
                 (testing.ddp_steps,
                  (bldg, bldg_b, 2, port_states(bldg, bldg_init), tables))]
        started.append(pool.submit(
            spawn_ranks, testing.calls_in_turn, 2, store, args=(calls,),
            device="cpu", timeout_s=RANK_TIMEOUT_S))

    with pool:
        bldg_run = run_jax_parallel(bldg_j, bldg_b, tables,
                                    after_init=start_ranks)
        ranks = started[0].result()
    return {"REST": (rest, rest_b, rest_run, [r[0] for r in ranks]),
            "BLDG": (bldg, bldg_b, bldg_run, [r[1] for r in ranks])}


class TestDataParallelStep:
    def test_rest_two_ranks_match_jax(self, two_ranks):
        cfg, batches, jrun, ranks = two_ranks["REST"]
        check_against_jax(cfg, ranks, jrun,
                          g_weight_atol=1e-3 * cfg.train.generator.lr)
        # the ranks took different samples: their averaged step is not
        # either sample's own
        assert batches[0]["pts"].tolist() != batches[1]["pts"].tolist()

    def test_bldg_two_ranks_match_jax(self, two_ranks):
        cfg, _, jrun, ranks = two_ranks["BLDG"]
        check_against_jax(cfg, ranks, jrun)
        assert ranks[0][0]["metrics"]["PTv3PoolOverflow"] == 0
        # the running statistics moved, and the replicas hold the average
        stats = [k for k in ranks[0][0]["generator"]
                 if k.startswith("pt_net.") and k.endswith((".mean", ".var"))]
        assert len(stats) > 10
        init = port_states(cfg, jrun["init"])["generator"]
        assert any(not torch.equal(ranks[0][1]["generator"][k], init[k])
                   for k in stats)
