# -*- coding: utf-8 -*-
"""The data-parallel step and loop of the port on gloo ranks on the CPU:
the backend choice, ``spawn_ranks``'s default device and the meshes, a
world-size-1 step against ``Trainer.train_step`` bit for bit, the ranks'
random streams, and ``train()`` on two ranks (replicas, the master's
checkpoints, resume, and each rank's batches against the JAX loop's
devices).  The step against the JAX package is in
test_torch_parallel_step.py."""

import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from gaussiancity_tpu.data import datasets as jdatasets

from gaussiancity_tpu_torch import testing
from gaussiancity_tpu_torch.data import datasets
from gaussiancity_tpu_torch.parallel import mesh
from gaussiancity_tpu_torch.parallel.launch import spawn_ranks
from gaussiancity_tpu_torch.testing import tiny_bldg_batch
from gaussiancity_tpu_torch.training import checkpoint
from gaussiancity_tpu_torch.training.step import Trainer, rank_generator
from test_torch_bldg_training import bldg_configs
from test_torch_data import tiny_train_cfg
from test_torch_parallel_step import RANK_TIMEOUT_S, rest_case


class TestMesh:
    def test_backend_choice(self):
        """gloo on the CPU and where two ranks share a card, NCCL where
        each rank has its own; read from the store before any
        collective."""
        cpu, card0, card1 = (torch.device("cpu"), torch.device("cuda", 0),
                             torch.device("cuda", 1))
        for mine, other, want in ((cpu, cpu, "gloo"),
                                  (card0, card0, "gloo"),
                                  (card0, card1, "nccl")):
            store = dist.HashStore()
            store.set(mesh._KEY.format(1),
                      f"{socket.gethostname()}/{other}")
            assert mesh.choose_backend(store, 0, 2, mine) == want
        assert mesh.choose_backend(dist.HashStore(), 0, 1, card0) == "nccl"
        # one process: no rendezvous, the device resolved
        assert mesh.init_dist(None, 1, None, "cpu") == cpu
        assert not dist.is_initialized()
        assert (mesh.get_rank(), mesh.get_world_size(),
                mesh.is_master()) == (0, 1, True)
        assert mesh.rank_device(3, "cpu") == cpu

    def test_spawn_ranks_defaults_to_the_card(self, tmp_path,
                                              monkeypatch):
        """Without a card, ``spawn_ranks`` raises unless asked for the CPU,
        before it starts a process."""
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            spawn_ranks(testing.mesh_rank, 2, str(tmp_path / "store"))
        assert not (tmp_path / "store").exists()

    def test_meshes_on_two_ranks(self, tmp_path):
        ranks = spawn_ranks(testing.mesh_rank, 2, str(tmp_path / "store"),
                            device="cpu", timeout_s=RANK_TIMEOUT_S)
        for r in ranks:
            assert r["data"] == ([[0], [1]], ("data", "tile"), [2, 1])
            assert r["simple"] == ([0, 1], ("data",), [2])
            assert torch.equal(r["gathered"], torch.tensor(
                [[0.0] * 3] * 2 + [[1.0] * 3] * 2))


class TestOneRank:
    def test_one_rank_equals_train_step_bit_for_bit(self, tmp_path):
        """One rank of a gloo group in this process: two steps of
        ``make_parallel_train_step`` against a twin ``Trainer``."""
        _, cfg, batches = rest_case()
        cpu = torch.device("cpu")
        mesh.init_group(dist.FileStore(str(tmp_path / "store"), 1), 0, 1,
                        cpu)
        try:
            got = testing.ddp_steps(0, 1, cpu, cfg, batches[:1], 2)
        finally:
            dist.destroy_process_group()
        t = Trainer(cfg, device="cpu", seed=0)
        batch = {k: torch.from_numpy(v) for k, v in batches[0].items()}
        for i, rec in enumerate(got):
            m = t.train_step(batch)
            for k, v in m.items():
                assert float(v) == rec["metrics"][k], f"step {i} {k}"
            for part, grads in (("generator", "g_grads"),
                                ("discriminator", "d_grads")):
                module = getattr(t, part)
                for n, v in module.state_dict().items():
                    assert torch.equal(v, rec[part][n]), f"{i} {part} {n}"
                for n, p in module.named_parameters():
                    assert torch.equal(p.grad, rec[grads][n]), f"{i} {n}"
            assert checkpoint.state_digest(t) == rec["digest"]


class TestRankStreams:
    def test_ranks_draw_apart_and_repeat(self, tmp_path):
        _, cfg = bldg_configs()
        t = Trainer(cfg, device="cpu", seed=0)

        def draws(step, rank):
            g = rank_generator(t, step, rank)
            return torch.randn(8, generator=g), torch.rand(8, generator=g)

        for step in (0, 3):
            r0, r1 = draws(step, 0), draws(step, 1)
            for a, b in zip(r0, r1):
                assert not torch.equal(a, b)
            for a, b in zip(r0, draws(step, 0)):
                assert torch.equal(a, b)
        # a one-rank step keeps the trainer's own stream
        own = t.step_generators(2)
        assert torch.equal(torch.randn(8, generator=own[0]),
                           torch.randn(8, generator=t.step_generators(2)[0]))
        # on two ranks the z tables the steps draw differ, and a repeat
        # of the run from a new trainer draws them again
        batch = tiny_bldg_batch(cfg, seed=1)
        run = (testing.ddp_steps, (cfg, [batch, batch], 1))
        ranks = spawn_ranks(testing.calls_in_turn, 2,
                            str(tmp_path / "store"), args=([run, run],),
                            device="cpu", timeout_s=RANK_TIMEOUT_S)
        ((a0,), (b0,)), ((a1,), (b1,)) = ranks
        assert a0["z_sums"] != a1["z_sums"]
        assert [b0["z_sums"], b1["z_sums"]] == [a0["z_sums"], a1["z_sums"]]
        assert b0["digest"] == a0["digest"] == a1["digest"]


class TestTrainLoopTwoRanks:
    def test_loop_ranks_equal_and_resume(self, tmp_path):
        """``train()`` of the tiny REST config on two ranks over the
        synthetic dataset: both ranks end bit-equal, the master alone
        writes one checkpoint an epoch, a run resumed from the first
        epoch's checkpoint ends bit-equal to the straight run, and rank
        r's batches are those the JAX loop's device r takes."""
        n_items = 2
        cfg = tiny_train_cfg("REST", str(tmp_path / "straight"))
        ranks = spawn_ranks(testing.train_loop_rank, 2,
                            str(tmp_path / "store"),
                            args=(cfg, n_items, str(tmp_path / "resumed")),
                            device="cpu", timeout_s=RANK_TIMEOUT_S)
        steps = cfg.train.n_epochs * n_items // 2
        for r in ranks:
            assert r["step"] == r["resumed_step"] == steps
        assert ranks[0]["digest"] == ranks[1]["digest"]
        assert ranks[0]["resumed_digest"] == ranks[0]["digest"]
        assert ranks[1]["resumed_digest"] == ranks[1]["digest"]
        for run in ("straight", "resumed"):
            ckpt = tmp_path / run / "ckpt" / cfg.exp_name
            assert sorted(p.name for p in ckpt.iterdir()) == [
                "epoch-00001.pt", "epoch-00002.pt"]
        # the JAX loop on two devices: a global batch of 2 a step, device
        # r taking row r; the port's items draw their crops from (seed,
        # epoch, item)
        jcfg = jdatasets.Config.from_dict(cfg.to_dict())
        jloader = jdatasets.DataLoader(
            jdatasets.SyntheticDataset(jcfg, "train", n_items=n_items),
            batch_size=2, shuffle=True, seed=cfg.train.seed,
            num_workers=0, process_index=0, process_count=1)
        ds = datasets.SyntheticDataset(cfg, "train", n_items=n_items)
        for r, rank in enumerate(ranks):
            assert len(rank["fed"]) == steps
            fed = iter(rank["fed"])
            for e in range(1, cfg.train.n_epochs + 1):
                local, starts = jloader._batch_starts(e)
                for s in starts:
                    j = int(local[s + r])
                    item = ds.get(j, np.random.default_rng(
                        (cfg.train.seed, e, j)))
                    np.testing.assert_array_equal(next(fed)[0], item["pts"])
