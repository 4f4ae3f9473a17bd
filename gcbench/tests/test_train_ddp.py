"""The data-parallel train kind on the CPU: two ranks over gloo at tiny
widths, each a process of the port's ``spawn_ranks``, held against the
reference's step over both ranks' samples on one device."""

import torch

from gcbench.tests import tiny


def test_two_ranks_are_correct_and_bit_equal(tiny_root):
    # the reference runs in the parent, which sets the configurations'
    # float32 itself, whatever it found
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    result, compared = tiny.run(tiny_root, "tiny_rest.train.ddp2",
                                seed=2 ** 31 + 11)
    assert result["correct"] is True, compared
    assert compared["replicas"][0] == 0
    assert result["attempted"] >= 1
    # the devices the ranks ran on: both on the one CPU
    assert result["device"]["count"] == 1
    assert set(result["metrics"]) == {"train_step_ms", "setup_s"}
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
