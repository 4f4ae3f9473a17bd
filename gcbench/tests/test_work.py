"""The benchmark's own counts against hand counts on small cases."""

import torch

from gcbench.reference.gct.config import RasterizerConfig
from gcbench.reference.gct.camera import CameraModel
from gcbench.reference.gct.models import ptv3
from gcbench.work import k1, peaks
from gcbench.work.flops import SubMConvCall, WorkCounter


def test_flops_of_a_linear_and_a_convolution():
    lin = torch.nn.Linear(6, 5)
    conv = torch.nn.Conv2d(3, 4, 3, padding=1)
    x = torch.randn(7, 6, requires_grad=True)
    img = torch.randn(2, 3, 8, 8)
    with WorkCounter([lin, conv]) as w:
        lin(x).sum().backward()
        conv(img)
    # linear: 2*7*6*5 forward; backward: input and weight, 2x forward
    # convolution: 2 * (2*8*8 outputs) * 4 channels * 3*3*3 taps
    assert w.flops() == 3 * 2 * 7 * 6 * 5 + 2 * (2 * 8 * 8) * 4 * 27
    assert w.calls == []


def _cloud():
    """Three points on a line, one voxel apart, and one alone."""
    gc = torch.tensor([[0, 0, 0], [1, 0, 0], [2, 0, 0], [9, 9, 9]])
    return gc


def test_submconv_pairs_forward_and_backward():
    conv = ptv3.SubMConv(4, 6, 3)
    gc = _cloud()
    nbrs = ptv3.subm_neighbors(gc, torch.ones(4, dtype=torch.bool), 3, 10)
    # by hand: each point finds itself; the middle one both sides, the
    # ends one side each: 4 + 2 + 2 = 8 pairs of the 27 x 4 offsets
    assert int(nbrs[1].sum()) == 8
    feat = torch.randn(4, 4, requires_grad=True)
    with WorkCounter([conv]) as w:
        conv(feat, nbrs).sum().backward()
    (call,) = w.calls
    assert call["pairs"] == 8 and call["n"] == 4 and call["k3"] == 27
    assert call.flops() == 3 * 2 * 8 * 4 * 6
    # FlopCounterMode saw the dense products: 27 offsets x [4, 4] @ [4, 6]
    # forward, both gradients backward; the counter swaps them for pairs
    assert w.flops() == call.flops()
    fwd = 4 * (4 * 4 + 4 * 6 + 27 * 4 * 6) + 27 * 4 * 5
    bwd = 4 * (4 * 6 + 2 * 4 * 4 + 2 * 27 * 4 * 6) + 27 * 4 * 5
    assert call.bytes() == fwd + bwd


def test_submconv_in_eval_counts_the_forward_only():
    call = SubMConvCall(pairs=10, n=5, k3=27, cin=2, cout=3, bwd=False,
                        bwd_input=False)
    assert call.flops() == 2 * 10 * 2 * 3
    assert call.padded_flops() == 2 * 27 * 5 * 2 * 3


def test_k1_work_of_one_gaussian_by_hand():
    """One opaque Gaussian straight ahead, tiny: every tested pair is
    counted once and the pixels it reaches are eligible."""
    cfg = RasterizerConfig(tile_h=16, tile_w=16, tile_capacity=8)
    cam = CameraModel([[50.0, 0, 16], [0, 50.0, 16], [0, 0, 1]], (32, 32)
                      ).params([0.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0],
                               device="cpu")
    gs = torch.tensor([[10.0, 0, 0, 0.9, 0.05, 0.05, 0.05, 1, 0, 0, 0,
                        0.5, 0.5, 0.5]])
    w = k1.frame_work(gs, cam, cfg)
    assert w["ops"] > 0
    # bytes: 1 Gaussian x 10 floats, its slots, 4 tile counts, 32x32 x 5
    n_slots = (w["bytes"] - 40 - 16 - 32 * 32 * 20) / 4
    assert n_slots == int(n_slots) and 1 <= n_slots <= 4


def test_bound_takes_the_larger():
    t, by = peaks.bound_s(67e12, 1.0)
    assert (t, by) == (1.0, "operations")
    t, by = peaks.bound_s(1.0, 3.35e12)
    assert (t, by) == (1.0, "bytes")
