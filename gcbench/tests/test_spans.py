"""The span readers on a hand-built profiled pass: two units of the
program, spans, runtime calls, kernels, copies and fills, and a
synchronise outside every span (the harness's closing one)."""

import pytest

from gcbench import harness, spans, trace
from gcbench.tests import tiny

US = 1_000  # ns
HOST = [
    # unit 0: a step with PTv3 inside its generator stage
    ("gct/train_step#0", 0, 100 * US),
    ("gct/generator", 5 * US, 40 * US),
    ("gct/ptv3", 10 * US, 30 * US),
    ("cudaLaunchKernel", 12 * US, 13 * US),
    ("cudaLaunchKernelExC", 14 * US, 15 * US),
    ("cudaLaunchKernel", 50 * US, 51 * US),
    ("gct/sync.crop_origin", 55 * US, 72 * US),
    ("cudaStreamSynchronize", 60 * US, 70 * US),
    # unit 1
    ("gct/train_step#1", 120 * US, 220 * US),
    ("gct/ptv3", 125 * US, 140 * US),
    ("cuLaunchKernel", 126 * US, 127 * US),
    ("gct/sync.stage", 150 * US, 156 * US),
    ("cudaDeviceSynchronize", 150 * US, 155 * US),
    ("cudaEventSynchronize", 200 * US, 202 * US),
    ("aten::add", 160 * US, 170 * US),  # a torch op, not counted
    # the harness's closing synchronise, outside every span
    ("cudaDeviceSynchronize", 230 * US, 260 * US),
]
DEVICE = [
    ("k_a", 13 * US, 20 * US), ("k_b", 20 * US, 45 * US),
    ("Memcpy DtoH (Device -> Pageable)", 61 * US, 62 * US),
    ("Memset (Device)", 121 * US, 122 * US),
    ("k_c", 127 * US, 140 * US), ("blend_fwd_kernel", 160 * US, 210 * US),
]


def profile(host=HOST):
    return trace.Profile(window_s=0.3, n=2, device=list(DEVICE),
                         host=list(host))


def reader(name):
    return harness.load_module(f"{tiny.REPO}/gcbench/metrics/{name}.py")


@pytest.mark.parametrize("name,want", [
    ("host.syncs.train", 3 / 2), ("host.syncs.frame", 3 / 2),
    ("host.sync_ms.train", (10 + 5 + 2) * 1e-3 / 2),
    ("host.sync_ms.frame", (10 + 5 + 2) * 1e-3 / 2),
    ("kernels.launches.train", 4 / 2), ("kernels.launches.frame", 4 / 2),
    ("ptv3.launches.frame", 3 / 2)])
def test_reader_counts(name, want):
    ctx = harness.Context(kind="train", unit_s=0.1, profile=profile())
    assert reader(name).read(ctx) == pytest.approx(want)
    # a program without gct/ spans gives nothing
    bare = profile([ev for ev in HOST if not ev[0].startswith("gct/")])
    assert reader(name).read(harness.Context(kind="train",
                                             profile=bare)) is None
    assert reader(name).read(harness.Context(kind="train")) is None


def test_ptv3_launches_need_ptv3_spans():
    host = [ev for ev in HOST if ev[0] != "gct/ptv3"]
    assert spans.launches_in(profile(host), "ptv3") is None


def test_units_are_the_top_level_spans():
    assert spans.units(profile()) == [(0, 100 * US), (120 * US, 220 * US)]


def test_split_names_idle_time_by_span():
    got = spans.split(profile())
    # unit 0 idle: 0-13, 45-61, 62-100 us; unit 1: 120-121, 122-127,
    # 140-160, 210-220 us
    assert got["idle_ms"] == pytest.approx((13 + 16 + 38 + 1 + 5 + 20 + 10)
                                           * 1e-3 / 2)
    # under generator / ptv3 (0-13, 122-127) and the sync spans (45-61,
    # 62-100, 140-160)
    below = 8 + 2 + 6 + 10 + 6
    assert got["idle_under_span"] == pytest.approx(
        below / (13 + 16 + 38 + 1 + 5 + 20 + 10))
    assert got["syncs_by_span"]["gct/sync.crop_origin"][0] == 0.5
    assert got["syncs_by_span"]["gct/sync.stage"][0] == 0.5
    assert got["syncs_by_span"]["gct/train_step#1"][0] == 0.5
    assert got["longest_gaps_ms"][0][2] == pytest.approx(0.038)
