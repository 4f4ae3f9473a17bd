"""What the profiled pass counts as device work, and the idle share read
from it, on hand-made events."""

from gcbench import harness, trace
from gcbench.tests import tiny


class Event:
    """A device-side profiler event with the field
    ``gcbench.trace._device_work`` reads."""

    def __init__(self, annotation):
        self.annotation = annotation

    def is_user_annotation(self):
        return self.annotation


def test_an_annotations_device_span_is_not_device_work():
    assert trace._device_work(Event(False))
    assert not trace._device_work(Event(True))


def test_idle_is_read_against_the_window_time_a_unit():
    reader = harness.load_module(
        f"{tiny.REPO}/gcbench/metrics/device_idle.train.py")
    # two steps: kernels cover 0-30 and 20-50 ms of the first, 0-20 ms of
    # the second; the profiled pass took 200 ms, the window 100 ms a step
    ms = 1_000_000
    prof = trace.Profile(window_s=0.2, n=2, device=[
        ("a", 0, 30 * ms), ("b", 20 * ms, 50 * ms),
        ("c", 100 * ms, 120 * ms)])
    assert abs(prof.busy_s() - 0.07) < 1e-12
    ctx = harness.Context(kind="train", unit_s=0.1, profile=prof)
    assert abs(reader.read(ctx) - 65.0) < 1e-9
    ctx.profile = trace.Profile(window_s=0.2, n=2, device=[])
    assert reader.read(ctx) is None


def test_the_all_reduce_readers_on_hand_made_kernels():
    def reader(name):
        return harness.load_module(f"{tiny.REPO}/gcbench/metrics/{name}.py")

    # two steps on rank 0: NCCL kernels 10-30 ms (a convolution covers
    # 20-25 ms of it) and 110-120 ms; rank 1 arrives later at the first
    # (4 ms) and earlier at the second (16 ms); 300 MB all-reduced a step
    # over 4 ranks
    ms = 1_000_000
    r0 = trace.Profile(window_s=0.2, n=2, device=[
        ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 10 * ms, 30 * ms),
        ("conv", 0, 10 * ms), ("conv", 20 * ms, 25 * ms),
        ("ncclKernel_AllReduce_RING_SIMPLE_Sum_float", 110 * ms, 120 * ms)])
    r1 = trace.Profile(window_s=0.2, n=2, device=[
        ("ncclKernel_AllReduce_RING_SIMPLE_Sum_float", 104 * ms, 120 * ms),
        ("conv", 0, 20 * ms),
        ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", 26 * ms, 30 * ms)])
    ctx = harness.Context(kind="train", unit_s=0.1, profile=r0,
                          ranks=[r0, r1],
                          work={"allreduce_bytes": 300e6, "world": 4})
    # the shortest kernel of each collective: 4 and 10 ms over 2 steps
    assert abs(reader("ddp.allreduce_ms.train").read(ctx) - 7.0) < 1e-9
    # the longest less the shortest: 16 and 6 ms
    assert abs(reader("ddp.skew_ms.train").read(ctx) - 11.0) < 1e-9
    # rank 0's NCCL time that no other kernel of rank 0 covers
    assert abs(reader("ddp.exposed_ms.train").read(ctx) - 12.5) < 1e-9
    # 1.5 x 300 MB in 7 ms a step
    assert abs(reader("ddp.busbw_gbs.train").read(ctx) - 450 / 7) < 1e-9
    # one rank alone: its own kernels, and no skew
    ctx.ranks = [r0]
    assert abs(reader("ddp.allreduce_ms.train").read(ctx) - 15.0) < 1e-9
    assert reader("ddp.skew_ms.train").read(ctx) is None
    # ranks whose passes hold different numbers of collectives match none
    ctx.ranks = [r0, trace.Profile(window_s=0.2, n=2, device=r1.device[:2])]
    for name in ("ddp.allreduce_ms.train", "ddp.skew_ms.train",
                 "ddp.busbw_gbs.train"):
        assert reader(name).read(ctx) is None
    none = trace.Profile(window_s=0.2, n=2, device=[("conv", 0, ms)])
    ctx.profile, ctx.ranks = none, [none, none]
    for name in ("ddp.allreduce_ms.train", "ddp.exposed_ms.train",
                 "ddp.busbw_gbs.train", "ddp.skew_ms.train"):
        assert reader(name).read(ctx) is None
