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
    reader = harness.load_reader(
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
