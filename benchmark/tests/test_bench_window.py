"""The window arithmetic of the end-to-end and idle metrics: a rate over
the whole window, a frame's time over every frame, idle time as the
window less the union of the device's intervals."""

import pytest

from benchmark.harness import spec
from benchmark.harness.trace import idle_gaps, union_s
from conftest import REPO


def metric(name):
    return spec.load_module(REPO, "metrics", name).read


def test_sample_ms_is_the_whole_window_over_every_sample():
    rec = {"kind": "offline", "window_s": 10.0, "samples": 4 * 64,
           "images": [{"t0": 0.0, "t1": 2.5}, {"t0": 2.6, "t1": 10.0}]}
    assert metric("sample_ms")(rec) == pytest.approx(10.0e3 / 256)
    assert metric("frame_ms")(rec) is None


def test_frame_ms_is_the_whole_window_over_every_frame():
    frames = [{"ms": float(i)} for i in range(1, 201)]
    rec = {"kind": "interactive", "window_s": sum(f["ms"] for f in frames) / 1e3, "frames": frames}
    assert metric("frame_ms")(rec) == pytest.approx(100.5)
    assert metric("sample_ms")(rec) is None


def test_union_clips_overlaps_to_the_window():
    iv = [(0.5, 2.0), (1.0, 3.0), (5.0, 6.0), (9.0, 12.0)]
    assert union_s(iv, 1.0, 10.0) == pytest.approx(2.0 + 1.0 + 1.0)
    assert idle_gaps(iv, 1.0, 10.0) == [(3.0, 5.0), (6.0, 9.0)]
    assert idle_gaps([], 0.0, 1.0) == [(0.0, 1.0)]


def test_device_idle_sets_busy_time_against_the_unprofiled_host_time():
    images = [{"t0": 0.0, "t1": 0.4, "phase": "clean"}, {"t0": 0.4, "t1": 0.6, "phase": "clean"},
              {"t0": 0.6, "t1": 1.2, "phase": "traced"}, {"t0": 1.2, "t1": 1.9, "phase": "after"}]
    rec = {"kind": "offline", "images": images, "trace": {"busy_s": 0.225}}
    assert metric("device_idle.offline")(rec) == pytest.approx(25.0)   # 0.225 of 0.3 s
    frames = [{"ms": 100.0, "phase": "clean"}, {"ms": 300.0, "phase": "clean"},
              {"ms": 250.0, "phase": "pump"}, {"ms": 500.0, "phase": "traced"},
              {"ms": 400.0, "phase": "after"}]
    rec = {"kind": "interactive", "frames": frames, "trace": {"busy_s": 0.3, "frames": 2}}
    assert metric("device_idle.interactive")(rec) == pytest.approx(25.0)  # 150 of 200 ms
    assert metric("device_idle.offline")(rec) is None
    assert metric("device_idle.interactive")({"kind": "interactive"}) is None
