"""Profiling / observability.

Counterpart of pupiloptixlab_tpu/utils/profiling.py. The reference's
instrumentation is a per-pass Timer surfaced in the ImGui inspector plus a
GUI FPS readout (system/pass.cpp:6-18, gui.cpp:535) and NVCC line info for
Nsight. Here:

* ``FrameStats`` — rolling frame/pass timing statistics (the console
  readout, headless),
* ``trace(logdir)`` — context manager around ``torch.profiler`` writing a
  Chrome trace of the host ops and, on the card, of the device's kernels
  and copies (viewable in Perfetto or chrome://tracing),
* ``annotate(name)`` — a named host-side range in that trace.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import tempfile
import time
from collections import deque
from pathlib import Path

import torch

from pupiloptixlab_tpu_torch.device import resolve_device


class FrameStats:
    """Rolling window of frame times + per-pass breakdowns.

    The times are host times: ``System`` and ``Pass.run`` read
    ``time.perf_counter`` around the work with no device synchronise
    (utils/timer.py), as the reference does. On the card a frame's time is
    therefore the time the host takes to issue its work plus every wait the
    frame makes for the card on the way (the traversal wrappers read a
    fault flag after each launch, a display client fetches its image); a
    frame that ends with work still queued hands that device time to the
    next frame. Over a window the mean follows the slower of the host's
    issue rate and the card, not the card's time alone."""

    def __init__(self, window: int = 120):
        self.window = window
        self._frames: deque[float] = deque(maxlen=window)
        self._passes: dict[str, deque] = {}

    def record_frame(self, ms: float) -> None:
        self._frames.append(float(ms))

    def record_pass(self, name: str, ms: float) -> None:
        self._passes.setdefault(name, deque(maxlen=self.window)).append(float(ms))

    def bind(self, system) -> None:
        """Attach to a System: frame times from FRAME_FINISHED, pass times
        from each pass's timer after every frame."""
        from pupiloptixlab_tpu_torch.utils.event import FRAME_FINISHED

        def on_frame(ms):
            self.record_frame(ms)
            for p in system.passes:
                self.record_pass(p.name, p.last_exec_time_ms)

        system.events.bind(FRAME_FINISHED, on_frame)

    @property
    def fps(self) -> float:
        if not self._frames:
            return 0.0
        mean = statistics.fmean(self._frames)
        return 1000.0 / mean if mean > 0 else 0.0

    def summary(self) -> dict:
        out = {"frames": len(self._frames), "fps": round(self.fps, 2)}
        if self._frames:
            out["frame_ms"] = {
                "mean": round(statistics.fmean(self._frames), 3),
                "min": round(min(self._frames), 3),
                "max": round(max(self._frames), 3),
            }
        out["passes"] = {
            name: round(statistics.fmean(v), 3) for name, v in self._passes.items() if v
        }
        return out


@contextlib.contextmanager
def trace(logdir: str | Path | None = None, device=None):
    """Profile the enclosed work and write it as a Chrome trace.

    ``logdir`` (default: ``pupil_trace`` in the temporary directory) gets
    one ``pupil_<pid>_<ns>.pt.trace.json`` a capture; the context yields
    ``logdir``. ``device`` is the work's device (``None``: the card, which
    raises where there is none): on a card the trace holds the device's
    kernels and copies (CUDA activity) beside the host ops, on the CPU the
    host ops alone."""
    from torch.profiler import ProfilerActivity, profile

    logdir = Path(logdir if logdir is not None
                  else Path(tempfile.gettempdir()) / "pupil_trace")
    cuda = resolve_device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=activities)
    prof.start()
    try:
        yield str(logdir)
    finally:
        if cuda:
            torch.cuda.synchronize()  # the enclosed kernels end inside the capture
        prof.stop()
        logdir.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(
            str(logdir / f"pupil_{os.getpid()}_{time.time_ns()}.pt.trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named host-side phase, visible in captured traces."""
    with torch.profiler.record_function(name):
        yield


class Stopwatch:
    """Inline micro-timer for host phases (scene load, flatten, ...)."""

    def __init__(self):
        self.laps: dict[str, float] = {}

    @contextlib.contextmanager
    def lap(self, name: str):
        t0 = time.perf_counter()
        yield
        self.laps[name] = self.laps.get(name, 0.0) + (time.perf_counter() - t0)
