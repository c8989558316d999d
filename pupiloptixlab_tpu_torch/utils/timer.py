"""Stopwatch (util/timer.h analog)."""

from __future__ import annotations

import time


class Timer:
    def __init__(self):
        self._start = 0.0
        self._elapsed = 0.0
        self._running = False

    def start(self) -> None:
        self._start = time.perf_counter()
        self._running = True

    def stop(self) -> None:
        if self._running:
            self._elapsed = time.perf_counter() - self._start
            self._running = False

    @property
    def elapsed_ms(self) -> float:
        if self._running:
            return (time.perf_counter() - self._start) * 1e3
        return self._elapsed * 1e3

    @property
    def elapsed_s(self) -> float:
        return self.elapsed_ms / 1e3
