"""Pass base class (system/pass.h parity); a copy of
pupiloptixlab_tpu/system/pass_base.py.

A pass is one stage of the frame graph: named, taggable (Pre passes run
once per Precompute event; the rest run every frame), toggleable, and
timed — the per-pass time feeds the inspector/console readout.
"""

from __future__ import annotations

import enum
from abc import ABC, abstractmethod

from pupiloptixlab_tpu_torch.utils.timer import Timer


class PassTag(enum.IntFlag):
    NONE = 0
    PRE = 1
    POST = 2
    ASYNC = 4


class Pass(ABC):
    def __init__(self, name: str, tag: PassTag = PassTag.NONE):
        self.name = name
        self.tag = tag
        self.enabled = True
        self.timer = Timer()

    def run(self) -> None:
        if not self.enabled:
            return
        self.timer.start()
        self.on_run()
        self.timer.stop()

    @abstractmethod
    def on_run(self) -> None:
        ...

    @property
    def last_exec_time_ms(self) -> float:
        return self.timer.elapsed_ms

    def inspector(self) -> dict:
        """Introspection payload (the ImGui inspector analog)."""
        return {
            "name": self.name,
            "enabled": self.enabled,
            "time_ms": round(self.last_exec_time_ms, 3),
        }
