"""ComputePass — run an arbitrary device function into named buffers.

Counterpart of pupiloptixlab_tpu/passes/compute.py (example/cuda_test, the
raw-CUDA pass demo): a pass that fills displayable buffers each frame from a
user-supplied function, demonstrating the framework shell without the path
tracer. The function makes its tensors on the device it chooses, normally
the system's (``system.buffers.device``); the pass stores them as they are.
"""

from __future__ import annotations

from typing import Callable

from pupiloptixlab_tpu_torch.system.buffers import BufferFlag
from pupiloptixlab_tpu_torch.system.pass_base import Pass, PassTag


class ComputePass(Pass):
    """fn(frame_index, width, height) -> dict[name, (h*w, c) tensor]."""

    def __init__(
        self,
        fn: Callable[[int, int, int], dict],
        width: int,
        height: int,
        name: str = "Compute",
    ):
        super().__init__(name, PassTag.NONE)
        self.fn = fn
        self.width = width
        self.height = height
        self.frame_index = 0
        self.system = None

    def bind(self, system) -> None:
        self.system = system

    def on_run(self) -> None:
        outputs = self.fn(self.frame_index, self.width, self.height)
        bm = self.system.buffers
        for name, arr in outputs.items():
            if name in bm:
                bm.set_array(name, arr)
            else:
                bm.add(name, arr, BufferFlag.ALLOW_DISPLAY, self.width, self.height)
        self.frame_index += 1
