"""BufferManager: named device-buffer registry.

Counterpart of pupiloptixlab_tpu/system/buffers.py (system/buffer.{h,cpp}
parity): named device buffers with a "displayable" flag feeding the GUI's
buffer-selector dropdown. The arrays are torch tensors on the manager's
device (``None``: the card), where the passes that fill them run.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import torch

from pupiloptixlab_tpu_torch.device import resolve_device

DEFAULT_FINAL_RESULT_BUFFER_NAME = "final result"  # buffer.h:46


class BufferFlag(enum.IntFlag):
    NONE = 0
    ALLOW_DISPLAY = 1


@dataclass
class BufferDesc:
    name: str
    flag: BufferFlag = BufferFlag.NONE
    width: int = 0
    height: int = 0
    stride_in_bytes: int = 0  # informational; dtype/shape carry the truth
    channels: int = 4


@dataclass
class Buffer:
    desc: BufferDesc
    array: torch.Tensor | None = None  # (h*w, channels) or (h*w,) device tensor


class BufferManager:
    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._buffers: dict[str, Buffer] = {}

    def alloc(self, desc: BufferDesc, zero: bool = True) -> Buffer:
        shape = (
            (desc.height * desc.width, desc.channels)
            if desc.channels > 1
            else (desc.height * desc.width,)
        )
        array = (
            torch.zeros(shape, dtype=torch.float32, device=self.device) if zero else None
        )
        buf = Buffer(desc=desc, array=array)
        self._buffers[desc.name] = buf
        return buf

    def add(self, name: str, array: torch.Tensor, flag: BufferFlag = BufferFlag.NONE,
            width: int = 0, height: int = 0) -> Buffer:
        channels = array.shape[1] if array.dim() > 1 else 1
        buf = Buffer(
            desc=BufferDesc(name=name, flag=flag, width=width, height=height,
                            channels=channels),
            array=array,
        )
        self._buffers[name] = buf
        return buf

    def set_array(self, name: str, array: torch.Tensor) -> None:
        self._buffers[name].array = array

    def get(self, name: str) -> Buffer | None:
        return self._buffers.get(name)

    def __getitem__(self, name: str) -> Buffer:
        return self._buffers[name]

    def __contains__(self, name: str) -> bool:
        return name in self._buffers

    def displayable_names(self) -> list[str]:
        """The GUI dropdown list (buffer.cpp GetBufferNameList analog)."""
        return [
            n
            for n, b in self._buffers.items()
            if b.desc.flag & BufferFlag.ALLOW_DISPLAY
        ]

    def clear(self) -> None:
        self._buffers.clear()
