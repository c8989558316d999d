"""CPU-side texture descriptors + manager.

Parity: util::Texture (util/texture.h) — a tagged union over
{RGB, Checkerboard, Bitmap} with a uv transform — and
resource::TextureManager (resource/texture.{h,cpp}) which caches image
files by path. Bitmap pixels are float32 RGBA, linear (LDR gamma-decoded
at load, util/texture.cpp:112-115).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from benchmark.reference.utils.image import load_image
from benchmark.reference.utils.math import Transform


class TextureType(enum.IntEnum):
    RGB = 0
    CHECKERBOARD = 1
    BITMAP = 2


class FilterMode(enum.IntEnum):
    POINT = 0
    LINEAR = 1


class AddressMode(enum.IntEnum):
    WRAP = 0
    CLAMP = 1
    MIRROR = 2


@dataclass
class Texture:
    type: TextureType = TextureType.RGB
    # RGB
    rgb: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    # Checkerboard (patch1 = color0, patch2 = color1; scene.cpp:168-172)
    patch1: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    patch2: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    # Bitmap
    data: np.ndarray | None = None  # (h, w, 4) float32 linear
    filter_mode: FilterMode = FilterMode.POINT
    address_mode: AddressMode = AddressMode.WRAP
    # uv transform (to_uv; scale-only in the reference, util_loader.cpp:199-205)
    transform: Transform = field(default_factory=Transform)

    @property
    def width(self) -> int:
        return 0 if self.data is None else self.data.shape[1]

    @property
    def height(self) -> int:
        return 0 if self.data is None else self.data.shape[0]

    def average_rgb(self) -> np.ndarray:
        """Per-channel average — the plastic precompute input
        (optix_material.cpp GetPixelAverage)."""
        if self.type == TextureType.RGB:
            return self.rgb.copy()
        if self.type == TextureType.CHECKERBOARD:
            return (self.patch1 + self.patch2) * 0.5
        return self.data[..., :3].mean(axis=(0, 1)).astype(np.float32)

    def max_channel_weight(self) -> float:
        """Emitter selection weight basis (world/emitter.cpp GetWeight):
        RGB -> max channel; checker -> mean of patch maxes; bitmap ->
        mean over pixels of max channel."""
        if self.type == TextureType.RGB:
            return float(self.rgb.max())
        if self.type == TextureType.CHECKERBOARD:
            return float((self.patch1.max() + self.patch2.max()) * 0.5)
        return float(self.data[..., :3].max(axis=-1).mean())


def rgb_texture(r: float, g: float = None, b: float = None) -> Texture:
    if g is None:
        g = b = r
    return Texture(type=TextureType.RGB, rgb=np.array([r, g, b], np.float32))


def checkerboard_texture(color0, color1) -> Texture:
    return Texture(
        type=TextureType.CHECKERBOARD,
        patch1=np.asarray(color0, np.float32),
        patch2=np.asarray(color1, np.float32),
    )


class TextureManager:
    """Image-file cache: path -> float32 RGBA pixels."""

    def __init__(self):
        self._cache: dict[str, np.ndarray] = {}

    def get_texture(self, path: str | Path) -> Texture:
        key = str(Path(path))
        if key not in self._cache:
            self._cache[key] = load_image(key)
        return Texture(type=TextureType.BITMAP, data=self._cache[key])

    def clear(self) -> None:
        self._cache.clear()
