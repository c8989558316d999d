"""Vec3 / Vec2: structure-of-planes vectors (three dense (N,) tensors).

Mirrors pupiloptixlab_tpu/render/vec.py. The plane layout keeps every
elementwise op a contiguous (N,) pass, which is also the coalesced layout
for the CUDA kernels that read ray planes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Vec3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    def __rmul__(self, o):
        return self.__mul__(o)

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    # -- geometry -------------------------------------------------------------
    def dot(self, o: "Vec3"):
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def length_sq(self):
        return self.dot(self)

    def length(self):
        return torch.sqrt(torch.clamp(self.length_sq(), min=0.0))

    def normalized(self) -> "Vec3":
        inv = torch.reciprocal(torch.clamp(self.length(), min=1e-20))
        return Vec3(self.x * inv, self.y * inv, self.z * inv)

    def max_abs(self):
        return torch.maximum(
            torch.abs(self.x), torch.maximum(torch.abs(self.y), torch.abs(self.z))
        )

    def sum(self):
        return self.x + self.y + self.z

    # -- conversion / selection --------------------------------------------------
    @staticmethod
    def full(n: int, x: float, y: float, z: float, device=None) -> "Vec3":
        def f(v):
            return torch.full((n,), v, dtype=torch.float32, device=device)

        return Vec3(f(x), f(y), f(z))

    @staticmethod
    def zeros(n: int, device=None) -> "Vec3":
        z = torch.zeros(n, dtype=torch.float32, device=device)
        return Vec3(z, z, z)

    @staticmethod
    def ones(n: int, device=None) -> "Vec3":
        o = torch.ones(n, dtype=torch.float32, device=device)
        return Vec3(o, o, o)

    @staticmethod
    def from_array(a: torch.Tensor) -> "Vec3":
        """(N,3) -> planes."""
        return Vec3(a[..., 0], a[..., 1], a[..., 2])

    @staticmethod
    def broadcast(v: torch.Tensor, n: int) -> "Vec3":
        """(3,) constant -> planes broadcast to length n."""
        return Vec3(v[0].expand(n), v[1].expand(n), v[2].expand(n))

    def to_array(self) -> torch.Tensor:
        """planes -> (N, 3); only at output boundaries."""
        return torch.stack([self.x, self.y, self.z], dim=-1)


def where(mask, a, b):
    """Lane select over any NamedTuple of planes; ``mask`` is (N,) bool."""
    return type(a)(*(torch.where(mask, ai, bi) for ai, bi in zip(a, b)))


class Vec2(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor

    def __add__(self, o):
        if isinstance(o, Vec2):
            return Vec2(self.x + o.x, self.y + o.y)
        return Vec2(self.x + o, self.y + o)

    def __mul__(self, o):
        if isinstance(o, Vec2):
            return Vec2(self.x * o.x, self.y * o.y)
        return Vec2(self.x * o, self.y * o)

    __rmul__ = __mul__

    @staticmethod
    def zeros(n: int, device=None) -> "Vec2":
        z = torch.zeros(n, dtype=torch.float32, device=device)
        return Vec2(z, z)

    def to_array(self) -> torch.Tensor:
        return torch.stack([self.x, self.y], dim=-1)


def where2(mask, a: Vec2, b: Vec2) -> Vec2:
    return Vec2(torch.where(mask, a.x, b.x), torch.where(mask, a.y, b.y))
