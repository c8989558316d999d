"""CPU-side emitter descriptors.

Parity: resource::Emitter (resource/emitter.h) — {Area, Point, ConstEnv,
EnvMap, Directional} — loaded from XML exactly as scene.cpp:189-224.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

from benchmark.reference.scene.textures import (
    AddressMode,
    FilterMode,
    Texture,
    rgb_texture,
)
from benchmark.reference.utils.math import Transform


class EmitterType(enum.IntEnum):
    UNKNOWN = 0
    AREA = 1
    POINT = 2
    CONST_ENV = 3
    ENV_MAP = 4
    DIRECTIONAL = 5


@dataclass
class Emitter:
    type: EmitterType = EmitterType.UNKNOWN
    # area
    radiance: Texture = field(default_factory=lambda: rgb_texture(0.0))
    # point
    position: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    intensity: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    # const env
    color: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    # env map
    scale: float = 1.0
    transform: Transform = field(default_factory=Transform)
    # directional
    direction: np.ndarray = field(default_factory=lambda: np.array([0, 0, 1], np.float32))


def _float3(value: str | None, default=(0.0, 0.0, 0.0)) -> np.ndarray:
    if not value:
        return np.asarray(default, np.float32)
    parts = [float(p) for p in value.split(",")]
    if len(parts) == 1:
        parts = parts * 3
    return np.asarray(parts[:3], np.float32)


def load_emitter_from_xml(obj, scene) -> Emitter:
    em = Emitter()
    etype = obj.type
    if etype == "area":
        em.type = EmitterType.AREA
        # radiance may be a nested texture or rgb (LoadTextureOrRGB)
        from benchmark.reference.scene.materials import _texture_or_rgb

        em.radiance = _texture_or_rgb(obj, scene, "radiance", 0.0)
    elif etype == "point":
        em.type = EmitterType.POINT
        em.position = _float3(obj.properties.get("position"))
        em.intensity = _float3(obj.properties.get("intensity"))
    elif etype == "constant":
        em.type = EmitterType.CONST_ENV
        em.color = _float3(obj.properties.get("radiance"))
    elif etype == "directional":
        em.type = EmitterType.DIRECTIONAL
        em.direction = _float3(obj.properties.get("direction"), (0.0, 0.0, 1.0))
        n = float(np.linalg.norm(em.direction))
        if n > 0:
            em.direction = em.direction / n
        em.intensity = _float3(obj.properties.get("irradiance"))
        for sub in obj.sub_objects:
            if sub.tag == "transform":
                t = scene.load_transform(sub)
                d = t.matrix[:3, :3] @ em.direction
                em.direction = (d / max(np.linalg.norm(d), 1e-20)).astype(
                    np.float32
                )
    elif etype == "envmap":
        em.type = EmitterType.ENV_MAP
        em.scale = float(obj.properties.get("scale", 1.0))
        filename = obj.properties.get("filename", "")
        tex = scene.texture_manager.get_texture(scene.root_path / filename)
        tex.filter_mode = FilterMode.LINEAR
        tex.address_mode = AddressMode.WRAP
        em.radiance = tex
        for sub in obj.sub_objects:
            if sub.tag == "transform":
                em.transform = scene.load_transform(sub)
    else:
        from benchmark.reference.utils.log import get_logger

        get_logger(__name__).warning("unknown emitter type [%s]", etype)
    return em
