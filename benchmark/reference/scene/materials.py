"""Material descriptors and XML loaders for the seven BSDF types.

Parity: resource::Material (resource/material.{h,cpp}) — a tagged union
over {Diffuse, Dielectric, RoughDielectric, Conductor, RoughConductor,
Plastic, RoughPlastic} plus a `twosided` wrapper flag — with the same XML
parameter names, defaults and named-IOR lookups (material.cpp:26-147).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

from benchmark.reference.scene.ior import load_conductor_ior, load_dielectric_ior
from benchmark.reference.scene.textures import Texture, rgb_texture
from benchmark.reference.utils.log import get_logger

log = get_logger(__name__)


class MatType(enum.IntEnum):
    """Dense material type ids (order matches decl/material_decl.inl)."""

    UNKNOWN = 0
    DIFFUSE = 1
    DIELECTRIC = 2
    ROUGH_DIELECTRIC = 3
    CONDUCTOR = 4
    ROUGH_CONDUCTOR = 5
    PLASTIC = 6
    ROUGH_PLASTIC = 7


@dataclass
class Material:
    type: MatType = MatType.UNKNOWN
    twosided: bool = False

    # diffuse
    reflectance: Texture = field(default_factory=lambda: rgb_texture(0.5))
    # dielectric / plastic family
    int_ior: float = 1.5046
    ext_ior: float = 1.000277
    specular_reflectance: Texture = field(default_factory=lambda: rgb_texture(1.0))
    specular_transmittance: Texture = field(default_factory=lambda: rgb_texture(1.0))
    # conductor family
    eta: Texture = field(default_factory=lambda: rgb_texture(0.0))
    k: Texture = field(default_factory=lambda: rgb_texture(1.0))
    # rough variants; anisotropic=True means alpha holds (alpha_u,
    # alpha_v, 0) in its rgb — the reference ships the float2-alpha GGX
    # math (ggx.h:66-103) but never loads it from XML; here alpha_u /
    # alpha_v properties are parsed (beyond parity)
    alpha: Texture = field(default_factory=lambda: rgb_texture(0.1))
    anisotropic: bool = False
    # plastic family
    diffuse_reflectance: Texture = field(default_factory=lambda: rgb_texture(0.5))
    nonlinear: bool = False
    # spectral dispersion (dielectric family; render/spectral.py):
    # Cauchy B in um^2. Parsed from ``dispersion`` or an ``abbe``
    # number; 0 = non-dispersive (RGB renders ignore it entirely).
    dispersion: float = 0.0


def _texture_or_rgb(obj, scene, name: str, default) -> Texture:
    """LoadTextureOrRGB (util_loader.cpp): nested <texture name=...> wins,
    else an rgb/float property, else the default color."""
    for sub in obj.sub_objects:
        if sub.tag == "texture" and sub.var_name == name:
            return scene.load_texture(sub)
    value = obj.properties.get(name)
    if value is None:
        d = np.broadcast_to(np.asarray(default, np.float32), (3,))
        return rgb_texture(*map(float, d))
    parts = [p.strip() for p in value.split(",")]
    if len(parts) == 1:
        return rgb_texture(float(parts[0]))
    return rgb_texture(*map(float, parts[:3]))


# Fraunhofer F / C lines (nm): the Abbe number's definition. Copies of
# LAM_F / LAM_C and abbe_to_cauchy of the JAX package's render/spectral.py,
# the only host-side pieces of that module the scene loader needs.
LAM_F, LAM_C = 486.13, 656.28


def abbe_to_cauchy(n_d: float, v_d: float) -> float:
    """Abbe number -> Cauchy B (um^2): B = (n_d - 1) / (V_d (1/l_F^2 -
    1/l_C^2)), Fraunhofer lines in um."""
    lf, lc = LAM_F * 1e-3, LAM_C * 1e-3
    return (n_d - 1.0) / (max(v_d, 1e-6) * (1.0 / lf**2 - 1.0 / lc**2))


def _load_alpha(mat: Material, obj, scene) -> None:
    """Roughness: scalar/textured ``alpha``, or ``alpha_u``/``alpha_v``
    floats for anisotropic GGX (packed as the alpha texture's r/g)."""
    au = obj.properties.get("alpha_u")
    av = obj.properties.get("alpha_v")
    if au is not None or av is not None:
        u = float(au) if au is not None else 0.1
        v = float(av) if av is not None else u
        mat.alpha = rgb_texture(u, v, 0.0)
        mat.anisotropic = True
    else:
        mat.alpha = _texture_or_rgb(obj, scene, "alpha", 0.1)


def load_material_from_xml(obj, scene) -> Material:
    """Dispatch on the bsdf `type` attribute (material.cpp loaders)."""
    mtype = obj.type
    if mtype == "twosided":
        inner = None
        for sub in obj.sub_objects:
            if sub.tag == "bsdf":
                inner = sub
                break
        if inner is None:
            log.warning("twosided bsdf without inner bsdf")
            return Material()
        mat = load_material_from_xml(inner, scene)
        mat.twosided = True
        return mat

    mat = Material()
    if mtype == "diffuse":
        mat.type = MatType.DIFFUSE
        mat.reflectance = _texture_or_rgb(obj, scene, "reflectance", 0.5)
    elif mtype in ("dielectric", "roughdielectric"):
        mat.type = MatType.DIELECTRIC if mtype == "dielectric" else MatType.ROUGH_DIELECTRIC
        mat.int_ior = load_dielectric_ior(obj.properties.get("int_ior"), 1.5046)
        mat.ext_ior = load_dielectric_ior(obj.properties.get("ext_ior"), 1.000277)
        mat.specular_reflectance = _texture_or_rgb(obj, scene, "specular_reflectance", 1.0)
        mat.specular_transmittance = _texture_or_rgb(obj, scene, "specular_transmittance", 1.0)
        disp = obj.properties.get("dispersion")
        abbe = obj.properties.get("abbe")
        if disp is not None:
            mat.dispersion = float(disp)
        elif abbe is not None:
            mat.dispersion = abbe_to_cauchy(mat.int_ior, float(abbe))
        if mtype == "roughdielectric":
            _load_alpha(mat, obj, scene)
    elif mtype in ("conductor", "roughconductor"):
        mat.type = MatType.CONDUCTOR if mtype == "conductor" else MatType.ROUGH_CONDUCTOR
        named = load_conductor_ior(obj.properties.get("material"))
        eta_d, k_d = named if named else (np.zeros(3, np.float32), np.ones(3, np.float32))
        mat.eta = _texture_or_rgb(obj, scene, "eta", eta_d)
        mat.k = _texture_or_rgb(obj, scene, "k", k_d)
        mat.specular_reflectance = _texture_or_rgb(obj, scene, "specular_reflectance", 1.0)
        if mtype == "roughconductor":
            _load_alpha(mat, obj, scene)
    elif mtype in ("plastic", "roughplastic"):
        mat.type = MatType.PLASTIC if mtype == "plastic" else MatType.ROUGH_PLASTIC
        mat.int_ior = load_dielectric_ior(obj.properties.get("int_ior"), 1.49)
        mat.ext_ior = load_dielectric_ior(obj.properties.get("ext_ior"), 1.000277)
        mat.nonlinear = obj.properties.get("nonlinear") == "true"
        mat.diffuse_reflectance = _texture_or_rgb(obj, scene, "diffuse_reflectance", 0.5)
        mat.specular_reflectance = _texture_or_rgb(obj, scene, "specular_reflectance", 1.0)
        if mtype == "roughplastic":
            _load_alpha(mat, obj, scene)
    else:
        log.warning("unknown bsdf [%s]", mtype)
    return mat
