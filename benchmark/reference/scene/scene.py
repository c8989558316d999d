"""Scene assembly from parsed XML.

Parity: resource::Scene (resource/scene.{h,cpp}) — integrator, perspective
sensor with hdrfilm, shape instances, global emitters — including:

* fov_axis x->y conversion (scene.cpp:110-127),
* the mitsuba->pupil handedness fix on sensor transforms, applied on top
  of the look-at fix so the two cancel for look-at sensors
  (scene.cpp:132-139 + util_loader.cpp:159-166),
* transform loading: 16/9-element <matrix>, <lookat>, or
  scale -> rotate -> translate composition (util_loader.cpp:125-193),
* sphere center/radius folded into the instance transform
  (shape.cpp:106-124, to_world composed on top, shape.cpp:196-198).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from benchmark.reference.scene.emitters import Emitter, EmitterType, load_emitter_from_xml
from benchmark.reference.scene.materials import load_material_from_xml
from benchmark.reference.scene.shapes import ShapeInstance, ShapeManager, ShapeType
from benchmark.reference.scene.textures import (
    AddressMode,
    FilterMode,
    TextureManager,
    TextureType,
    checkerboard_texture,
    rgb_texture,
)
from benchmark.reference.scene.xml_parser import XmlObject, parse_scene_xml
from benchmark.reference.utils.log import get_logger
from benchmark.reference.utils.math import AABB, Transform, mitsuba_handedness_fix

log = get_logger(__name__)


@dataclass
class Film:
    w: int = 768
    h: int = 576


@dataclass
class Sensor:
    fov: float = 90.0  # fov_y after axis conversion
    near_clip: float = 0.01
    far_clip: float = 10000.0
    film: Film = field(default_factory=Film)
    transform: Transform = field(default_factory=Transform)
    sample_count: int = 1


@dataclass
class Integrator:
    max_depth: int = 1
    # hero-wavelength spectral transport (render/spectral.py; beyond
    # the RGB-only reference): <integrator type="spectral_path"> or a
    # boolean ``spectral`` property on a path integrator
    spectral: bool = False


class Scene:
    def __init__(self, root_path: str | Path = "."):
        self.root_path = Path(root_path)
        self.integrator = Integrator()
        self.sensor = Sensor()
        self.shape_instances: list[ShapeInstance] = []
        self.emitters: list[Emitter] = []
        self.texture_manager = TextureManager()
        self.shape_manager = ShapeManager()

    # -- aggregate queries --------------------------------------------------
    @property
    def aabb(self) -> AABB:
        box = AABB()
        for ins in self.shape_instances:
            if ins.shape is not None and ins.shape.aabb.valid:
                box.merge(ins.shape.aabb.transform(ins.transform.matrix))
        return box

    # -- loaders ------------------------------------------------------------
    def load_transform(self, obj: XmlObject | None) -> Transform:
        t = Transform()
        if obj is None:
            return t
        matrix = obj.properties.get("matrix")
        if matrix:
            elems = [float(v) for v in matrix.replace(",", " ").split()]
            if len(elems) == 16:
                t.matrix = np.asarray(elems, np.float32).reshape(4, 4)
            elif len(elems) == 9:
                m = np.eye(4, dtype=np.float32)
                m[:3, :3] = np.asarray(elems, np.float32).reshape(3, 3)
                t.matrix = m
            else:
                log.warning("transform matrix size is %d (must be 9 or 16)", len(elems))
            return t
        look_at = obj.get_unique_sub_object("lookat")
        if look_at is not None:
            origin = _f3(look_at.properties.get("origin"), (1, 0, 0))
            target = _f3(look_at.properties.get("target"), (0, 0, 0))
            up = _f3(look_at.properties.get("up"), (0, 1, 0))
            t.look_at(origin, target, up)
            # Handedness fix applied to every look-at (util_loader.cpp:159-166).
            t.matrix = mitsuba_handedness_fix(t.matrix)
            return t
        scale = obj.properties.get("scale")
        if scale:
            s = _f3(scale, (1, 1, 1), allow_scalar=True)
            t.scale(*s)
        rotate = obj.get_unique_sub_object("rotate")
        if rotate is not None and rotate.properties.get("axis"):
            axis = _f3(rotate.properties["axis"], (0, 1, 0))
            angle = float(rotate.properties.get("angle", 0.0))
            t.rotate(axis[0], axis[1], axis[2], angle)
        translate = obj.properties.get("translate")
        if translate:
            v = _f3(translate, (0, 0, 0))
            t.translate(*v)
        return t

    def load_texture(self, obj: XmlObject):
        """<texture type=bitmap|checkerboard> (scene.cpp:141-180)."""
        if obj.type == "bitmap":
            path = self.root_path / obj.properties.get("filename", "")
            tex = self.texture_manager.get_texture(path)
            tex.filter_mode = (
                FilterMode.LINEAR
                if obj.properties.get("filter_type") == "bilinear"
                else FilterMode.POINT
            )
            wrap = obj.properties.get("wrap_mode", "repeat")
            tex.address_mode = {
                "repeat": AddressMode.WRAP,
                "mirror": AddressMode.MIRROR,
                "clamp": AddressMode.CLAMP,
            }.get(wrap, AddressMode.WRAP)
        elif obj.type == "checkerboard":
            c0 = _f3(obj.properties.get("color0"), (0.4, 0.4, 0.4), allow_scalar=True)
            c1 = _f3(obj.properties.get("color1"), (0.2, 0.2, 0.2), allow_scalar=True)
            tex = checkerboard_texture(c0, c1)
        else:
            log.warning("unknown texture type [%s]", obj.type)
            tex = rgb_texture(0.0)
        transform_obj = obj.get_unique_sub_object("transform")
        if transform_obj is not None:
            # to_uv supports scale only (util_loader.cpp:199-205).
            scale = transform_obj.properties.get("scale")
            if scale:
                s = _f3(scale, (1, 1, 1), allow_scalar=True)
                tex.transform.scale(*s)
        return tex

    def _load_sensor(self, obj: XmlObject) -> None:
        if obj.type != "perspective":
            log.warning("sensor only support perspective type")
            return
        sensor = Sensor()
        sensor.fov = float(obj.properties.get("fov", 90.0))
        sensor.near_clip = float(obj.properties.get("near_clip", 0.01))
        sensor.far_clip = float(obj.properties.get("far_clip", 10000.0))

        film_obj = obj.get_unique_sub_object("film")
        if film_obj is not None:
            if film_obj.type != "hdrfilm":
                log.warning("film only support hdrfilm type")
            sensor.film = Film(
                w=int(film_obj.properties.get("width", 768)),
                h=int(film_obj.properties.get("height", 576)),
            )
        sampler_obj = obj.get_unique_sub_object("sampler")
        if sampler_obj is not None:
            sensor.sample_count = int(sampler_obj.properties.get("sample_count", 1))

        # fov_axis: default 'x' -> convert to fov_y (scene.cpp:110-127).
        fov_axis = obj.properties.get("fov_axis", "x").lower()
        if fov_axis not in ("x", "y"):
            log.warning("sensor fov_axis must be x or y")
            fov_axis = "x"
        if fov_axis == "x":
            aspect = sensor.film.h / sensor.film.w
            t = math.tan(math.radians(sensor.fov) * 0.5) * aspect
            sensor.fov = 2.0 * math.degrees(math.atan(t))

        transform_obj = obj.get_unique_sub_object("transform")
        sensor.transform = self.load_transform(transform_obj)
        # Sensor handedness fix (scene.cpp:132-139); cancels the look-at fix.
        sensor.transform.matrix = mitsuba_handedness_fix(sensor.transform.matrix)
        self.sensor = sensor

    def _load_shape(self, obj: XmlObject) -> None:
        ins = ShapeInstance(name=obj.id)
        stype = obj.type
        if stype == "obj" and obj.properties.get("split_groups") == "true":
            # beyond the reference (single-mesh assimp import,
            # resource/shape.cpp:219-278): split usemtl/g groups into
            # one instance each, materials resolved from the MTL
            self._load_obj_groups(obj)
            return
        if stype == "rectangle":
            ins.shape = self.shape_manager.load_rectangle()
        elif stype == "cube":
            ins.shape = self.shape_manager.load_cube()
        elif stype == "sphere":
            ins.shape = self.shape_manager.load_sphere()
        elif stype in ("obj", "ply", "gltf"):
            path = self.root_path / obj.properties.get("filename", "")
            ins.shape = self.shape_manager.load_mesh(path)
            # mitsuba defaults: OBJ flips V, PLY/glTF do not
            default_flip = "true" if stype == "obj" else "false"
            ins.flip_tex_coords = (
                obj.properties.get("flip_tex_coords", default_flip) != "false"
            )
        elif stype in ("linearcurve", "bsplinecurve", "catmullromcurve"):
            # round curves (the reference exposes optix builtin curve
            # intersection modules, optix/module.h:20-29, but never
            # loads curve geometry — parsed here, beyond parity).
            # Control points from a "points" property ("x,y,z,r; ...")
            # or a text file ("filename": one x y z r row per vertex).
            import numpy as _np

            pts_prop = obj.properties.get("points")
            if pts_prop:
                rows = [
                    [float(v) for v in grp.split(",")]
                    for grp in pts_prop.split(";")
                    if grp.strip()
                ]
                pts = _np.asarray(rows, _np.float32)
            else:
                path = self.root_path / obj.properties.get("filename", "")
                pts = _np.loadtxt(path, dtype=_np.float32).reshape(-1, 4)
            from benchmark.reference.scene.curves import basis_for, min_points
            from benchmark.reference.scene.shapes import Shape

            deg_attr = obj.properties.get("degree")
            basis = basis_for(stype, int(deg_attr) if deg_attr else None)
            s = Shape(ShapeType.CURVE, key=f"curve-{obj.id or id(obj)}")
            s.curve_points = pts
            s.curve_basis = basis
            s.curve_degree = {"linear": 1, "bspline2": 2, "bspline3": 3,
                              "catmullrom": 3}[basis]
            if pts.shape[0] < min_points(basis):
                log.warning(
                    "curve %s: %d control points < %d required for %s; "
                    "treating as linear", obj.id, pts.shape[0],
                    min_points(basis), basis,
                )
                s.curve_basis, s.curve_degree = "linear", 1
            s.aabb.merge_points(pts[:, :3] + pts[:, 3:4])
            s.aabb.merge_points(pts[:, :3] - pts[:, 3:4])
            ins.shape = s
        else:
            log.warning("unknown shape type [%s]", stype)
            return
        ins.flip_normals = obj.properties.get("flip_normals") == "true"

        bsdf_obj = obj.get_unique_sub_object("bsdf")
        if bsdf_obj is not None:
            ins.material = load_material_from_xml(bsdf_obj, self)

        to_world = self.load_transform(obj.get_unique_sub_object("transform"))
        if stype == "sphere":
            # center/radius folded under the instance to_world
            # (shape.cpp:106-124, 196-198).
            center = _f3(obj.properties.get("center"), (0, 0, 0))
            radius = float(obj.properties.get("radius", 1.0))
            fold = Transform().scale(radius, radius, radius).translate(*center)
            ins.transform = Transform(to_world.matrix @ fold.matrix)
        else:
            ins.transform = to_world

        emitter_obj = obj.get_unique_sub_object("emitter")
        if emitter_obj is not None:
            ins.emitter = load_emitter_from_xml(emitter_obj, self)
            if ins.emitter.type != EmitterType.AREA:
                log.warning("shape emitter not support type [%s]", emitter_obj.type)
            else:
                ins.is_emitter = True
        self.shape_instances.append(ins)

    def _material_from_mtl(self, desc: dict, obj_dir) -> "Material":
        """MTL -> framework material mapping (documented, lossy):
        map_Kd/Kd -> diffuse reflectance; a non-black Ks adds a coated
        lobe as ROUGH_PLASTIC with GGX alpha ~ sqrt(2/(Ns+2)) (the
        classic Phong-exponent conversion); d/Ke are ignored."""
        from benchmark.reference.scene.materials import Material, MatType
        from benchmark.reference.scene.textures import rgb_texture

        kd = desc.get("Kd", (0.6, 0.6, 0.6))
        if "map_Kd" in desc:
            reflectance = self.texture_manager.get_texture(
                obj_dir / desc["map_Kd"]
            )
        else:
            reflectance = rgb_texture(*kd)
        ks = desc.get("Ks", (0.0, 0.0, 0.0))
        if max(ks) > 1e-3:
            ns = float(desc.get("Ns", 30.0))
            alpha = min(max((2.0 / (ns + 2.0)) ** 0.5, 0.01), 0.5)
            return Material(
                type=MatType.ROUGH_PLASTIC,
                diffuse_reflectance=reflectance,
                specular_reflectance=rgb_texture(*ks),
                alpha=rgb_texture(alpha),
            )
        return Material(type=MatType.DIFFUSE, reflectance=reflectance)

    def _load_obj_groups(self, obj: XmlObject) -> None:
        from benchmark.reference.scene.shapes import parse_mtl

        path = self.root_path / obj.properties.get("filename", "")
        groups, mtllib = self.shape_manager.load_mesh_groups(path)
        mtl = parse_mtl(path.parent / mtllib) if mtllib else {}
        bsdf_obj = obj.get_unique_sub_object("bsdf")
        override = (
            load_material_from_xml(bsdf_obj, self) if bsdf_obj is not None else None
        )
        to_world = self.load_transform(obj.get_unique_sub_object("transform"))
        flip_normals = obj.properties.get("flip_normals") == "true"
        flip_tex = obj.properties.get("flip_tex_coords", "true") != "false"
        for gname, mname, shape in groups:
            ins = ShapeInstance(name=f"{obj.id or path.stem}/{gname}")
            ins.shape = shape
            ins.transform = to_world
            ins.flip_normals = flip_normals
            ins.flip_tex_coords = flip_tex
            if override is not None:
                ins.material = override
            elif mname in mtl:
                ins.material = self._material_from_mtl(mtl[mname], path.parent)
            self.shape_instances.append(ins)

    def load_from_xml(self, path: str | Path) -> "Scene":
        path = Path(path)
        self.root_path = path.parent
        root = parse_scene_xml(path)
        for obj in root.sub_objects:
            if obj.tag == "integrator":
                self.integrator = Integrator(
                    max_depth=int(obj.properties.get("max_depth", 1)),
                    spectral=(
                        "spectral" in (obj.type or "")
                        or obj.properties.get("spectral") == "true"
                    ),
                )
            elif obj.tag == "sensor":
                self._load_sensor(obj)
            elif obj.tag == "shape":
                self._load_shape(obj)
            elif obj.tag == "emitter":
                self.emitters.append(load_emitter_from_xml(obj, self))
            elif obj.tag == "bsdf":
                pass  # referenced via <ref>, loaded on use
            else:
                log.warning("unhandled top-level [%s]", obj.tag)
        return self


def _f3(value, default, allow_scalar: bool = True) -> np.ndarray:
    if not value:
        return np.asarray(default, np.float32)
    parts = [float(p) for p in str(value).replace(",", " ").split()]
    if len(parts) == 1 and allow_scalar:
        parts = parts * 3
    return np.asarray(parts[:3], np.float32)


def load_scene(path: str | Path) -> Scene:
    return Scene().load_from_xml(path)
