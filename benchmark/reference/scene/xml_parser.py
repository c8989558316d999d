"""Mitsuba3-style scene XML parser.

Parity: resource/xml/{parser.cpp,visitor.h,object.cpp} — DFS over the tag
set {scene, default, bsdf, emitter, film, integrator, sensor, shape,
texture, lookat, transform, integer, string, float, rgb, point, matrix,
scale, rotate, translate, boolean, ref}, with:

* ``<default name value>`` declarations substituted into ``$name``
  attribute references (object.cpp:9-24),
* ``<ref id>`` resolving to previously-declared id'd objects
  (visitor.h:113-121),
* special forms: lookat (origin/target/up), rotate (axis from value or
  presence of x/y/z attr + angle), scale/translate/point collapsing
  x/y/z attributes into an "x, y, z" value string (visitor.h:124-183).

Built on xml.etree.ElementTree instead of pugixml.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from pathlib import Path

from benchmark.reference.utils.log import get_logger

log = get_logger(__name__)

PROPERTY_TAGS = {"integer", "string", "float", "rgb", "boolean", "matrix"}
OBJECT_TAGS = {
    "scene", "bsdf", "emitter", "film", "integrator", "sensor", "shape",
    "texture", "transform", "sampler", "rfilter",
}
XYZ_TAGS = {"scale": "1", "translate": "0", "point": "0", "vector": "0"}
SUBOBJECT_TAGS = {"lookat", "rotate"}


@dataclass
class XmlObject:
    tag: str
    type: str = ""
    id: str = ""
    var_name: str = ""
    properties: dict[str, str] = field(default_factory=dict)
    sub_objects: list["XmlObject"] = field(default_factory=list)

    def get_unique_sub_object(self, tag: str) -> "XmlObject | None":
        for sub in self.sub_objects:
            if sub.tag == tag:
                return sub
        return None

    def get_sub_objects(self, tag: str) -> list["XmlObject"]:
        return [s for s in self.sub_objects if s.tag == tag]


class Parser:
    def __init__(self):
        self._defaults: dict[str, str] = {}
        self._by_id: dict[str, XmlObject] = {}

    def _subst(self, value: str) -> str:
        if "$" in value:
            for name, v in self._defaults.items():
                value = value.replace(f"${name}", v)
        return value

    def _attr(self, node: ET.Element, name: str, default: str = "") -> str:
        return self._subst(node.get(name, default))

    def load(self, path: str | Path) -> XmlObject:
        tree = ET.parse(str(path))
        root = tree.getroot()
        if root.tag != "scene":
            raise ValueError(f"{path}: root element must be <scene>")
        scene = XmlObject(tag="scene", type=root.get("version", ""))
        for child in root:
            self._visit(child, scene)
        return scene

    def _visit(self, node: ET.Element, parent: XmlObject) -> None:
        tag = node.tag
        if tag == "default":
            # <default name=... value=...> -> $name substitution table.
            self._defaults[node.get("name", "")] = node.get("value", "")
            return
        if tag == "ref":
            ref_id = self._attr(node, "id")
            target = self._by_id.get(ref_id)
            if target is not None:
                parent.sub_objects.append(target)
            else:
                log.warning("unresolved <ref id=%r>", ref_id)
            return
        if tag in PROPERTY_TAGS:
            # Nameless properties (e.g. <matrix value=...>) key by tag name.
            name = self._attr(node, "name") or tag
            parent.properties[name] = self._attr(node, "value")
            return
        if tag in XYZ_TAGS:
            default = XYZ_TAGS[tag]
            value = self._attr(node, "value")
            if not value:
                x = self._attr(node, "x", default)
                y = self._attr(node, "y", default)
                z = self._attr(node, "z", default)
                value = f"{x}, {y}, {z}"
            name = self._attr(node, "name") or tag
            parent.properties[name] = value
            return
        if tag == "lookat":
            obj = XmlObject(tag="lookat")
            for key in ("origin", "target", "up"):
                obj.properties[key] = self._attr(node, key)
            parent.sub_objects.append(obj)
            return
        if tag == "rotate":
            obj = XmlObject(tag="rotate")
            axis = self._attr(node, "value")
            if not axis:
                # Axis chosen by which attribute is present (visitor.h:146-156).
                if node.get("x") is not None:
                    axis = "1, 0, 0"
                elif node.get("y") is not None:
                    axis = "0, 1, 0"
                elif node.get("z") is not None:
                    axis = "0, 0, 1"
            obj.properties["axis"] = axis
            obj.properties["angle"] = self._attr(node, "angle")
            parent.sub_objects.append(obj)
            return
        if tag in OBJECT_TAGS:
            obj = XmlObject(
                tag=tag,
                type=self._attr(node, "type"),
                id=self._attr(node, "id"),
                var_name=self._attr(node, "name"),
            )
            if obj.id:
                self._by_id[obj.id] = obj
            parent.sub_objects.append(obj)
            for child in node:
                self._visit(child, obj)
            return
        log.warning("unknown xml tag [%s]", tag)


def parse_scene_xml(path: str | Path) -> XmlObject:
    return Parser().load(path)
