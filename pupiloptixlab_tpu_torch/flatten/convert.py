"""Carry scene state across packages: nested dicts of numpy arrays -> the
port's dataclasses.

``scene_from_arrays`` takes the leaves of the JAX package's ``SceneData``
as ``{"tris": {"packed": ..., ...}, "spheres": {...}, ...}`` (keyed by the
reference's field names, values numpy arrays) and returns the port's
``SceneData`` on ``device`` (``None``: the card); ``camera_from_arrays`` does the same for a
``CameraBlock`` and ``config_from_fields`` for a ``RenderConfig``. Given
identical tables, a render in each package isolates render faults from
flatten faults. Nothing here imports jax: the caller flattens the tree.
"""

from __future__ import annotations

from dataclasses import fields

import numpy as np

from pupiloptixlab_tpu_torch.accel.bvh import bvh_depth
from pupiloptixlab_tpu_torch.accel.bvh_traverse import subleaf_table, sweep_table
from pupiloptixlab_tpu_torch.device import resolve_device
from pupiloptixlab_tpu_torch.flatten.flatten import _t
from pupiloptixlab_tpu_torch.flatten.types import (
    CameraBlock,
    Curves,
    EmitterTable,
    MaterialTable,
    RenderConfig,
    SceneData,
    Spheres,
    TextureTable,
    TriSoup,
)

_GROUPS = {
    "tris": TriSoup,
    "spheres": Spheres,
    "curves": Curves,
    "materials": MaterialTable,
    "textures": TextureTable,
    "emitters": EmitterTable,
}


# TriSoup fields made here, not carried (the sub-leaf table is the port's own)
_DERIVED = ("bvh_depth", "sweep_boxes", "subleaf_boxes", "subleaf_rows")


def _table(cls, leaves: dict, device):
    device = resolve_device(device)
    names = [f.name for f in fields(cls) if f.name not in _DERIVED]
    missing = set(names) - set(leaves)
    if missing:
        raise KeyError(f"{cls.__name__}: missing fields {sorted(missing)}")
    return {k: _t(np.asarray(leaves[k]), device=device) for k in names}


def scene_from_arrays(tree: dict, config: RenderConfig, device=None) -> SceneData:
    parts = {g: _table(cls, tree[g], device) for g, cls in _GROUPS.items()}
    depth = bvh_depth(np.asarray(tree["tris"]["bvh_child"])) if config.bvh_nodes > 0 else 0
    packed = parts["tris"]["packed"]
    rows, boxes = subleaf_table(packed, config.bvh_tcl, config.bvh_nodes, config.instanced)
    parts["tris"] = TriSoup(**parts["tris"], bvh_depth=depth,
                            sweep_boxes=sweep_table(packed, config.bvh_nodes),
                            subleaf_boxes=boxes, subleaf_rows=rows)
    for g, cls in _GROUPS.items():
        if g != "tris":
            parts[g] = cls(**parts[g])
    return SceneData(**parts)


def camera_from_arrays(tree: dict, device=None) -> CameraBlock:
    return CameraBlock(**_table(CameraBlock, tree, device))


def config_from_fields(values: dict) -> RenderConfig:
    """A RenderConfig from the reference config's field values."""
    names = {f.name for f in fields(RenderConfig)}
    return RenderConfig(**{k: v for k, v in values.items() if k in names})
