"""Runtime world: scene ownership, interactive camera, instance edits.

Counterpart of pupiloptixlab_tpu/world/world.py (world::World +
CameraHelper + RenderObject + the GAS/IAS managers and EmitterHelper's
dirty tracking of the original).

There are no BLAS/TLAS handles to build or refit: the "acceleration
structure" is the flattened SoA (SceneData) on the world's device. A new
scene is flattened in full with its refit records; a transform or
visibility edit afterwards refits the tables (flatten/refit.py, the
IAS::Update analog) with identical shapes and no host re-flatten. Dirty
propagation mirrors the reference's event chains:

  camera drag/wheel/keys -> CameraHelper dirty -> CAMERA_CHANGE
  instance transform edit -> device refit
                           -> RENDER_INSTANCE_UPDATE (passes reset accum)
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from pupiloptixlab_tpu_torch.device import resolve_device
from pupiloptixlab_tpu_torch.flatten import (
    camera_block,
    flatten_scene,
)
from pupiloptixlab_tpu_torch.flatten.refit import refit_scene
from pupiloptixlab_tpu_torch.flatten.types import CameraBlock, RenderConfig, SceneData
from pupiloptixlab_tpu_torch.scene import Scene, load_scene
from pupiloptixlab_tpu_torch.utils.camera import Camera, CameraDesc
from pupiloptixlab_tpu_torch.utils.event import (
    CAMERA_CHANGE,
    MOUSE_DRAGGING,
    MOUSE_WHEEL,
    CAMERA_MOVE,
    RENDER_INSTANCE_TRANSFORM,
    RENDER_INSTANCE_UPDATE,
    SCENE_LOAD,
    EventBus,
)
from pupiloptixlab_tpu_torch.utils.log import get_logger
from pupiloptixlab_tpu_torch.utils.math import AABB, Transform
from pupiloptixlab_tpu_torch.utils.timer import Timer

log = get_logger(__name__)


class RenderObject:
    """Per-instance runtime handle (world/render_object.h analog)."""

    def __init__(self, world: "World", index: int):
        self._world = world
        self._index = index

    @property
    def instance(self):
        return self._world.scene.shape_instances[self._index]

    @property
    def name(self) -> str:
        return self.instance.name

    @property
    def transform(self) -> Transform:
        return self.instance.transform

    @property
    def visible(self) -> bool:
        return self.instance.visibility_mask != 0

    def set_visible(self, visible: bool) -> None:
        self.instance.visibility_mask = 255 if visible else 0
        self._world._on_instance_update(self._index)

    def update_transform(self, transform: Transform) -> None:
        """Replace the instance transform (ImGuizmo edit analog,
        render_object.cpp:41-49)."""
        self.instance.transform = transform
        self._world.events.dispatch(RENDER_INSTANCE_TRANSFORM, self)
        self._world._on_instance_update(self._index)

    def apply_transform(self, transform: Transform) -> None:
        """Compose on top of the current transform."""
        self.update_transform(
            Transform(transform.matrix @ self.instance.transform.matrix)
        )


class World:
    """Owns the scene, camera, flattened device data, and dirty state."""

    def __init__(self, events: EventBus | None = None, device=None):
        """``device``: where the flattened tables and the camera block
        live (``None``: the card; raises where there is none)."""
        self.events = events or EventBus()
        self.device = resolve_device(device)
        self.scene: Scene | None = None
        self.camera: Camera | None = None
        self._render_objects: list[RenderObject] = []
        self._scene_dirty = True
        self._camera_dirty = True
        self._data: SceneData | None = None
        self._config: RenderConfig | None = None
        self._camera_block: CameraBlock | None = None
        self._refit = None  # static instance/topology records of the refit
        self._instance_dirty = False  # transform/visibility edits only
        self._bind_canvas_events()

    # -- canvas interaction (world.cpp:15-43 semantics) ---------------------
    def _bind_canvas_events(self) -> None:
        def on_drag(payload):
            dx, dy = payload
            if self.camera is not None:
                scale = Camera.sensitivity * Camera.sensitivity_scale
                self.camera.rotate(dx * scale, dy * scale)
                self._camera_dirty = True
                self.events.dispatch(CAMERA_CHANGE)

        def on_wheel(delta):
            if self.camera is not None:
                self.camera.set_fov_delta(-0.5 * float(delta))
                self._camera_dirty = True
                self.events.dispatch(CAMERA_CHANGE)

        def on_move(delta):
            if self.camera is not None:
                scale = Camera.sensitivity * Camera.sensitivity_scale
                self.camera.move(np.asarray(delta, np.float32) * scale)
                self._camera_dirty = True
                self.events.dispatch(CAMERA_CHANGE)

        self.events.bind(MOUSE_DRAGGING, on_drag)
        self.events.bind(MOUSE_WHEEL, on_wheel)
        self.events.bind(CAMERA_MOVE, on_move)

    # -- scene lifecycle -----------------------------------------------------
    def load_scene(self, path: str | Path) -> bool:
        timer = Timer()
        timer.start()
        try:
            scene = load_scene(path)
        except Exception as exc:  # keep the old scene on failure
            log.warning("scene load failed: %s", exc)
            return False
        self.set_scene(scene)
        timer.stop()
        log.info("scene loaded in %.1f ms", timer.elapsed_ms)
        self.events.dispatch(SCENE_LOAD, self)
        return True

    def set_scene(self, scene: Scene) -> None:
        self.scene = scene
        self.camera = Camera(
            CameraDesc(
                fov_y=scene.sensor.fov,
                aspect_ratio=scene.sensor.film.w / scene.sensor.film.h,
                near_clip=scene.sensor.near_clip,
                far_clip=scene.sensor.far_clip,
                to_world=Transform(scene.sensor.transform.matrix),
            )
        )
        self._render_objects = [
            RenderObject(self, i) for i in range(len(scene.shape_instances))
        ]
        self._scene_dirty = True
        self._camera_dirty = True
        self._data = None   # new topology: full flatten, fresh refit records
        self._refit = None
        self.events.dispatch(CAMERA_CHANGE)

    # -- render objects -------------------------------------------------------
    @property
    def render_objects(self) -> list[RenderObject]:
        return list(self._render_objects)

    def get_render_object(self, name: str) -> RenderObject | None:
        for ro in self._render_objects:
            if ro.name == name:
                return ro
        return None

    def _on_instance_update(self, index: int) -> None:
        # instance-only edit: eligible for the device refit
        self._instance_dirty = True
        self.events.dispatch(RENDER_INSTANCE_UPDATE, self._render_objects[index])

    # -- device data ------------------------------------------------------------
    @property
    def aabb(self) -> AABB:
        return self.scene.aabb if self.scene else AABB()

    def get_scene_data(self) -> tuple[SceneData, RenderConfig]:
        """Flattened device tables; rebuilt lazily when dirty.

        A structural change (new scene, film or sensor edit) takes the full
        host flatten + BVH build with the refit records (GAS build
        analog). Transform and visibility edits afterwards take the refit
        (flatten/refit.py): O(instances) bytes uploaded, then world rows,
        BVH/chunk boxes and emitter CDFs regenerated on the device, or the
        instance matrices and world boxes of instanced tables, with
        identical shapes and no host re-flatten."""
        if self._scene_dirty or self._data is None:
            self._data, self._config, self._refit = flatten_scene(
                self.scene, return_refit=True, device=self.device
            )
            self._scene_dirty = False
            self._instance_dirty = False
        elif self._instance_dirty:
            self._data = refit_scene(self._data, self._refit, self.scene)
            self._instance_dirty = False
        return self._data, self._config

    def get_camera_block(self) -> CameraBlock:
        """Lazily re-uploaded on change (CameraHelper::GetCudaMemory
        analog, world/camera.cpp:72-92)."""
        if self._camera_dirty or self._camera_block is None:
            self._camera_block = camera_block(self.camera, device=self.device)
            self._camera_dirty = False
        return self._camera_block
