"""ReSTIRPass: spatio-temporal reservoir resampling, DI or GI.

Counterpart of pupiloptixlab_tpu/passes/restir.py. Fits the Pass protocol
as PTPass does: "restir frame" / "restir accum" buffers on the system's
device, dirty on camera and instance edits, inspector knobs for M, the
spatial taps and the radius. A camera or scene edit resets the DI
reservoir history (it invalidates the identity warp); with ``gi=True``
(render/restir_gi.py) a camera edit keeps the history, warped by the
camera's motion, and resets only the accumulation.

The frame functions blend into the pass's accumulation tensor in place
and return new reservoir tensors, which the pass keeps for the next frame.
"""

from __future__ import annotations

import dataclasses

import torch

from pupiloptixlab_tpu_torch.render.restir import N_PACK, restir_frame
from pupiloptixlab_tpu_torch.render.restir_gi import restir_gi_frame
from pupiloptixlab_tpu_torch.system.buffers import BufferFlag
from pupiloptixlab_tpu_torch.system.pass_base import Pass, PassTag
from pupiloptixlab_tpu_torch.utils.event import (
    CAMERA_CHANGE,
    RENDER_INSTANCE_UPDATE,
    SCENE_LOAD,
)


class ReSTIRPass(Pass):
    """``gi=True`` switches the estimator to ReSTIR GI (reservoir one-bounce
    indirect + one NEE sample of direct light) instead of DI."""

    def __init__(
        self,
        name: str = "ReSTIR DI",
        m_candidates: int = 8,
        spatial_taps: int = 3,
        spatial_radius: int = 16,
        gi: bool = False,
    ):
        super().__init__(name, PassTag.NONE)
        self.system = None
        self.gi = gi
        self._prev_camera = None
        self.m_candidates = m_candidates
        self.spatial_taps = spatial_taps
        self.spatial_radius = spatial_radius
        self.accumulate = True
        self.sample_cnt = 0
        self.seed = 0
        self._dirty = True
        self._scene_dirty = True
        self._scene_data = None
        self._config = None
        self._accum = None
        self._reservoirs = None

    def bind(self, system) -> None:
        self.system = system
        system.events.bind(SCENE_LOAD, lambda world: self._set_scene(world))
        system.events.bind(CAMERA_CHANGE, lambda _: self._mark_dirty())
        system.events.bind(RENDER_INSTANCE_UPDATE, lambda _: self._mark_dirty(scene=True))

    def _mark_dirty(self, scene: bool = False) -> None:
        self._dirty = True
        if scene:
            self._scene_dirty = True

    def _zeros(self, *shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.float32, device=self.system.buffers.device)

    def _refresh_scene(self, world) -> None:
        data, config = world.get_scene_data()
        self._scene_data = data
        self._config = dataclasses.replace(config, accumulate=self.accumulate)

    def _reset_state(self) -> None:
        n = self._config.width * self._config.height
        self._accum = self._zeros(n, 3)
        self._reservoirs = self._zeros(n, N_PACK)
        self.sample_cnt = 0

    def _set_scene(self, world) -> None:
        self._refresh_scene(world)
        self._reset_state()
        config = self._config
        bm = self.system.buffers
        n = config.width * config.height
        w, h = config.width, config.height
        bm.add("restir frame", self._zeros(n, 3), BufferFlag.ALLOW_DISPLAY, w, h)
        bm.add("restir accum", self._zeros(n, 3), BufferFlag.ALLOW_DISPLAY, w, h)
        self._dirty = True
        self._scene_dirty = True

    def on_run(self) -> None:
        if self._scene_data is None:
            return
        if self._dirty:
            self._refresh_scene(self.system.world)
            if self.gi and self._accum is not None and not self._scene_dirty:
                # GI keeps reservoir history across camera edits through
                # the motion warp; only the progressive accumulation resets
                n = self._config.width * self._config.height
                self._accum = self._zeros(n, 3)
                self.sample_cnt = 0
            else:
                # a camera or scene edit invalidates the identity warp (DI)
                self._reset_state()
            self._dirty = False
            self._scene_dirty = False

        camera = self.system.world.get_camera_block()
        if self.gi:
            self._accum, self._reservoirs, frame = restir_gi_frame(
                self._scene_data, camera, self.seed, self._reservoirs, self._accum,
                self.sample_cnt, self._config, spatial_taps=self.spatial_taps,
                spatial_radius=self.spatial_radius, prev_camera=self._prev_camera,
            )
            self._prev_camera = camera
        else:
            self._accum, self._reservoirs, frame = restir_frame(
                self._scene_data, camera, self.seed, self._reservoirs, self._accum,
                self.sample_cnt, self._config, m_candidates=self.m_candidates,
                spatial_taps=self.spatial_taps, spatial_radius=self.spatial_radius,
            )
        bm = self.system.buffers
        bm.set_array("restir frame", frame)
        bm.set_array("restir accum", self._accum)
        if "final result" in bm:
            bm.set_array("final result", self._accum)
        self.sample_cnt += 1
        self.seed += 1

    def inspector(self) -> dict:
        info = super().inspector()
        info.update(
            m_candidates=self.m_candidates,
            spatial_taps=self.spatial_taps,
            spatial_radius=self.spatial_radius,
            sample_cnt=self.sample_cnt,
        )
        return info

    def set_candidates(self, m: int) -> None:
        self.m_candidates = max(1, min(int(m), 64))
        self._mark_dirty()

    def set_spatial(self, taps: int, radius: int | None = None) -> None:
        self.spatial_taps = max(0, min(int(taps), 8))
        if radius is not None:
            self.spatial_radius = max(1, min(int(radius), 64))
        self._mark_dirty()
