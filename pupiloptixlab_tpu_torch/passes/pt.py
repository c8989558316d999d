"""PTPass: the flagship progressive path-tracing pass.

Counterpart of pupiloptixlab_tpu/passes/pt.py (example/path_tracer/
pt_pass.{h,cpp} parity): allocates the frame/accum buffers and the
albedo/normal/test AOVs (displayable) on the system's device, rebuilds its
launch state on SCENE_LOAD, goes dirty on CAMERA_CHANGE /
RENDER_INSTANCE_UPDATE (resetting progressive accumulation), and exposes
max-depth + accumulate toggles through the inspector.

``spectral=`` forces (or forbids) hero-wavelength transport over the
scene's own integrator. ``PUPIL_SANITIZE`` (non-empty) sets
``debug_checks``: every frame then carries the sanitizer's report, and the
pass reads it once a frame and raises ``SanitizerError`` naming the bad
stages (the reference's CUDA_SYNC_CHECK-after-pass mode).
"""

from __future__ import annotations

import dataclasses
import os

import torch

from pupiloptixlab_tpu_torch.render.integrator import render_frame
from pupiloptixlab_tpu_torch.system.buffers import BufferFlag
from pupiloptixlab_tpu_torch.system.pass_base import Pass, PassTag
from pupiloptixlab_tpu_torch.utils.event import (
    CAMERA_CHANGE,
    RENDER_INSTANCE_UPDATE,
    SCENE_LOAD,
)
from pupiloptixlab_tpu_torch.utils.debug import assert_all_finite


class PTPass(Pass):
    def __init__(self, name: str = "Path Tracing", max_depth: int | None = None,
                 spectral: bool | None = None):
        super().__init__(name, PassTag.NONE)
        self.system = None
        self.max_depth_override = max_depth
        # None = follow the scene's integrator (<integrator
        # type="spectral_path">); True/False force it
        self.spectral_override = spectral
        self.accumulate = True
        # PUPIL_SANITIZE: the value sanitizer in every frame, gated after
        # each on_run (optix/pipeline.cpp:19, system/system.cpp:51)
        self._sanitize = bool(os.environ.get("PUPIL_SANITIZE"))
        self.sample_cnt = 0
        self.seed = 0
        self._dirty = True
        self._scene_data = None
        self._config = None
        self._accum = None

    # -- wiring -----------------------------------------------------------------
    def bind(self, system) -> None:
        self.system = system
        system.events.bind(SCENE_LOAD, lambda world: self._set_scene(world))
        system.events.bind(CAMERA_CHANGE, lambda _: self._mark_dirty())
        system.events.bind(RENDER_INSTANCE_UPDATE, lambda _: self._mark_dirty())

    def _mark_dirty(self) -> None:
        self._dirty = True

    def _refresh_scene(self, world) -> None:
        """Launch state from the world, with the pass's overrides."""
        data, config = world.get_scene_data()
        if self.max_depth_override is not None:
            config = dataclasses.replace(config, max_depth=self.max_depth_override)
        if self.spectral_override is not None:
            config = dataclasses.replace(config, spectral=self.spectral_override)
        config = dataclasses.replace(
            config, accumulate=self.accumulate, debug_checks=self._sanitize
        )
        self._scene_data, self._config = data, config

    def _set_scene(self, world) -> None:
        self._refresh_scene(world)
        config = self._config
        n = config.width * config.height
        dev = self.system.buffers.device

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=dev)

        self._accum = zeros(n, 3)
        self.sample_cnt = 0
        bm = self.system.buffers
        w, h = config.width, config.height
        for name in ("pt frame", "pt accum"):
            bm.add(name, zeros(n, 4), BufferFlag.ALLOW_DISPLAY, w, h)
        bm.add("pt albedo", zeros(n, 3), BufferFlag.ALLOW_DISPLAY, w, h)
        bm.add("pt normal", zeros(n, 3), BufferFlag.ALLOW_DISPLAY, w, h)
        bm.add("pt test", zeros(n), BufferFlag.ALLOW_DISPLAY, w, h)
        self._dirty = True

    # -- frame -----------------------------------------------------------------
    def on_run(self) -> None:
        if self._scene_data is None:
            return
        if self._dirty:
            # refresh launch state; restart progressive accumulation
            # (pt_pass.cpp:40-49)
            self._refresh_scene(self.system.world)
            self.sample_cnt = 0
            self._dirty = False

        camera = self.system.world.get_camera_block()
        # render_frame blends into self._accum in place; "pt frame" and
        # "pt accum" are that tensor
        self._accum, bufs = render_frame(
            self._scene_data,
            camera,
            self.seed,
            self.sample_cnt,
            self._accum,
            self._config,
        )
        bm = self.system.buffers
        bm.set_array("pt frame", bufs["frame"])
        bm.set_array("pt accum", self._accum)
        bm.set_array("pt albedo", bufs["albedo"])
        bm.set_array("pt normal", bufs["normal"])
        bm.set_array("pt test", bufs["test"])
        if "final result" in bm:
            bm.set_array("final result", bufs["frame"])
        if self._config.debug_checks:
            assert_all_finite(bufs["sanitizer"], context=self.name)
        self.sample_cnt += 1
        self.seed += 1

    def inspector(self) -> dict:
        info = super().inspector()
        info.update(
            max_depth=self._config.max_depth if self._config else None,
            accumulate=self.accumulate,
            sample_cnt=self.sample_cnt,
        )
        return info

    def set_max_depth(self, depth: int) -> None:
        """Inspector control: clamp 1..128 (pt_pass.cpp:228-232)."""
        self.max_depth_override = max(1, min(int(depth), 128))
        self._mark_dirty()

    def set_accumulate(self, on: bool) -> None:
        self.accumulate = bool(on)
        self._mark_dirty()
