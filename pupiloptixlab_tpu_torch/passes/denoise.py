"""DenoisePass: the post-pass that applies the denoiser to the PT output.

Counterpart of pupiloptixlab_tpu/passes/denoise.py, the example-level
analog of wiring optix::Denoiser behind the path tracer
(denoised_scene.xml workflow): reads the PT pass's "pt frame", "pt albedo"
and "pt normal" buffers and publishes a displayable "pt denoised" buffer,
on the system's device (on the card: K9, denoise/atrous_kernel.py).
"""

from __future__ import annotations

from pupiloptixlab_tpu_torch.denoise import Denoiser, DenoiserMode
from pupiloptixlab_tpu_torch.system.buffers import BufferFlag
from pupiloptixlab_tpu_torch.system.pass_base import Pass, PassTag
from pupiloptixlab_tpu_torch.utils.event import SCENE_LOAD


class DenoisePass(Pass):
    def __init__(
        self,
        mode: DenoiserMode = DenoiserMode.USE_ALBEDO | DenoiserMode.USE_NORMAL,
        name: str = "Denoise",
    ):
        super().__init__(name, PassTag.NONE)
        self.denoiser = Denoiser(mode)
        self.system = None
        self._shape = None

    def bind(self, system) -> None:
        self.system = system
        system.events.bind(SCENE_LOAD, self._on_scene)

    def _on_scene(self, world) -> None:
        film = world.scene.sensor.film
        self.denoiser.setup(film.w, film.h)
        self._shape = (film.h, film.w)

    def on_run(self) -> None:
        bm = self.system.buffers
        if self._shape is None or "pt frame" not in bm:
            return
        h, w = self._shape
        color = bm["pt frame"].array[:, :3].reshape(h, w, 3)
        albedo = bm["pt albedo"].array.reshape(h, w, 3)
        normal = bm["pt normal"].array.reshape(h, w, 3)
        out = self.denoiser.execute(
            {"input": color, "albedo": albedo, "normal": normal}
        )
        flat = out.reshape(-1, 3)
        if "pt denoised" in bm:
            bm.set_array("pt denoised", flat)
        else:
            bm.add("pt denoised", flat, BufferFlag.ALLOW_DISPLAY, w, h)
