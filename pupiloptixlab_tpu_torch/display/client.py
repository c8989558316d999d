"""Host display client: framebuffer streaming, camera input, screenshots.

Counterpart of pupiloptixlab_tpu/display/client.py. The reference's async
DX12/ImGui GUI (system/gui/gui.cpp) becomes a host-side client: the render
loop dispatches FRAME_FINISHED, the client applies ACES/gamma and the uint8
quantisation on the buffer's device (display/tonemap.py), fetches the
display bytes once and flips a double-buffered host copy of the selected
displayable buffer (the FlipBuffer pattern, gui.h:92-104). It exposes the
same interaction surface:

* buffer selector over BufferManager.displayable_names()
  (gui.cpp:546-584),
* camera drag / wheel / WASDQE -> canvas events (gui.cpp:652-686),
* screenshot -> EXR (gui.cpp:467-486),
* FPS / frame-time readout (the console panel).

If an interactive matplotlib backend is available, ``run()`` opens a live
window; otherwise the client stays headless and frames are pulled via
``latest_image()`` / ``save_screenshot()``.

Edits from another thread (a window, the web client's HTTP threads) take
``System._render_mutex``, so they land between two frames.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path

import numpy as np

from pupiloptixlab_tpu_torch.display.tonemap import expand_to_rgba, to_display_u8
from pupiloptixlab_tpu_torch.system.buffers import DEFAULT_FINAL_RESULT_BUFFER_NAME
from pupiloptixlab_tpu_torch.utils.event import (
    CAMERA_MOVE,
    FRAME_FINISHED,
    MOUSE_DRAGGING,
    MOUSE_WHEEL,
)
from pupiloptixlab_tpu_torch.utils.image import save_image
from pupiloptixlab_tpu_torch.utils.log import get_logger

log = get_logger(__name__)

_KEY_TO_DELTA = {
    # WASDQE in the camera frame; forward = -z (world.cpp:30-43 semantics)
    "w": (0.0, 0.0, -1.0),
    "s": (0.0, 0.0, 1.0),
    "a": (-1.0, 0.0, 0.0),
    "d": (1.0, 0.0, 0.0),
    "q": (0.0, -1.0, 0.0),
    "e": (0.0, 1.0, 0.0),
}


class DisplayClient:
    def __init__(self, system):
        self.system = system
        self.tone_mapping = True
        self.gamma = True
        self.selected = "pt frame"
        self.fps = 0.0
        self.frame_time_ms = 0.0
        # flip-model double buffer: render thread writes back, reader flips
        self._images = [None, None]
        self._ready_index = 0
        self._flip_lock = threading.Lock()
        # motion preview: camera input switches the fetch to a quarter-
        # size frame (stride 2) for ``preview_hold_s`` after the last
        # input, keeping interaction fetch-rate bound at ~1/4 the bytes;
        # the browser <img> scales it up (web.py css max-width/height)
        self.preview = True
        self.preview_hold_s = 0.4
        self._preview_until = 0.0
        system.events.bind(FRAME_FINISHED, self._on_frame_finished)
        for ev in (MOUSE_DRAGGING, MOUSE_WHEEL, CAMERA_MOVE):
            system.events.bind(ev, self._touch_preview)

    def _touch_preview(self, _payload=None) -> None:
        self._preview_until = time.monotonic() + self.preview_hold_s

    @property
    def previewing(self) -> bool:
        return self.preview and time.monotonic() < self._preview_until

    # -- frame path --------------------------------------------------------
    def _select_buffer(self):
        bm = self.system.buffers
        names = bm.displayable_names()
        if self.selected in names:
            return bm[self.selected]
        if DEFAULT_FINAL_RESULT_BUFFER_NAME in bm:
            return bm[DEFAULT_FINAL_RESULT_BUFFER_NAME]
        return bm[names[0]] if names else None

    def _on_frame_finished(self, ms: float) -> None:
        self.frame_time_ms = float(ms)
        self.fps = 1000.0 / max(float(ms), 1e-6)
        buf = self._select_buffer()
        if buf is None or buf.array is None:
            return
        rgba = expand_to_rgba(buf.array, buf.desc.width, buf.desc.height)
        shown = to_display_u8(
            rgba[..., :3], self.tone_mapping, self.gamma,
            stride=2 if self.previewing else 1,
        )
        # film row 0 = bottom; flipped on the device, then one uint8 fetch
        # (a quarter of the float image's bytes) into contiguous rows
        img = shown.flip(0).cpu().numpy()
        with self._flip_lock:
            back = 1 - self._ready_index
            self._images[back] = img
            self._ready_index = back

    def latest_image(self) -> np.ndarray | None:
        with self._flip_lock:
            return self._images[self._ready_index]

    # -- buffer selection -----------------------------------------------------
    def buffer_names(self) -> list[str]:
        return self.system.buffers.displayable_names()

    def select_buffer(self, name: str) -> None:
        self.selected = name

    # -- input -> canvas events (gui.cpp:652-686) -------------------------------
    def mouse_drag(self, dx: float, dy: float) -> None:
        with self.system._render_mutex:
            self.system.events.dispatch(MOUSE_DRAGGING, (dx, dy))

    def mouse_wheel(self, delta: float) -> None:
        with self.system._render_mutex:
            self.system.events.dispatch(MOUSE_WHEEL, delta)

    def key(self, key: str) -> None:
        delta = _KEY_TO_DELTA.get(key.lower())
        if delta is not None:
            with self.system._render_mutex:
                self.system.events.dispatch(CAMERA_MOVE, delta)

    # -- screenshot (gui.cpp:467-486) ----------------------------------------------
    def save_screenshot(self, path: str | Path, raw: bool = True) -> None:
        """EXR keeps linear radiance (raw); PNG gets the display transfer."""
        with self.system._render_mutex:  # a whole frame, not one mid-blend
            buf = self._select_buffer()
            if buf is None or buf.array is None:
                log.warning("no displayable buffer for screenshot")
                return
            rgba = expand_to_rgba(
                buf.array, buf.desc.width, buf.desc.height).flip(0).cpu().numpy()
        if raw and str(path).lower().endswith((".exr", ".hdr")):
            save_image(path, rgba)
        else:
            img = self.latest_image()
            if img is None:
                img = np.clip(rgba[..., :3], 0, 1)
            save_image(path, img)

    # -- optional interactive window ----------------------------------------------
    def run(self, refresh_hz: float = 30.0) -> None:
        try:
            import matplotlib

            matplotlib.use("TkAgg")
            import matplotlib.pyplot as plt

            fig, ax = plt.subplots()
        except Exception as exc:  # no Tk, or no display to open a window on
            log.info("no interactive backend (%s); display client stays headless", exc)
            while not self.system._quit_flag.is_set():
                time.sleep(0.1)
            return

        im = None
        while not self.system._quit_flag.is_set() and plt.fignum_exists(fig.number):
            img = self.latest_image()
            if img is not None:
                if im is None:
                    im = ax.imshow(img)
                else:
                    im.set_data(img)
                ax.set_title(f"{self.selected}  {self.frame_time_ms:.1f} ms")
            plt.pause(1.0 / refresh_hz)
        self.system.quit()
