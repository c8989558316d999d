"""Event bus — the util/event.h analog as a plain observer registry.

The reference wires layers via a compile-time typed static event bus
(EventBinder/EventDispatcher). Here: string-keyed callbacks on an explicit
bus object, thread-safe binds, used for the same dirty-propagation chains
(camera change -> pass dirty -> accumulation reset, instance transform ->
emitter rebuild, frame finished -> display flip).
"""

from __future__ import annotations

import threading
from collections import defaultdict
from typing import Any, Callable

# Canonical event names (mirrors ESystemEvent / EWorldEvent / ECanvasEvent).
QUIT = "system/quit"
START_RENDERING = "system/start_rendering"
STOP_RENDERING = "system/stop_rendering"
PRECOMPUTE = "system/precompute"
SCENE_LOAD = "system/scene_load"
FRAME_FINISHED = "system/frame_finished"
CAMERA_CHANGE = "world/camera_change"
RENDER_INSTANCE_TRANSFORM = "world/render_instance_transform"
RENDER_INSTANCE_UPDATE = "world/render_instance_update"
MOUSE_DRAGGING = "canvas/mouse_dragging"
MOUSE_WHEEL = "canvas/mouse_wheel"
CAMERA_MOVE = "canvas/camera_move"


class EventBus:
    def __init__(self):
        self._handlers: dict[str, list[Callable[[Any], None]]] = defaultdict(list)
        self._lock = threading.Lock()

    def bind(self, event: str, handler: Callable[[Any], None]) -> None:
        with self._lock:
            self._handlers[event].append(handler)

    def dispatch(self, event: str, payload: Any = None) -> None:
        with self._lock:
            handlers = list(self._handlers.get(event, ()))
        for h in handlers:
            h(payload)

    def clear(self, event: str | None = None) -> None:
        with self._lock:
            if event is None:
                self._handlers.clear()
            else:
                self._handlers.pop(event, None)
