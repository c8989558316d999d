"""Logging — the ``Pupil::Log`` analog (util/log.h) on Python logging."""

from __future__ import annotations

import logging
import sys

_FORMAT = "[%(levelname)s] %(message)s"
_configured = False


def get_logger(name: str = "pupil_tpu") -> logging.Logger:
    global _configured
    if not _configured:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(_FORMAT))
        root = logging.getLogger("pupil_tpu")
        root.addHandler(handler)
        root.setLevel(logging.INFO)
        _configured = True
    return logging.getLogger(name)
