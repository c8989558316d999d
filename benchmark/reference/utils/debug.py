"""Device-value sanitizer: per-stage counts of bad values in a frame.

Mirrors pupiloptixlab_tpu/utils/debug.py, the analog of the reference's
OptiX debug exception flags (optix/pipeline.cpp:19) and CUDA_SYNC_CHECK
after passes (system/system.cpp:51). With ``RenderConfig.debug_checks``
set, the frame adds a report ({stage: count of non-finite, or below-bound,
elements}) to its buffers; the counts stay on the frame's device, and
``assert_all_finite`` reads them all in one transfer and raises a
``SanitizerError`` naming every bad stage.

Usage::

    config = dataclasses.replace(config, debug_checks=True)
    accum, bufs = render_frame(...)         # bufs["sanitizer"] present
    assert_all_finite(bufs["sanitizer"])    # raises SanitizerError

``PTPass`` sets ``debug_checks`` when ``PUPIL_SANITIZE`` is non-empty and
gates every frame on the report.
"""

from __future__ import annotations

import torch


class SanitizerError(RuntimeError):
    """Non-finite device values detected by the frame sanitizer."""


def _count_bad(arr: torch.Tensor, lo: float | None = None) -> torch.Tensor:
    """0-dim int32 count of non-finite (or < lo) elements."""
    bad = ~torch.isfinite(arr)
    if lo is not None:
        bad = bad | (arr < lo)
    return torch.count_nonzero(bad).to(torch.int32)


def finite_report(stages: dict[str, tuple[torch.Tensor, float | None]]) -> dict:
    """{stage: 0-dim int32 count on the stage's device}. ``stages`` maps a
    stage name to (tensor, lower bound or None)."""
    return {k: _count_bad(a, lo) for k, (a, lo) in stages.items()}


def assert_all_finite(report: dict, context: str = "frame") -> None:
    """Host-side gate over a ``finite_report`` result: raises
    SanitizerError naming every stage with bad values. The counts come to
    the host in one transfer (the one sync of the check)."""
    if not report:
        return
    counts = torch.stack([torch.as_tensor(v).reshape(()) for v in report.values()]).tolist()
    bad = {k: int(c) for k, c in zip(report, counts) if int(c) > 0}
    if bad:
        detail = ", ".join(f"{k}: {c} bad element(s)" for k, c in bad.items())
        raise SanitizerError(f"sanitizer [{context}]: {detail}")
