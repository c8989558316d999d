"""Where a 1080p frame's time goes on the card: a torch.profiler trace.

    python -m pupiloptixlab_tpu_torch.profile_frame SCENE.xml [SCENE.xml ...]

Each scene is flattened at 1920x1080 (its own depth) and rendered with
``render_frame`` on the default card: 2 warm-up frames, 2 frames timed on the
host clock, then 2 frames under ``torch.profiler`` (CPU and CUDA
activities). One JSON line per scene gives the host ms/frame with and
without the profiler, the device time per frame (sum of the CUDA events),
the device's busy share (union of those events over the first-to-last
window), device ops per frame, the launches of the port's kernels per frame,
the device ms per frame of each of the port's kernels (csrc/*.cu) and of
the costliest kernels by name, and the peak device memory
(``max_memory_allocated``) over the timed and profiled frames. Needs a CUDA
card; raises without one.

It uses only ``flatten_scene``, ``camera_block_from_scene`` and
``render_frame``, so the same file can profile another tree's package:
``PYTHONPATH=<tree> python3 pupiloptixlab_tpu_torch/profile_frame.py ...``.
"""

from __future__ import annotations

import json
import sys
import time
from collections import defaultdict

import torch

FILM = (1920, 1080)
FRAMES = 2
# the port's kernels by their __global__ names in csrc/*.cu
PORT_KERNELS = ("gather_planes_kernel", "count_less_kernel", "bvh_closest_kernel",
                "bvh_anyhit_kernel", "sweep_closest_kernel", "sweep_anyhit_kernel",
                "atrous_iter_kernel", "bvh_closest_mt_kernel")


def _busy_us(ranges) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(ranges):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (cur_e - cur_s if cur_e is not None else 0.0)


def _short(name: str) -> str:
    """A kernel's name without its trailing argument list."""
    if not name.endswith(")"):
        return name
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0:
            return name[:i]
    return name


def profile_scene(xml: str, top: int = 15) -> dict:
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType

    from pupiloptixlab_tpu_torch import kernels
    from pupiloptixlab_tpu_torch.flatten import camera_block_from_scene, flatten_scene
    from pupiloptixlab_tpu_torch.render.integrator import render_frame
    from pupiloptixlab_tpu_torch.scene import load_scene

    scene = load_scene(xml)
    scene.sensor.film.w, scene.sensor.film.h = FILM
    data, config = flatten_scene(scene)
    cam = camera_block_from_scene(scene)
    accum = torch.zeros((FILM[0] * FILM[1], 3), dtype=torch.float32, device=data.tris.packed.device)
    frame = 0

    def frames(count):
        nonlocal frame
        for _ in range(count):
            render_frame(data, cam, frame, frame, accum, config)
            frame += 1
        torch.cuda.synchronize()

    frames(2)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    frames(FRAMES)
    host_ms = (time.perf_counter() - t0) * 1e3 / FRAMES
    kernels.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        frames(FRAMES)
        prof_host_ms = (time.perf_counter() - t0) * 1e3 / FRAMES
    launches = {k: v / FRAMES for k, v in kernels.LAUNCHES.items() if v}
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        raise RuntimeError("profile_frame: the profiler recorded no device events")
    ranges = [(e.time_range.start, e.time_range.end) for e in events]
    by_name: dict[str, float] = defaultdict(float)
    for e in events:
        by_name[_short(e.name)] += e.time_range.elapsed_us()
    window = max(r[1] for r in ranges) - min(r[0] for r in ranges)
    device_ms = sum(by_name.values()) / 1e3 / FRAMES
    costliest = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    port: dict[str, float] = defaultdict(float)
    for name, us in by_name.items():
        for k in PORT_KERNELS:
            if k in name:
                port[k] += us / 1e3 / FRAMES
    return {
        "scene": xml, "film": list(FILM), "max_depth": config.max_depth,
        "instanced": config.instanced, "tri_count": config.tri_count,
        "host_ms_per_frame": host_ms, "profiled_host_ms_per_frame": prof_host_ms,
        "device_ms_per_frame": device_ms, "busy_share": _busy_us(ranges) / window,
        "device_ops_per_frame": len(events) / FRAMES, "launches_per_frame": launches,
        "costliest_ms_per_frame": {k: v / 1e3 / FRAMES for k, v in costliest},
        "port_kernel_ms_per_frame": dict(port),
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
        "package": kernels.__file__,
        "device": torch.cuda.get_device_name(0),
    }


def main(argv: list[str]) -> int:
    if not argv:
        sys.exit(__doc__)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_frame: needs a CUDA card")
    with torch.inference_mode():
        for xml in argv:
            print(json.dumps(profile_scene(xml)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
