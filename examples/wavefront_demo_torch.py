"""Wavefront path tracing with a persistent ray pool, on the PyTorch/CUDA port.

The counterpart of examples/wavefront_demo.py for pupiloptixlab_tpu_torch,
headless: renders N frames with the wavefront engine (a pool of one film's
lanes, refilled as paths end), reports the time a frame, the loop's
iterations and host syncs, and saves the mean. Run:

    python examples/wavefront_demo_torch.py [scene.xml] [--frames 8] [--spp 1]
    python examples/wavefront_demo_torch.py --device cpu --width 64 --height 64 --frames 2

The default scene is data/mesh_env.xml; the default device is the CUDA
card (an error where there is none).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

from pupiloptixlab_tpu_torch.device import resolve_device  # noqa: E402
from pupiloptixlab_tpu_torch.display.tonemap import expand_to_rgba  # noqa: E402
from pupiloptixlab_tpu_torch.scene import load_scene  # noqa: E402
from pupiloptixlab_tpu_torch.utils.image import save_image  # noqa: E402
from pupiloptixlab_tpu_torch.wavefront import render_wavefront  # noqa: E402
from pupiloptixlab_tpu_torch.world import World  # noqa: E402

DEFAULT_SCENE = REPO / "data" / "mesh_env.xml"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("scene", nargs="?", default=str(DEFAULT_SCENE))
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--spp", type=int, default=1)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--out", default="wavefront_out.exr")
    ap.add_argument("--device", default=None, help="torch device; default: the CUDA card")
    args = ap.parse_args()

    device = resolve_device(args.device)
    scene = load_scene(args.scene)
    scene.sensor.film.w, scene.sensor.film.h = args.width, args.height
    world = World(device=device)
    world.set_scene(scene)
    data, config = world.get_scene_data()

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    film_sum = None
    times = []
    for f in range(args.frames):
        camera = world.get_camera_block()
        sync()
        t0 = time.perf_counter()
        out = render_wavefront(data, camera, f * 7919, config, spp=args.spp)
        sync()
        times.append(time.perf_counter() - t0)
        film_sum = out["film"] if film_sum is None else film_sum + out["film"]
    dt = sum(times[1:]) / max(len(times) - 1, 1) if len(times) > 1 else times[0]
    print(f"wavefront {args.width}x{args.height} spp={args.spp} on {device}: "
          f"{dt * 1e3:.1f} ms/frame, {out['iterations']} iterations, {out['syncs']} host syncs")
    rgba = expand_to_rgba(film_sum / args.frames, args.width, args.height).flip(0)
    save_image(args.out, rgba.cpu().numpy())
    print("saved", args.out)


if __name__ == "__main__":
    main()
