"""Progressive path tracer over a mitsuba3 XML scene, on the PyTorch/CUDA port.

The counterpart of examples/path_tracer.py for pupiloptixlab_tpu_torch:
boot the System with a display client, add a PTPass, load a scene, render,
save a screenshot of the accumulated image. Run:

    python examples/path_tracer_torch.py [scene.xml] [--spp N] [--out out.exr]
    python examples/path_tracer_torch.py --device cpu --spp 4   # no GPU
    python examples/path_tracer_torch.py --interactive   # live window if available
    python examples/path_tracer_torch.py --web [--port 8090]  # browser GUI

The default device is the CUDA card (an error where there is none); the
output format follows the extension: .exr and .hdr keep linear radiance,
anything else gets the display transfer (PNG and JPEG need Pillow).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from pupiloptixlab_tpu_torch.passes import PTPass  # noqa: E402
from pupiloptixlab_tpu_torch.system import System  # noqa: E402

DEFAULT_SCENE = REPO / "data" / "oracle_mat.xml"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("scene", nargs="?", default=str(DEFAULT_SCENE))
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--out", default="pt_out.exr")
    ap.add_argument("--max-depth", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    ap.add_argument("--interactive", action="store_true",
                    help="live matplotlib window (needs a local display)")
    ap.add_argument("--web", action="store_true",
                    help="serve the interactive GUI over HTTP (remote hosts)")
    ap.add_argument("--port", type=int, default=8090)
    args = ap.parse_args()

    system = System(display="web" if args.web else "window", web_port=args.port,
                    device=args.device)
    pt = PTPass(max_depth=args.max_depth)
    system.add_pass(pt)
    if not system.set_scene(args.scene):
        raise SystemExit(1)

    if args.interactive or args.web:
        system.run(threaded=True)  # render thread + display client, until quit
    else:
        # the window client is bound but not run: it only keeps the last
        # display image. The screenshot is linear RGBA rows flipped for
        # .exr/.hdr, the display transfer (ACES + gamma, uint8) otherwise
        system.run(max_frames=args.spp)
        system.display.save_screenshot(args.out)
        print(f"saved {args.out} ({pt.sample_cnt} spp on {system.device}, "
              f"{pt.last_exec_time_ms:.1f} ms/frame last)")
    system.destroy()


if __name__ == "__main__":
    main()
