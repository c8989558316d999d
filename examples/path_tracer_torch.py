"""Progressive path tracer over a mitsuba3 XML scene, on the PyTorch/CUDA port.

The counterpart of examples/path_tracer.py for pupiloptixlab_tpu_torch:
boot the System, add a PTPass, load a scene, render headless, save the
accumulated image. Run:

    python examples/path_tracer_torch.py [scene.xml] [--spp N] [--out out.exr]
    python examples/path_tracer_torch.py --device cpu --spp 4   # no GPU

The default device is the CUDA card (an error where there is none); the
output format follows the extension: .exr and .hdr keep linear radiance,
anything else gets the display transfer.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from pupiloptixlab_tpu_torch.display.tonemap import expand_to_rgba, to_display_u8  # noqa: E402
from pupiloptixlab_tpu_torch.passes import PTPass  # noqa: E402
from pupiloptixlab_tpu_torch.system import System  # noqa: E402
from pupiloptixlab_tpu_torch.utils.image import save_image  # noqa: E402

DEFAULT_SCENE = REPO / "data" / "oracle_mat.xml"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("scene", nargs="?", default=str(DEFAULT_SCENE))
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--out", default="pt_out.exr")
    ap.add_argument("--max-depth", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA card")
    args = ap.parse_args()

    system = System(device=args.device)
    pt = PTPass(max_depth=args.max_depth)
    system.add_pass(pt)
    if not system.set_scene(args.scene):
        raise SystemExit(1)
    system.run(max_frames=args.spp)

    # as the reference's screenshot does: linear RGBA rows flipped for
    # .exr/.hdr, the display transfer (ACES + gamma, uint8) for the rest
    buf = system.buffers["pt accum"]
    rgba = expand_to_rgba(buf.array, buf.desc.width, buf.desc.height).flip(0)
    if args.out.lower().endswith((".exr", ".hdr")):
        save_image(args.out, rgba.cpu().numpy())
    else:
        save_image(args.out, to_display_u8(rgba[..., :3]).cpu().numpy())
    print(f"saved {args.out} ({pt.sample_cnt} spp on {system.device}, "
          f"{pt.last_exec_time_ms:.1f} ms/frame last)")
    system.destroy()


if __name__ == "__main__":
    main()
