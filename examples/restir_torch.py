"""ReSTIR (DI, or GI with --gi) on the PyTorch/CUDA port, headless.

The counterpart of examples/restir.py for pupiloptixlab_tpu_torch: boot
the System, add a ReSTIRPass, load a scene with area lights, render a
number of frames, save the accumulated image. Run:

    python examples/restir_torch.py [scene.xml] [--frames N] [--gi] [--out out.exr]
    python examples/restir_torch.py --device cpu --frames 4   # no GPU

The default scene is data/oracle_mat.xml (two area lights and a constant
env); the default device is the CUDA card (an error where there is none).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from pupiloptixlab_tpu_torch.display.tonemap import expand_to_rgba, to_display_u8  # noqa: E402
from pupiloptixlab_tpu_torch.passes import ReSTIRPass  # noqa: E402
from pupiloptixlab_tpu_torch.system import System  # noqa: E402
from pupiloptixlab_tpu_torch.utils.image import save_image  # noqa: E402

DEFAULT_SCENE = REPO / "data" / "oracle_mat.xml"


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("scene", nargs="?", default=str(DEFAULT_SCENE))
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--out", default="restir_out.exr")
    ap.add_argument("--candidates", type=int, default=8)
    ap.add_argument("--taps", type=int, default=3)
    ap.add_argument("--gi", action="store_true",
                    help="ReSTIR GI (one-bounce indirect reservoirs)")
    ap.add_argument("--device", default=None, help="torch device; default: the CUDA card")
    args = ap.parse_args()

    system = System(device=args.device)
    restir = ReSTIRPass(m_candidates=args.candidates, spatial_taps=args.taps, gi=args.gi)
    system.add_pass(restir)
    if not system.set_scene(args.scene):
        raise SystemExit(1)
    system.run(max_frames=args.frames)

    buf = system.buffers["restir accum"]
    rgba = expand_to_rgba(buf.array, buf.desc.width, buf.desc.height).flip(0)
    if args.out.lower().endswith((".exr", ".hdr")):
        save_image(args.out, rgba.cpu().numpy())
    else:
        save_image(args.out, to_display_u8(rgba[..., :3]).cpu().numpy())
    print(f"saved {args.out} ({restir.sample_cnt} frames of ReSTIR "
          f"{'GI' if args.gi else 'DI'} on {system.device}, "
          f"{restir.last_exec_time_ms:.1f} ms/frame last)")
    system.destroy()


if __name__ == "__main__":
    main()
