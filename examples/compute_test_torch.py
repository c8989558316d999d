"""Raw-compute pass demo on the PyTorch/CUDA port (the example/cuda_test
analog): animate gradients into three displayable buffers with a device
function each frame.

The counterpart of examples/compute_test.py for pupiloptixlab_tpu_torch. Run:

    python examples/compute_test_torch.py               # on the CUDA card
    python examples/compute_test_torch.py --device cpu  # no GPU
"""

from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pupiloptixlab_tpu_torch.passes import ComputePass  # noqa: E402
from pupiloptixlab_tpu_torch.system import System  # noqa: E402

W = H = 256


def animate(frame: int, w: int, h: int, device) -> dict:
    """Three waves over the (h*w,) pixels of frame ``frame``, in float32
    on ``device`` ((h*w, 3), (h*w,) and (h*w, 2) tensors)."""
    idx = torch.arange(w * h, device=device)
    x = (idx % w).to(torch.float32) / w
    y = torch.div(idx, w, rounding_mode="floor").to(torch.float32) / h
    t = float(np.float32(frame) * np.float32(0.05))  # float32 product, as jnp's
    r = 0.5 + 0.5 * torch.sin(2 * math.pi * (x + t))
    g = 0.5 + 0.5 * torch.sin(2 * math.pi * (y + t))
    b = 0.5 + 0.5 * torch.sin(2 * math.pi * (x + y + t))
    return {
        "wave rgb": torch.stack([r, g, b], dim=-1),
        "wave x": r,
        "wave xy": torch.stack([r, g], dim=-1),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device; default: the CUDA card")
    ap.add_argument("--frames", type=int, default=10)
    args = ap.parse_args()

    system = System(has_display=True, device=args.device)
    system.add_pass(
        ComputePass(lambda f, w, h: animate(f, w, h, system.device), W, H)
    )
    system._render_flag.set()
    system.run(max_frames=args.frames)
    names = system.buffers.displayable_names()
    print("displayable buffers:", names, "on", system.buffers["wave rgb"].array.device)
    assert "wave rgb" in names
    system.destroy()


if __name__ == "__main__":
    main()
