"""Framework shell with no passes (the empty_gui analog), on the PyTorch/CUDA
port: the counterpart of examples/empty_shell.py, on data/oracle_mat.xml.

    python examples/empty_shell_torch.py [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from pupiloptixlab_tpu_torch.system import System  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device; default: the CUDA card")
    args = ap.parse_args()

    system = System(has_display=True, device=args.device)
    if not system.set_scene(REPO / "data" / "oracle_mat.xml"):
        raise SystemExit(1)
    system.run(max_frames=3)
    system.destroy()
    print("shell ran 3 empty frames")


if __name__ == "__main__":
    main()
