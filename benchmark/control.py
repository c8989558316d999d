"""The comparison's readings on the card, for setting each limit:

    python3 benchmark/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed, in one process: one run of the cell with a short window at
the cell's own load and size, the numbers compared for the program's
outputs, and the same numbers with the control (the reference computed with
a bfloat16 film) in the program's place. One JSON line a seed on standard
output. The benchmark's own runs never run the control.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import spec
    from benchmark.harness.runner import run_cell

    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload, ROOT)
    spec.apply_env(cell)
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = run_cell(cell, seed, args.seconds, False, "cuda", t0, control=True)
        r.pop("_record")
        print(json.dumps({"seed": seed, "program": {k: v["value"] for k, v in r["checks"].items()},
                          "control": r["control"], "attempted": r["attempted"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
