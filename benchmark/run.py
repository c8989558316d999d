"""Run one cell of the benchmark once:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``) names its
configuration and traffic mix; both, its limits and its metrics' readers are
found by name under ``benchmark/`` (see harness/spec.py); the
configuration's ``env`` is set before the program is imported. The run builds
the program (the ``pupiloptixlab_tpu_torch`` port) and warms up the cell's
shapes (set-up), measures for ``--seconds``, then checks what the timed
path produced against the plain reference (``benchmark/reference``).
With ``--trace 1`` a part of the window runs under torch.profiler and the
per-layer metrics are reported instead of the end-to-end ones.

The last line of standard output is the result, one JSON object; the last
lines of standard error are the numbers compared, each beside its limit.
No result is printed, and the exit code is not 0, when there is no CUDA
card (or fewer than the cell needs) or when ``jax``, ``jaxlib``, ``flax``
or the JAX package ``pupiloptixlab_tpu`` was loaded. The kernels' build
stays in the checkout (``pupiloptixlab_tpu_torch/_build/``) and Triton's
cache under ``benchmark/.cache/``, so a second run builds nothing.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "benchmark" / ".cache" / "triton"))
sys.path.insert(0, str(ROOT))


def _say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _card_line() -> str:
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return p.stdout.strip() or p.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import spec
    from benchmark.harness.runner import forbidden_modules, run_cell

    cell = spec.load_cell(args.workload, ROOT)
    spec.apply_env(cell)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        _say(f"{args.workload} needs {cell.chips} CUDA card(s); found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    _say(f"card: {_card_line()}")
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_PROCESS)
    rec = result.pop("_record")
    rows = [[round(i["t1"] - i["t0"], 4)] + [round(i["batch"].get(k, 0.0), 1) for k in
             ("warmup_ms", "capture_ms", "instantiate_ms", "replay_ms")]
            for i in rec.get("images", [])]
    _say("images (s, warm-up, capture, instantiation, replays ms): " + json.dumps(rows))
    shown = {k: v for k, v in rec.items() if k not in ("images", "frames", "trace")}
    if "trace" in rec:
        shown["trace"] = {k: v for k, v in rec["trace"].items() if k != "families"}
        shown["families"] = {f: {"calls": len(r["work"]), "device_s": r.get("device_s"),
                                 "kernels": r["kernel_names"]}
                             for f, r in rec["trace"]["families"].items()}
    _say("record: " + json.dumps(shown, default=str))
    bad = forbidden_modules()
    if bad:
        _say(f"forbidden modules loaded in the run: {bad}")
        return 3
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        _say(f"check {name} {c['value']!r} limit {c['limit']!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
