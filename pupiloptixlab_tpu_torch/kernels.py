"""Build, load and count the hand-written CUDA kernels (``csrc/*.cu``).

Each ``csrc/<name>.cu`` compiles with nvcc into its own shared library
holding ``extern "C"`` launchers (route (b): a plain C interface bound
with ctypes, no PyTorch headers, so a build takes seconds). All sources
compile in parallel, one nvcc process each, at first use. The output
goes to ``pupiloptixlab_tpu_torch/_build/<hash>/``, keyed by a hash of
every source and the flags, so an edited source rebuilds and a stale
library is never loaded.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``-fmad=false`` with IEEE
division and square root (no ``--use_fast_math``): every float op rounds
on its own exactly as the plain PyTorch versions do, so the traversal
kernels return bit-identical hit distances.

``LAUNCHES[name]`` counts the launches of each kernel; a wrapper adds
one where it launches its kernel and nowhere else. A wrapper called while
a CUDA graph is captured launches nothing: ``captured_launches`` takes
those calls back out, and ``add_launches`` counts them once a replay.

The launch path is kept short, since the port issues thousands of launches
a frame: ``launcher`` returns a ctypes function bound once (one dict lookup
after the first call), and ``stream_ptr`` reads the current stream's raw
handle through ``torch._C._cuda_getCurrentRawStream`` (about 0.1 us a call
on the H100 host, against about 7 us for
``torch.cuda.current_stream(device).cuda_stream``, which builds a Stream
object), so it still honours a caller's ``torch.cuda.stream(...)``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-fmad=false", "-prec-div=true", "-prec-sqrt=true",
    "-Xptxas", "-v",
]

# kernel name -> (source stem, C launcher symbol, ctypes argtypes)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNELS = {
    "bvh_closest": ("bvh_traverse", "launch_bvh_closest",
                    [_P] * 8 + [_P] * 6 + [_I] * 4 + [_P] * 4),
    "bvh_closest_count": ("bvh_traverse", "launch_bvh_closest_count",
                          [_P] * 8 + [_P] * 6 + [_I] * 4 + [_P] * 5),
    "bvh_closest_visits": ("bvh_traverse", "launch_bvh_closest_visits",
                           [_P] * 8 + [_P] * 6 + [_I] * 4 + [_P] * 5),
    "bvh_anyhit": ("bvh_traverse", "launch_bvh_anyhit",
                   [_P] * 8 + [_P] * 6 + [_I] * 4 + [_P] * 3),
    "bvh_closest_inst": ("bvh_traverse", "launch_bvh_closest_inst",
                         [_P] * 8 + [_P] * 8 + [_I] * 5 + [_P] * 5),
    "bvh_closest_inst_count": ("bvh_traverse", "launch_bvh_closest_inst_count",
                               [_P] * 8 + [_P] * 8 + [_I] * 5 + [_P] * 6),
    "bvh_anyhit_inst": ("bvh_traverse", "launch_bvh_anyhit_inst",
                        [_P] * 8 + [_P] * 8 + [_I] * 5 + [_P] * 3),
    "bvh_closest_mt": ("bvh_traverse", "launch_bvh_closest_mt",
                       [_P] * 8 + [_P] * 6 + [_I] * 3 + [_P] * 4),
    "bvh_closest_mt_at": ("bvh_traverse", "launch_bvh_closest_mt_at",
                          [_P] * 8 + [_P] * 6 + [_I] * 4 + [_P] * 4),
    "bvh_closest_mt_visits": ("bvh_traverse", "launch_bvh_closest_mt_visits",
                              [_P] * 8 + [_P] * 6 + [_I] * 4 + [_P] * 5),
    "gather_planes": ("gather", "launch_gather_planes",
                      [_P, _I, _I, _P, _I, _I, _P, _I, _P, _P]),
    "count_less": ("gather", "launch_count_less", [_P, _I, _I, _I, _P, _P, _I, _P, _P]),
    "sweep_closest": ("sweep", "launch_sweep_closest",
                      [_P] * 8 + [_P, _P, _I, _I, _I, _P, _P, _P]),
    "sweep_closest_visits": ("sweep", "launch_sweep_closest_visits",
                             [_P] * 8 + [_P, _P, _I, _I, _I, _P, _P, _P, _P]),
    "sweep_anyhit": ("sweep", "launch_sweep_anyhit",
                     [_P] * 8 + [_P, _P, _I, _I, _I, _P, _P]),
    "atrous_iter": ("atrous", "launch_atrous_iter",
                    [_P] * 4 + [_I] * 5 + [_F, _F, _I, _F, _P]),
    "bsdf_eval": ("bsdf", "launch_bsdf_eval", [_P] * 28 + [_I] * 3 + [_P] * 2),
    "bsdf_sample": ("bsdf", "launch_bsdf_sample", [_P] * 28 + [_I] * 3 + [_P] * 3),
}

LAUNCHES = {name: 0 for name in KERNELS}

_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[str, object] = {}  # kernel name -> its bound ctypes launcher
BUILD_LOG: dict[str, str] = {}  # source stem -> nvcc stdout+stderr (ptxas -v)
BUILD_SECONDS = 0.0


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextlib.contextmanager
def captured_launches():
    """Around the capture of a CUDA graph: yields a dict that, on exit,
    holds the wrapper calls made inside per kernel (the launches one replay
    makes), and leaves ``LAUNCHES`` as it was before (the capture itself
    ran nothing)."""
    before = dict(LAUNCHES)
    captured: dict[str, int] = {}
    try:
        yield captured
    finally:
        captured.update({k: LAUNCHES[k] - before[k] for k in LAUNCHES
                         if LAUNCHES[k] != before[k]})
        LAUNCHES.update(before)


def add_launches(per_replay: dict, replays: int) -> None:
    """Count ``replays`` replays of a graph whose capture made the wrapper
    calls ``per_replay`` (from ``captured_launches``)."""
    for k, v in per_replay.items():
        LAUNCHES[k] += v * replays


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine with the CUDA toolkit")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile (if needed) and load every kernel library; idempotent."""
    global BUILD_SECONDS
    if _libs:
        return _libs
    t0 = time.perf_counter()
    out_dir = BUILD_ROOT / _source_hash()
    stems = sorted({stem for stem, _, _ in KERNELS.values()})
    missing = [s for s in stems if not (out_dir / f"lib{s}.so").exists()]
    nvcc = _nvcc() if missing else None
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for stem in missing:
        lib = out_dir / f"lib{stem}.so"
        tmp = out_dir / f"lib{stem}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{stem}.cu")]
        procs[stem] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, lib)
    failed = []
    for stem, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOG[stem] = out
        if proc.returncode != 0:
            failed.append(f"{stem}.cu (rc {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    for stem in stems:
        _libs[stem] = ctypes.CDLL(str(out_dir / f"lib{stem}.so"))
    for name, (stem, sym, argtypes) in KERNELS.items():
        fn = getattr(_libs[stem], sym)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    BUILD_SECONDS = time.perf_counter() - t0
    return _libs


def launcher(name: str):
    """The ctypes launcher of kernel ``name`` (builds on first use)."""
    fn = _fns.get(name)
    if fn is None:
        build_all()
        fn = _fns[name]
    return fn


_raw_stream = None  # index -> the current stream's cudaStream_t as an int


def stream_ptr(device) -> int:
    """The raw handle of the current CUDA stream of ``device`` (a
    torch.device with an index, or the index)."""
    global _raw_stream
    if _raw_stream is None:
        import torch

        _raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
            lambda index: torch.cuda.current_stream(index).cuda_stream)
    index = device if isinstance(device, int) else device.index
    return _raw_stream(index if index is not None else -1)


def graph_nodes(raw_graph: int) -> int:
    """The node count of a captured CUDA graph (its cudaGraph_t as an int:
    ``torch.cuda.CUDAGraph(keep_graph=True).raw_cuda_graph()``), from
    libcuda's ``cuGraphGetNodes``."""
    count = ctypes.c_size_t(0)
    rc = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(raw_graph), None, ctypes.byref(count))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {rc}")
    return count.value


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} launch failed: cudaError {rc}")
