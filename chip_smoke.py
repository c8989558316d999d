#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each fails the run on its first fault; nothing is caught):
  1. device   require CUDA; print the card's name and power limit
  2. build    nvcc-build the CUDA kernels from csrc/ (pupiloptixlab_tpu_torch/_build/),
              one process per source; say whether the C++ or the numpy BVH
              build and OBJ parser ran
  3. kernels  K1-K4 against their plain PyTorch versions on data/mesh_env.xml
              at the main path's shapes (1920x1080 = 2,073,600 rays): the
              traversal kernels (K1 closest, K2 any hit) on primary, bounce
              and shadow rays, exact against the brute-force sweep on a
              65,536-ray subset and timed at full N; the gather (K3) on the
              triangle attributes, the env column CDF and the texel pool,
              and the CDF count (K4) on the env row CDF, both bit-exact and
              each beside one PyTorch library call on the same inputs
  4. frame    render_frame on the mesh_env BVH route at 1920x1080, depth 4:
              1 warm-up + 2 timed frames, launch counters reset just before
              and read just after; fails unless K1-K4 each launched
  5. sweep    K3 and K4 again, at the shapes the oracle_mat path gives them
              (its attribute, sphere, material, emitter and texture tables
              at the main path's own indices; its emitter-select CDF at its
              own draws), bit-exact and timed as in phase 3;
              K5 (closest) and K6 (any hit) against their plain versions,
              exact (row equal, t bit-equal, flag equal) on 65,536-lane
              subsets of the main path's primary, bounce and shadow rays and
              timed at full N, on (a) data/oracle_mat.xml's table (1 chunk),
              (b) mesh_env's table flattened under PUPIL_NO_BVH (321 chunks,
              11 super-boxes; here K5 at full N must also equal K1 bit for
              bit), (c) seeded triangle soups of 128, 512 and 2,560 rows:
              one case for each branch of the reference's sweep_triangles
              (checked and timed, but outside the sums of the kernels line)
  6. system   System + PTPass through set_scene / run at 1920x1080, depth 4:
              oracle_mat (1 warm-up + 4 timed frames) and mesh_env under
              PUPIL_NO_BVH (1 warm-up + 2 timed), each with the counters
              reset before and read after; fails unless K5, K6, K3 and K4
              each launched. The film is set by a copy of the scene XML
              written to a temporary directory, with meshes/ and env/
              linked beside it
  7. parity   a 128x8 mesh_env film at seeds 0-3 on the card (kernels) and on
              the CPU (plain versions), and a 64x64 oracle_mat film through
              System at seeds 0-3, card against CPU: frame rel MSE <= 1e-5,
              >= 99% of pixels within rtol 1e-4, the RNG test AOV bit-equal;
              mesh_env 128x8 on the card with and without PUPIL_NO_BVH
              (rel MSE printed; the reference reports 0.0)
  8. oracle   render() at 64x64, 512 spp: mesh_env against
              tests/data/oracle_mesh_env_64.exr (mean ratio within 0.02, rel
              MSE < 1.5e-2) and oracle_mat against tests/data/oracle_mat_64.exr
              (mean ratio within 0.01, rel MSE < 4e-3, 4x4-box rel MSE < 1e-3)
  9. no-jax   neither 'jax' nor any module of the JAX package is in sys.modules

Each kernel's bound_ms is the least time the card could take for the timed
calls: the larger of the bytes moved (each input read once, each output
written once) over 3.35 TB/s and the float operations this run's rays need
over 67 TFLOP/s (FP32 outside the tensor cores), both from the H100 SXM data
sheet. For the traversals and the culled sweep the operations are a floor
counted from this run's rays (the box tests every live ray must make and
the one leaf or chunk every hit ray must test).

In the {"kernels": [...]} line each kernel's ms, plain_ms, library_ms and
bound_ms are sums over the timed calls at the shapes of the main paths it
runs on, and its launches the sum over the runs of those same paths
(launches_by_path has each run's own count): K1, K2 on the mesh_env BVH
frame; K3, K4 on all three runs; K5, K6 on the two System runs.

Output: progress lines, then a {"kernels": [...]} JSON line, the
``nvidia-smi --query-gpu=name,power.limit`` line, and as the last line
{"ok": true, "device": {...}}. Details also go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
DATA = REPO / "data"
MESH_ENV = DATA / "mesh_env.xml"
ORACLE_MAT = DATA / "oracle_mat.xml"
ORACLE_EXR = {
    "mesh_env": REPO / "tests" / "data" / "oracle_mesh_env_64.exr",
    "oracle_mat": REPO / "tests" / "data" / "oracle_mat_64.exr",
}
SUBSET = 65536
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12     # H100 SXM data sheet, outside the tensor cores
MT_FLOPS_CLOSEST = 55       # per triangle test, the reference's cost estimates
MT_FLOPS_ANY = 50           # (pallas_intersect.py:183, :366)
SLAB_FLOPS = 22             # 6 sub/mul pairs + 10 min/max per box test

_CSRC = "pupiloptixlab_tpu_torch/csrc/"
_PALLAS = "pupiloptixlab_tpu/accel/"
KERNEL_META = {
    "bvh_closest": (_CSRC + "bvh_traverse.cu", _PALLAS + "pallas_bvh.py:298"),
    "bvh_anyhit": (_CSRC + "bvh_traverse.cu", _PALLAS + "pallas_bvh.py:747"),
    "gather_planes": (_CSRC + "gather.cu",
                      _PALLAS + "gather.py:44, " + _PALLAS + "gather.py:152"),
    "count_less": (_CSRC + "gather.cu", _PALLAS + "gather.py:194"),
    "sweep_closest": (_CSRC + "sweep.cu", _PALLAS + "pallas_intersect.py:43, "
                      + _PALLAS + "pallas_intersect.py:198"),
    "sweep_anyhit": (_CSRC + "sweep.cu", _PALLAS + "pallas_intersect.py:97"),
}
# the main-path runs whose launches each kernel is counted on
PATHS_OF = {
    "bvh_closest": ("mesh_env_bvh",),
    "bvh_anyhit": ("mesh_env_bvh",),
    "gather_planes": ("mesh_env_bvh", "oracle_mat", "mesh_env_nobvh"),
    "count_less": ("mesh_env_bvh", "oracle_mat", "mesh_env_nobvh"),
    "sweep_closest": ("oracle_mat", "mesh_env_nobvh"),
    "sweep_anyhit": ("oracle_mat", "mesh_env_nobvh"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call between CUDA events, after a warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_time_ms(fn) -> float:
    """One call on the host clock, ended by a synchronise (the plain sweeps
    take up to seconds a call)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


@contextlib.contextmanager
def pupil_no_bvh(on: bool):
    """PUPIL_NO_BVH=1 while a scene is flattened: the brute chunk sweep on a
    BVH-scale scene, read by flatten_scene as the reference's flatten does."""
    if on:
        os.environ["PUPIL_NO_BVH"] = "1"
    try:
        yield
    finally:
        os.environ.pop("PUPIL_NO_BVH", None)


def load_tables(xml: Path, width: int, height: int, device, no_bvh: bool = False):
    from pupiloptixlab_tpu_torch.flatten import camera_block_from_scene, flatten_scene
    from pupiloptixlab_tpu_torch.scene import load_scene

    scene = load_scene(xml)
    scene.sensor.film.w, scene.sensor.film.h = width, height
    with pupil_no_bvh(no_bvh):
        data, config = flatten_scene(scene, device=device)
    return data, config, camera_block_from_scene(scene, device=device)


def scene_copy(xml: Path, width: int, height: int, tmp: Path) -> Path:
    """A copy of the scene XML with the film set to width x height, in
    ``tmp`` with data/meshes and data/env linked beside it."""
    text = xml.read_text()
    for key, value in (("width", width), ("height", height)):
        text, count = re.subn(rf'(<integer name="{key}" value=")\d+(")',
                              rf"\g<1>{value}\g<2>", text)
        require(count == 1, f"{xml.name}: expected one film {key}, found {count}")
    for sub in ("meshes", "env"):
        if not (tmp / sub).exists():
            os.symlink(DATA / sub, tmp / sub)
    out = tmp / f"{xml.stem}_{width}x{height}.xml"
    out.write_text(text)
    return out


class Bound:
    """Sums, over the timed calls of one kernel, the least time the card
    could take for each: max(bytes / HBM rate, operations / FP32 rate)."""

    def __init__(self):
        self.ms = self.bytes_ms = self.ops_ms = 0.0

    def add(self, n_bytes: float, n_flops: float) -> tuple[float, str]:
        """This call's own bound and which of the two terms set it."""
        b = n_bytes / HBM_BYTES_PER_S * 1e3
        o = n_flops / FP32_FLOP_PER_S * 1e3
        self.bytes_ms += b
        self.ops_ms += o
        self.ms += max(b, o)
        return max(b, o), "bytes" if b >= o else "operations"

    def fields(self) -> dict:
        return {"bound_ms": self.ms,
                "bound_by": "bytes" if self.bytes_ms >= self.ops_ms else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def main_path_rays(data, config, cam, seed: int = 0):
    """Primary, first-bounce and first NEE shadow rays exactly as the
    frame builds them (render_sample + the first _bounce), and with them
    the (table, index) pairs of the first bounce's gathers ("gathers") and
    the (CDF, draws) of its emitter selection ("counts", empty for a scene
    without area emitters)."""
    import torch

    from pupiloptixlab_tpu_torch.accel.gather import gather_cols
    from pupiloptixlab_tpu_torch.accel.intersect import intersect_closest
    from pupiloptixlab_tpu_torch.flatten.types import EM_RAD_TEX, MAT_TWOSIDED
    from pupiloptixlab_tpu_torch.render import bsdf as bsdf_mod
    from pupiloptixlab_tpu_torch.render import emitter as emitter_mod
    from pupiloptixlab_tpu_torch.render import rng
    from pupiloptixlab_tpu_torch.render.camera import generate_rays, generate_rays_for
    from pupiloptixlab_tpu_torch.render.geometry import get_local_geometry
    from pupiloptixlab_tpu_torch.render.integrator import _block_pix, _use_blocks
    from pupiloptixlab_tpu_torch.render.sampling import (
        MAX_DISTANCE, RAY_OFFSET, is_zero, to_local, to_world,
    )

    w, h = config.width, config.height
    n = w * h
    dev = data.tris.packed.device
    if _use_blocks(config):
        pix = _block_pix(w, h, dev)
        state = rng.tea_init(pix, seed)
        state, (jx, jy) = rng.next_floats(state, 2)
        ro, rd = generate_rays_for(cam, w, h, pix, jx, jy)
    else:
        state = rng.tea_init(torch.arange(n, dtype=torch.int64, device=dev), seed)
        state, (jx, jy) = rng.next_floats(state, 2)
        ro, rd = generate_rays(cam, w, h, jx, jy)
    tmin = torch.full((n,), RAY_OFFSET, dtype=torch.float32, device=dev)
    tmax = torch.full((n,), MAX_DISTANCE, dtype=torch.float32, device=dev)
    primary = (ro, rd, tmin, tmax)

    hit = intersect_closest(ro, rd, tmin, tmax, data, config)
    geo = get_local_geometry(data, hit, ro, rd, config.sphere_count,
                             config.instanced, config.curve_count)
    local = bsdf_mod.get_local_bsdf(
        data.materials, data.textures, geo.mat_id, geo.uv, config.mat_types,
        config.mat_tex_kinds, config.mat_tex_filters,
    )
    active = hit.hit_mask
    state, _ = rng.next_float(state)  # the test AOV draw
    state, us = rng.next_floats(state, 7)
    _, u_sel, u_l1, u_l2, u_b0, u_b1, u_b2 = us
    wo_local = to_local(-rd, geo.normal)

    idx, use_env = emitter_mod.select_emitter(data.emitters, config, u_sel)
    es = emitter_mod.sample_direct(data.emitters, data.textures, config, idx,
                                   use_env, geo.position, geo.normal, u_l1, u_l2)
    shadow_ok = active & (geo.normal.dot(es.wi) > 0.0)
    shadow = (geo.position, es.wi, tmin,
              torch.where(shadow_ok, es.distance - RAY_OFFSET, -1.0))

    wi_s, f_s, pdf_s, _ = bsdf_mod.sample(local, wo_local, u_b0, u_b1, u_b2,
                                          config.mat_types)
    bounce_ok = active & ~(is_zero(f_s * torch.abs(wi_s.z)) | is_zero(pdf_s))
    bounce = (geo.position, to_world(wi_s, geo.normal), tmin,
              torch.where(bounce_ok, tmax, -1.0))

    def i32(t):
        return t.to(torch.int32).contiguous()

    mats = data.materials.packed
    gathers = {"tris.attrs": (data.tris.attrs, i32(hit.prim)),
               "materials.packed": (mats, i32(geo.mat_id)),
               "materials.twosided": (mats[:, MAT_TWOSIDED:MAT_TWOSIDED + 1].contiguous(),
                                      i32(geo.mat_id))}
    counts = {}
    if config.sphere_count:
        sph = data.spheres.attrs
        gathers["spheres.attrs"] = (sph, i32(hit.prim.clamp(max=sph.shape[0] - 1)))
    if config.emitter_count:
        em = data.emitters
        erow = gather_cols(em.packed, idx)
        gathers["emitters.packed"] = (em.packed, i32(idx))
        gathers["textures.packed"] = (data.textures.packed, i32(erow[EM_RAD_TEX]))
        counts["emitters.select_cdf"] = (
            em.select_cdf[:config.emitter_count].contiguous(), u_sel.contiguous())
    return {"primary": primary, "bounce": bounce, "shadow": shadow,
            "gathers": gathers, "counts": counts}


def planes_of(rays, lanes=None):
    ro, rd, tmin, tmax = rays
    ps = [ro.x, ro.y, ro.z, rd.x, rd.y, rd.z, tmin, tmax]
    ps = [p.expand(tmin.shape[0]) for p in ps]
    if lanes is not None:
        ps = [p[lanes] for p in ps]
    return [p.contiguous() for p in ps]


def pick_lanes(n: int, device):
    import torch

    gen = torch.Generator(device="cpu").manual_seed(0)
    return torch.randperm(n, generator=gen)[:SUBSET].to(device)


def check_gathers(scene, cases, k3, bound):
    """K3 on each (table, idx) of ``cases``: bit-equal to its plain version
    and to the one PyTorch call that computes the same planes, and timed
    beside both; the times and the bound are added to ``k3``'s sums."""
    import torch

    from pupiloptixlab_tpu_torch.accel import gather as ga

    for label, (table, idx) in cases.items():
        got = ga.gather_planes(table, idx)
        want = ga.gather_planes_plain(table, idx)
        exact = bool(torch.equal(got, want))
        err = float((got - want).abs().max())
        safe = idx.clamp(0, table.shape[0] - 1)  # index_select takes no stray index
        lib = table.index_select(0, safe).t().contiguous()
        require(bool(torch.equal(lib, want)), f"K3 {scene} {label}: index_select disagrees")
        ms = cuda_time_ms(lambda: ga.gather_planes(table, idx), reps=10)
        plain_ms = cuda_time_ms(lambda: ga.gather_planes_plain(table, idx), reps=10)
        lib_ms = cuda_time_ms(lambda: table.index_select(0, safe).t().contiguous(), reps=10)
        b_ms, by = bound.add(nbytes(table, idx, got), 0.0)
        log(f"  K3 {scene} {label} {tuple(table.shape)} N={idx.shape[0]}: bit-equal {exact}, "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, index_select+t {lib_ms:.3f} ms, "
            f"bound {b_ms:.4f} ms ({by})")
        require(exact, f"K3 {scene} {label}: kernel disagrees with table[idx].T")
        k3.setdefault("calls", {})[f"{scene} {label}"] = {
            "shape": list(table.shape), "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": by}
        k3["ms"] += ms
        k3["plain_ms"] += plain_ms
        k3["library_ms"] += lib_ms
        k3["max_abs_err"] = max(k3["max_abs_err"], err)
    k3.update(bound.fields())


def check_counts(scene, cases, k4, bound):
    """K4 on each (cdf, queries) of ``cases``: equal to the plain linear
    count and to torch.searchsorted (side='left' counts the entries
    strictly below), and timed beside both; sums go to ``k4``."""
    import torch

    from pupiloptixlab_tpu_torch.accel import gather as ga

    for label, (cdf, q) in cases.items():
        require(bool((cdf[1:] >= cdf[:-1]).all()), f"{scene} {label} must be nondecreasing")
        got = ga.count_less(cdf, q)
        want = ga.count_less_plain(cdf, q)
        err = int((got - want).abs().max())
        lib = torch.searchsorted(cdf, q).to(torch.int32)
        require(bool(torch.equal(lib, want)), f"K4 {scene} {label}: searchsorted disagrees")
        ms = cuda_time_ms(lambda: ga.count_less(cdf, q), reps=10)
        plain_ms = cuda_time_ms(lambda: ga.count_less_plain(cdf, q), reps=3)
        lib_ms = cuda_time_ms(lambda: torch.searchsorted(cdf, q), reps=10)
        steps = max(int(cdf.shape[0]).bit_length(), 1)  # compares of a binary search
        b_ms, by = bound.add(nbytes(cdf, q, got), q.shape[0] * steps)
        log(f"  K4 {scene} {label} {tuple(cdf.shape)} N={q.shape[0]}: max |diff| {err}, "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, searchsorted {lib_ms:.3f} ms, "
            f"bound {b_ms:.4f} ms ({by})")
        require(err == 0, f"K4 {scene} {label}: kernel disagrees with the linear count")
        k4.setdefault("calls", {})[f"{scene} {label}"] = {
            "shape": list(cdf.shape), "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": by}
        k4["ms"] += ms
        k4["plain_ms"] += plain_ms
        k4["library_ms"] += lib_ms
        k4["max_abs_err"] = max(k4["max_abs_err"], float(err))
    k4.update(bound.fields())


def phase_kernels(data, config, cam, results):
    import torch

    from pupiloptixlab_tpu_torch.accel import bvh_traverse as bt

    tris = data.tris
    tabs = (tris.packed, tris.bvh_child, tris.bvh_axis, tris.bvh_boxes)
    kw = dict(tcl=config.bvh_tcl, depth=tris.bvh_depth)
    rays = main_path_rays(data, config, cam)
    n = config.width * config.height
    lanes = pick_lanes(n, tris.packed.device)
    out = {}

    def live_of(planes):
        return int((planes[7] > planes[6]).sum())

    # K1 closest hit: primary + bounce rays
    k1 = {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0, "mismatches": 0, "hits": 0,
          "library_ms": None}
    k1_bound = Bound()
    for label in ("primary", "bounce"):
        full = planes_of(rays[label])
        t_k, i_k = bt.bvh_closest(*full, *tabs, **kw)
        sub = planes_of(rays[label], lanes)
        t_p, i_p = bt.plain_closest(*sub, tris.packed)
        t_ks, i_ks = t_k[lanes], i_k[lanes]
        mism = int((i_ks != i_p).sum())
        hit = i_p >= 0
        err = float((t_ks[hit] - t_p[hit]).abs().max()) if bool(hit.any()) else 0.0
        bit_t = bool(torch.equal(t_ks, t_p))
        log(f"  K1 {label}: {int(hit.sum())}/{lanes.numel()} hits, idx mismatches {mism}, "
            f"t bit-equal {bit_t}, max |dt| {err}")
        require(mism == 0 and bit_t, f"K1 {label}: kernel disagrees with the brute sweep")
        ms = cuda_time_ms(lambda: bt.bvh_closest(*full, *tabs, **kw), reps=5)
        plain_ms = host_time_ms(lambda: bt.plain_closest(*full, tris.packed))
        bound, by = k1_bound.add(
            nbytes(*full, *tabs, t_k, i_k),
            live_of(full) * 8 * SLAB_FLOPS
            + int((i_k >= 0).sum()) * config.bvh_tcl * MT_FLOPS_CLOSEST)
        log(f"  K1 {label}: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
            f"bound {bound:.4f} ms ({by}) at N={n}")
        k1[f"{label}_bound_by"] = by
        k1[f"{label}_ms"] = ms
        k1[f"{label}_plain_ms"] = plain_ms
        k1[f"{label}_bound_ms"] = bound
        k1["ms"] += ms
        k1["plain_ms"] += plain_ms
        k1["max_abs_err"] = max(k1["max_abs_err"], err)
        k1["mismatches"] += mism
        k1["hits"] += int(hit.sum())
    k1.update(k1_bound.fields())
    out["bvh_closest"] = k1

    # K2 any hit: shadow rays (and bounce rays, whose occlusion = closest hit)
    k2 = {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0, "mismatches": 0,
          "library_ms": None}
    k2_bound = Bound()
    for label in ("shadow", "bounce"):
        full = planes_of(rays[label])
        occ_k = bt.bvh_anyhit(*full, *tabs, **kw)
        sub = planes_of(rays[label], lanes)
        occ_p = bt.plain_anyhit(*sub, tris.packed)
        mism = int((occ_k[lanes] != occ_p).sum())
        log(f"  K2 {label}: {int(occ_p.sum())}/{lanes.numel()} occluded, mismatches {mism}")
        require(mism == 0, f"K2 {label}: kernel disagrees with the brute sweep")
        if label == "shadow":
            k2["ms"] = cuda_time_ms(lambda: bt.bvh_anyhit(*full, *tabs, **kw), reps=5)
            k2["plain_ms"] = host_time_ms(lambda: bt.plain_anyhit(*full, tris.packed))
            bound, by = k2_bound.add(
                nbytes(*full, *tabs, occ_k),
                live_of(full) * 8 * SLAB_FLOPS + int(occ_k.sum()) * MT_FLOPS_ANY)
            log(f"  K2 shadow: kernel {k2['ms']:.3f} ms, plain {k2['plain_ms']:.1f} ms, "
                f"bound {bound:.4f} ms ({by}) at N={n}")
        k2["mismatches"] += mism
        k2["max_abs_err"] = max(k2["max_abs_err"], float(mism > 0))
    k2.update(k2_bound.fields())
    out["bvh_anyhit"] = k2

    # K3 gather into planes: attrs at the primary hit rows, env column CDF
    # rows, texel pool (bilinear-quad pool too), all bit-exact; beside each,
    # the one PyTorch call that computes the same planes
    dev = tris.packed.device
    g = torch.Generator(device=dev).manual_seed(1)
    _, i_prim = bt.bvh_closest(*planes_of(rays["primary"]), *tabs, **kw)
    em, tex = data.emitters, data.textures
    cases = {
        "attrs": (tris.attrs, i_prim),
        "env_col_cdf": (em.env_col_cdf, torch.randint(
            -3, em.env_col_cdf.shape[0] + 3, (n,), generator=g, device=dev,
            dtype=torch.int32)),
        "pool": (tex.pool, torch.randint(0, tex.pool.shape[0], (n,), generator=g,
                                         device=dev, dtype=torch.int32)),
        "pool_bi": (tex.pool_bi, torch.randint(0, tex.pool_bi.shape[0], (n,),
                                               generator=g, device=dev,
                                               dtype=torch.int32)),
    }
    k3 = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "max_abs_err": 0.0}
    k3_bound = Bound()
    check_gathers("mesh_env", cases, k3, k3_bound)
    out["gather_planes"] = k3

    # K4 count below the env row CDF (flat runs where env rows are black)
    cdf = em.env_row_cdf
    q = torch.rand(n, generator=g, device=dev)
    q[:cdf.shape[0]] = cdf  # exact table values: side='left' semantics
    k4 = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "max_abs_err": 0.0}
    k4_bound = Bound()
    check_counts("mesh_env", {"env_row_cdf": (cdf, q)}, k4, k4_bound)
    out["count_less"] = k4
    results["kernels"] = out
    return {"gather_planes": k3_bound, "count_less": k4_bound}


def phase_frame(data, config, cam, results):
    import torch

    from pupiloptixlab_tpu_torch import kernels
    from pupiloptixlab_tpu_torch.render.integrator import render_frame

    n = config.width * config.height
    accum = torch.zeros((n, 3), dtype=torch.float32, device="cuda")
    iters = 2
    torch.cuda.synchronize()
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    render_frame(data, cam, 0, 0, accum, config)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for i in range(iters):
        _, bufs = render_frame(data, cam, i + 1, i + 1, accum, config)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    launches = dict(kernels.LAUNCHES)
    rays = n * (1 + 2 * (config.max_depth - 1))
    frame = bufs["frame"]
    finite = bool(torch.isfinite(frame).all())
    mean = float(frame.mean())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  1920x1080 depth {config.max_depth}: warm-up {warm_ms:.1f} ms, "
        f"{dt * 1e3:.2f} ms/frame, {rays / dt / 1e6:.2f} Mray/s, mean {mean:.5f}, "
        f"peak {peak_gb:.2f} GB, launches over {1 + iters} frames {launches}")
    require(finite and mean > 0.0, "frame is not finite and non-zero")
    path = ("bvh_closest", "bvh_anyhit", "gather_planes", "count_less")
    require(all(launches[k] > 0 for k in path),
            f"a kernel of the BVH path was not launched: {launches}")
    results["frame"] = {"ms_per_frame": dt * 1e3, "mrays_per_s": rays / dt / 1e6,
                        "warmup_ms": warm_ms, "mean": mean, "peak_gb": peak_gb,
                        "rays_per_frame": rays, "frames": 1 + iters,
                        "launches": launches}
    return launches


def make_soup(rows: int, device):
    """A seeded triangle soup inside oracle_mat's stage (so that the scene's
    rays cross it): ``rows`` table rows, the last 5 left as all-zero padding,
    sorted along x so that chunks are compact; returns (tri (rows, 12),
    chunk boxes (rows / 64, 8)) built as the flatten builds them."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(rows)
    valid = rows - 5
    lo = torch.tensor([-4.0, 0.0, -2.5])
    hi = torch.tensor([4.0, 2.0, 3.0])
    p0 = lo + (hi - lo) * torch.rand((valid, 3), generator=g)
    p0 = p0[torch.argsort(p0[:, 0])]
    e1 = (torch.rand((valid, 3), generator=g) - 0.5) * 0.6
    e2 = (torch.rand((valid, 3), generator=g) - 0.5) * 0.6
    tri = torch.zeros((rows, 12))
    tri[:valid, 0:3], tri[:valid, 3:6], tri[:valid, 6:9] = p0, e1, e2
    verts = torch.stack([p0, p0 + e1, p0 + e2])  # (3, valid, 3)
    v_lo = torch.full((rows, 3), 1e30)
    v_hi = torch.full((rows, 3), -1e30)
    v_lo[:valid], v_hi[:valid] = verts.amin(0), verts.amax(0)
    boxes = torch.zeros((rows // 64, 8))
    boxes[:, 0:3] = v_lo.reshape(-1, 64, 3).amin(1)
    boxes[:, 3:6] = v_hi.reshape(-1, 64, 3).amax(1)
    return tri.to(device), boxes.to(device)


def check_sweeps(case, tri, boxes, rays, lanes, plain_full, summed, k5, k6, bounds,
                 details):
    """K5 and K6 on one table: exact against the plain versions on the lane
    subset, timed at full N; the plain versions are timed at full N for the
    ray sets named in ``plain_full``, and with ``summed`` (a main path's
    own table) those calls enter the sums of ``k5`` / ``k6`` (kernel, plain
    and bound over the same work)."""
    import torch

    from pupiloptixlab_tpu_torch.accel import sweep as sw

    n = rays["primary"][2].shape[0]
    n_chunks = tri.shape[0] // sw.CHUNK
    n_groups = sw.group_count(n_chunks)
    culled = n_groups > 1
    sboxes = sw.super_boxes(boxes)  # once per table, as the flatten builds them
    tables = (tri, boxes, sboxes) if culled else (tri,)
    out = {"rows": tri.shape[0], "chunks": n_chunks, "groups": n_groups}
    for label in ("primary", "bounce"):
        full = planes_of(rays[label])
        t_k, i_k = sw.sweep_closest(*full, tri, boxes, sboxes)
        sub = planes_of(rays[label], lanes)
        t_p, i_p = sw.plain_sweep_closest(*sub, tri, boxes)
        t_ks, i_ks = t_k[lanes], i_k[lanes]
        mism = int((i_ks != i_p).sum())
        bit_t = bool(torch.equal(t_ks, t_p))
        hits = int((i_p >= 0).sum())
        err = float((t_ks - t_p).abs().max())
        ms = cuda_time_ms(lambda: sw.sweep_closest(*full, tri, boxes, sboxes), reps=3)
        live = int((full[7] > full[6]).sum())
        flops = (live * n_groups * SLAB_FLOPS
                 + int((i_k >= 0).sum()) * sw.CHUNK * MT_FLOPS_CLOSEST
                 if culled else live * tri.shape[0] * MT_FLOPS_CLOSEST)
        n_bytes = nbytes(*full, *tables, t_k, i_k)
        rec = {"ms": ms, "hits": hits, "mismatches": mism, "t_bit_equal": bit_t}
        msg = (f"  K5 {case} {label}: {hits}/{lanes.numel()} hits, row mismatches {mism}, "
               f"t bit-equal {bit_t}; kernel {ms:.3f} ms")
        if label in plain_full:
            rec["plain_ms"] = host_time_ms(
                lambda: sw.plain_sweep_closest(*full, tri, boxes))
            rec["bound_ms"], rec["bound_by"] = (
                bounds["sweep_closest"] if summed else Bound()).add(n_bytes, flops)
            if summed:
                k5["ms"] += ms
                k5["plain_ms"] += rec["plain_ms"]
            msg += (f", plain {rec['plain_ms']:.1f} ms, bound {rec['bound_ms']:.4f} ms "
                    f"({rec['bound_by']})")
        log(msg + f" at N={n}")
        require(mism == 0 and bit_t, f"K5 {case} {label}: kernel disagrees with its plain version")
        k5["max_abs_err"] = max(k5["max_abs_err"], err)
        k5["mismatches"] += mism
        out[f"closest_{label}"] = rec
    for label in ("shadow", "bounce"):
        full = planes_of(rays[label])
        occ_k = sw.sweep_anyhit(*full, tri, boxes, sboxes)
        sub = planes_of(rays[label], lanes)
        occ_p = sw.plain_sweep_anyhit(*sub, tri, boxes)
        mism = int((occ_k[lanes] != occ_p).sum())
        ms = cuda_time_ms(lambda: sw.sweep_anyhit(*full, tri, boxes, sboxes), reps=3)
        live = int((full[7] > full[6]).sum())
        occluded = int(occ_k.sum())
        flops = (live * n_groups * SLAB_FLOPS + occluded * MT_FLOPS_ANY
                 if culled else
                 ((live - occluded) * tri.shape[0] + occluded) * MT_FLOPS_ANY)
        n_bytes = nbytes(*full, *tables, occ_k)
        rec = {"ms": ms, "occluded": int(occ_p.sum()), "mismatches": mism}
        msg = (f"  K6 {case} {label}: {int(occ_p.sum())}/{lanes.numel()} occluded, "
               f"mismatches {mism}; kernel {ms:.3f} ms")
        if label in plain_full:
            rec["plain_ms"] = host_time_ms(
                lambda: sw.plain_sweep_anyhit(*full, tri, boxes))
            rec["bound_ms"], rec["bound_by"] = (
                bounds["sweep_anyhit"] if summed else Bound()).add(n_bytes, flops)
            if summed:
                k6["ms"] += ms
                k6["plain_ms"] += rec["plain_ms"]
            msg += (f", plain {rec['plain_ms']:.1f} ms, bound {rec['bound_ms']:.4f} ms "
                    f"({rec['bound_by']})")
        log(msg + f" at N={n}")
        require(mism == 0, f"K6 {case} {label}: kernel disagrees with its plain version")
        k6["max_abs_err"] = max(k6["max_abs_err"], float(mism > 0))
        k6["mismatches"] += mism
        out[f"anyhit_{label}"] = rec
    details[case] = out


def phase_sweep(mesh_bvh, bounds, results):
    """Phase 5; ``mesh_bvh`` = mesh_env's BVH tables and config at 1080p,
    for K1 on the same rays; ``bounds`` = K3's and K4's running bounds from
    phase 3, which the oracle_mat calls add to."""
    import torch

    from pupiloptixlab_tpu_torch.accel import bvh_traverse as bt
    from pupiloptixlab_tpu_torch.accel import sweep as sw

    k5 = {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0, "mismatches": 0,
          "library_ms": None}
    k6 = dict(k5)
    bounds = {**bounds, "sweep_closest": Bound(), "sweep_anyhit": Bound()}
    details: dict = {}

    # (a) oracle_mat's own table: one 64-row chunk, no box read
    data, config, cam = load_tables(ORACLE_MAT, 1920, 1080, "cuda")
    require(config.bvh_nodes == 0 and data.tris.packed.shape[0] == 64,
            "oracle_mat must flatten to one 64-row chunk without a BVH")
    n = config.width * config.height
    lanes = pick_lanes(n, data.tris.packed.device)
    rays_mat = main_path_rays(data, config, cam)
    # K3 and K4 at the shapes this path gives them: its own tables at the
    # first bounce's indices, its emitter-select CDF at the first draws
    require(len(rays_mat["gathers"]) == 6 and len(rays_mat["counts"]) == 1,
            "oracle_mat must gather from triangles, spheres, materials, emitters and "
            "textures and select among area emitters")
    check_gathers("oracle_mat", rays_mat["gathers"], results["kernels"]["gather_planes"],
                  bounds["gather_planes"])
    check_counts("oracle_mat", rays_mat["counts"], results["kernels"]["count_less"],
                 bounds["count_less"])
    check_sweeps("oracle_mat", data.tris.packed, data.tris.chunk_boxes, rays_mat, lanes,
                 ("primary", "bounce", "shadow"), True, k5, k6, bounds, details)

    # (c) soups in oracle_mat's stage under oracle_mat's rays: 2 chunks (the
    # reference's _kernel_grid), 8 chunks (unrolled, no culling), 40 chunks
    # (2 super-boxes, culled)
    for rows in (128, 512, 2560):
        tri, boxes = make_soup(rows, data.tris.packed.device)
        check_sweeps(f"soup_{rows}", tri, boxes, rays_mat, lanes, ("primary",), False,
                     k5, k6, bounds, details)
    del data, rays_mat

    # (b) mesh_env flattened under PUPIL_NO_BVH: 321 chunks, 11 super-boxes
    data, config, cam = load_tables(MESH_ENV, 1920, 1080, "cuda", no_bvh=True)
    tris = data.tris
    require(config.bvh_nodes == 0 and tris.chunk_boxes.shape[0] == 321,
            f"mesh_env under PUPIL_NO_BVH: {config.bvh_nodes} nodes, "
            f"{tris.chunk_boxes.shape[0]} chunks")
    rays = main_path_rays(data, config, cam)
    check_sweeps("mesh_env_nobvh", tris.packed, tris.chunk_boxes, rays, lanes,
                 ("primary", "shadow"), True, k5, k6, bounds, details)
    # K5 against K1 at full N on the same rays. The two tables hold the same
    # triangles in another row order, so rows are compared by their content.
    bvh_data, bvh_config = mesh_bvh
    bt_tabs = (bvh_data.tris.packed, bvh_data.tris.bvh_child, bvh_data.tris.bvh_axis,
               bvh_data.tris.bvh_boxes)
    for label in ("primary", "bounce"):
        full = planes_of(rays[label])
        t5, i5 = sw.sweep_closest(*full, tris.packed, tris.chunk_boxes, tris.super_boxes)
        t1, i1 = bt.bvh_closest(*full, *bt_tabs, tcl=bvh_config.bvh_tcl,
                                depth=bvh_data.tris.bvh_depth)
        bit_t = bool(torch.equal(t5, t1))
        hit = i5 >= 0
        same_hits = bool(torch.equal(hit, i1 >= 0))
        rows5 = tris.packed[i5[hit].long()]
        rows1 = bvh_data.tris.packed[i1[hit].long()]
        other_tri = int((rows5 != rows1).any(dim=1).sum())
        log(f"  K5 vs K1 mesh_env {label}: {int(hit.sum())}/{full[0].shape[0]} hits, "
            f"t bit-equal {bit_t}, hit lanes equal {same_hits}, lanes on another "
            f"triangle at the same t {other_tri}")
        require(bit_t and same_hits, f"K5 disagrees with K1 on mesh_env {label} rays")
        details["mesh_env_nobvh"][f"vs_k1_{label}"] = {
            "t_bit_equal": bit_t, "hits": int(hit.sum()), "tied_other_triangle": other_tri}
    k5.update(bounds["sweep_closest"].fields())
    k6.update(bounds["sweep_anyhit"].fields())
    results["kernels"]["sweep_closest"] = k5
    results["kernels"]["sweep_anyhit"] = k6
    results["sweep"] = details


SYSTEM_PATH = ("sweep_closest", "sweep_anyhit", "gather_planes", "count_less")


def phase_system(label, xml, warm, iters, no_bvh, tmp, results):
    """System + PTPass as a user drives them, on the default device."""
    import torch

    from pupiloptixlab_tpu_torch import kernels
    from pupiloptixlab_tpu_torch.passes import PTPass
    from pupiloptixlab_tpu_torch.system import System

    system = System()
    pt = PTPass()
    system.add_pass(pt)
    t0 = time.perf_counter()
    with pupil_no_bvh(no_bvh):
        require(system.set_scene(scene_copy(xml, 1920, 1080, tmp)),
                f"{label}: set_scene failed")
    load_s = time.perf_counter() - t0
    config = pt._config
    require(str(system.device).startswith("cuda") and config.bvh_nodes == 0
            and (config.width, config.height, config.max_depth) == (1920, 1080, 4),
            f"{label}: expected the chunk-sweep route at 1920x1080 depth 4 on the card")
    n = config.width * config.height
    torch.cuda.synchronize()
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    system.run(max_frames=warm)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    system.run(max_frames=iters)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / iters
    launches = dict(kernels.LAUNCHES)
    rays = n * (1 + 2 * (config.max_depth - 1))
    frame = system.buffers["pt frame"].array
    finite = bool(torch.isfinite(frame).all())
    mean = float(frame.mean())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    frames = warm + iters
    table_rows = system.world.get_scene_data()[0].tris.packed.shape[0]
    log(f"  {label}: {config.tri_count} tris in {table_rows} "
        f"rows, {config.sphere_count} spheres, set_scene {load_s:.2f} s, warm-up "
        f"{warm_ms:.1f} ms, {dt * 1e3:.2f} ms/frame, {rays / dt / 1e6:.2f} Mray/s, "
        f"mean {mean:.5f}, peak {peak_gb:.2f} GB, launches over {frames} frames {launches}")
    require(pt.sample_cnt == frames and pt.seed == frames,
            f"{label}: sample_cnt {pt.sample_cnt}, seed {pt.seed} after {frames} frames")
    require(tuple(frame.shape) == (n, 3) and finite and mean > 0.0,
            f"{label}: frame is not finite and non-zero")
    require(all(launches[k] > 0 for k in SYSTEM_PATH)
            and launches["bvh_closest"] == 0 and launches["bvh_anyhit"] == 0,
            f"{label}: the chunk-sweep path must launch K5, K6, K3, K4 and no "
            f"traversal kernel: {launches}")
    system.destroy()
    results.setdefault("system", {})[label] = {
        "ms_per_frame": dt * 1e3, "mrays_per_s": rays / dt / 1e6, "warmup_ms": warm_ms,
        "set_scene_s": load_s, "mean": mean, "peak_gb": peak_gb, "rays_per_frame": rays,
        "frames": frames, "launches": launches}
    return launches


def compare_frames(label, card, cpu, worst):
    """Phase 7's limits on one pair of buffer sets (card, CPU)."""
    import numpy as np

    a, b = card["frame"], cpu["frame"]
    rel = float(np.mean((a - b) ** 2) / max(np.mean(b ** 2), 1e-30))
    frac = float(np.isclose(a, b, rtol=1e-4, atol=0.0).all(-1).mean())
    test_eq = bool(np.array_equal(card["test"], cpu["test"]))
    nmax = float(np.abs(card["normal"] - cpu["normal"]).max())
    amax = float(np.abs(card["albedo"] - cpu["albedo"]).max())
    log(f"  {label}: rel MSE {rel:.3e}, pixels within rtol 1e-4 {frac:.4f}, "
        f"test AOV equal {test_eq}, |d normal| {nmax:.2e}, |d albedo| {amax:.2e}")
    require(rel <= 1e-5 and frac >= 0.99 and test_eq,
            f"card and CPU frames disagree: {label}")
    worst["rel_mse"] = max(worst["rel_mse"], rel)
    worst["frac_within_1e-4"] = min(worst["frac_within_1e-4"], frac)
    worst["normal_max"] = max(worst["normal_max"], nmax)
    worst["albedo_max"] = max(worst["albedo_max"], amax)


def phase_parity(results):
    import numpy as np
    import torch

    from pupiloptixlab_tpu_torch.passes import PTPass
    from pupiloptixlab_tpu_torch.render.integrator import render_frame
    from pupiloptixlab_tpu_torch.system import System

    def frames_of(dev, no_bvh=False):
        data, config, cam = load_tables(MESH_ENV, 128, 8, dev, no_bvh=no_bvh)
        n = config.width * config.height
        accum = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        seq = []
        for i in range(4):
            _, bufs = render_frame(data, cam, i, i, accum, config)
            seq.append({k: v.cpu().numpy().copy() for k, v in bufs.items()})
        return seq

    def new_worst():
        return {"rel_mse": 0.0, "frac_within_1e-4": 1.0, "normal_max": 0.0,
                "albedo_max": 0.0}

    card, cpu = frames_of("cuda"), frames_of("cpu")
    worst = new_worst()
    for i, (g, c) in enumerate(zip(card, cpu)):
        compare_frames(f"mesh_env 128x8 seed {i}", g, c, worst)
    results["parity"] = worst

    # the BVH route against the brute chunk sweep at equal seeds, both on the card
    sweep = frames_of("cuda", no_bvh=True)
    rels = []
    for i, (g, c) in enumerate(zip(card, sweep)):
        a, b = g["frame"], c["frame"]
        rels.append(float(np.mean((a - b) ** 2) / max(np.mean(b ** 2), 1e-30)))
        equal = all(np.array_equal(g[k], c[k]) for k in g)
        log(f"  mesh_env 128x8 seed {i}, BVH vs PUPIL_NO_BVH on the card: rel MSE "
            f"{rels[-1]:.3e}, all buffers bit-equal {equal}")
        require(rels[-1] <= 1e-5, f"BVH and chunk-sweep frames disagree at seed {i}")
    results["parity_bvh_vs_sweep_rel_mse"] = max(rels)

    # oracle_mat at its own 64x64 film through System, card against CPU
    names = ("pt frame", "pt albedo", "pt normal", "pt test")
    seqs = {}
    for dev in ("cuda", "cpu"):
        system = System(device=dev)
        system.add_pass(PTPass())
        require(system.set_scene(ORACLE_MAT), "oracle_mat: set_scene failed")
        seq = []
        for _ in range(4):
            system.run(max_frames=1)
            seq.append({k.split()[1]: system.buffers[k].array.cpu().numpy().copy()
                        for k in names})
        system.destroy()
        seqs[dev] = seq
    worst = new_worst()
    for i, (g, c) in enumerate(zip(seqs["cuda"], seqs["cpu"])):
        compare_frames(f"oracle_mat 64x64 through System, seed {i}", g, c, worst)
    results["parity_system_oracle_mat"] = worst


def phase_oracle(results):
    import numpy as np
    import torch

    from pupiloptixlab_tpu_torch.render.integrator import render
    from pupiloptixlab_tpu_torch.utils.image import read_exr

    spp = 512
    limits = {"mesh_env": (MESH_ENV, 0.02, 1.5e-2, None),
              "oracle_mat": (ORACLE_MAT, 0.01, 4e-3, 1e-3)}
    out = {}
    for name, (xml, ratio_tol, mse_tol, box_tol) in limits.items():
        data, config, cam = load_tables(xml, 64, 64, "cuda")
        t0 = time.perf_counter()
        img = render(data, cam, config, spp=spp).cpu().numpy()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        oracle = read_exr(ORACLE_EXR[name])[::-1][..., :3]
        mean_ratio = float(img.mean() / oracle.mean())
        rel_mse = float(np.mean((img - oracle) ** 2) / np.mean(oracle ** 2))

        def box(a):
            return a.reshape(16, 4, 16, 4, 3).mean((1, 3))

        box_rel = float(np.mean((box(img) - box(oracle)) ** 2) / np.mean(box(oracle) ** 2))
        log(f"  {name} 64x64 {spp} spp in {secs:.1f} s: mean ratio {mean_ratio:.5f}, "
            f"rel MSE {rel_mse:.5e}, 4x4-box rel MSE {box_rel:.5e}")
        require(np.isfinite(img).all(), f"{name}: oracle render is not finite")
        require(abs(mean_ratio - 1.0) < ratio_tol and rel_mse < mse_tol
                and (box_tol is None or box_rel < box_tol),
                f"{name} oracle gate failed (mean ratio within {ratio_tol}, rel MSE < "
                f"{mse_tol}, box rel MSE < {box_tol})")
        out[name] = {"mean_ratio": mean_ratio, "rel_mse": rel_mse, "box_rel_mse": box_rel,
                     "spp": spp, "seconds": secs}
    results["oracle"] = out


def main() -> int:
    if not (REPO / "pupiloptixlab_tpu_torch").is_dir():
        print("chip_smoke.py: the pupiloptixlab_tpu_torch package is not beside "
              "this script; run it from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available; this smoke run needs one NVIDIA "
              "GPU", file=sys.stderr)
        return 3
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {kind} x{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    log(f"[device] nvidia-smi: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results: dict = {"device": kind, "nvidia_smi": smi}
    t_all = time.perf_counter()

    from pupiloptixlab_tpu_torch import kernels, native

    log("[build] nvcc, one process per source")
    kernels.build_all()
    log(f"[build] {kernels.BUILD_SECONDS:.1f} s")
    for stem, text in kernels.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {stem}: {line.strip()}")
    results["build_seconds"] = kernels.BUILD_SECONDS
    results["host_runtime"] = "C++" if native.available() else "numpy"
    log(f"[build] host BVH build and OBJ parser: {results['host_runtime']}")

    t0 = time.perf_counter()
    data, config, cam = load_tables(MESH_ENV, 1920, 1080, "cuda")
    log(f"[flatten] mesh_env on cuda in {time.perf_counter() - t0:.2f} s: "
        f"{config.tri_count} tris, {config.bvh_nodes} nodes, tcl {config.bvh_tcl}, "
        f"depth {data.tris.bvh_depth}")
    with torch.inference_mode():
        log("[kernels] K1-K4, each against its plain version")
        bounds = phase_kernels(data, config, cam, results)
        log("[frame] mesh_env BVH route, render_frame, 1 warm-up + 2 timed")
        launches = phase_frame(data, config, cam, results)
        log("[sweep] K3, K4 on oracle_mat's tables; K5 and K6, each against its plain version")
        phase_sweep((data, config), bounds, results)
    del data
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        log("[system] System + PTPass at 1920x1080, depth 4")
        runs = {"mesh_env_bvh": launches}
        runs["oracle_mat"] = phase_system("oracle_mat", ORACLE_MAT, 1, 4, False,
                                          Path(tmp), results)
        torch.cuda.empty_cache()
        runs["mesh_env_nobvh"] = phase_system("mesh_env_nobvh", MESH_ENV, 1, 2, True,
                                              Path(tmp), results)
    torch.cuda.empty_cache()
    log("[parity] card vs CPU, BVH vs chunk sweep")
    phase_parity(results)
    log("[oracle] 64x64 renders against the brute-force oracles")
    phase_oracle(results)

    foreign = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "pupiloptixlab_tpu" or m.startswith("pupiloptixlab_tpu."))
    require(not foreign, f"the port imported {foreign}")
    log("[no-jax] neither jax nor the JAX package was imported")
    results["seconds"] = time.perf_counter() - t_all
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(results, indent=1))

    # each kernel's launches over the runs of the main paths it is on (each
    # run had the counts set to 0 just before and read just after): the
    # paths whose shapes its ms, plain_ms and bound_ms were taken at
    line = []
    for name, (source, replaces) in KERNEL_META.items():
        k = results["kernels"][name]
        by_path = {path: runs[path][name] for path in PATHS_OF[name]}
        require(all(v > 0 for v in by_path.values()),
                f"{name} was not launched on a path it is counted on: {by_path}")
        line.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"],
        })
    print(json.dumps({"kernels": line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
