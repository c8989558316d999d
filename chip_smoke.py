#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each fails the run on its first fault; nothing is caught):
  1. device   require CUDA; print the card's name and power limit
  2. build    nvcc-build the CUDA kernels from csrc/ (pupiloptixlab_tpu_torch/_build/)
  3. kernels  each kernel against its plain PyTorch version on data/mesh_env.xml
              at the main path's shapes (1920x1080 = 2,073,600 rays): the
              traversal kernels (K1 closest, K2 any hit) on primary, bounce
              and shadow rays, exact against the brute-force sweep on a
              65,536-ray subset and timed at full N; the gather (K3) on the
              triangle attributes, the env column CDF and the texel pool,
              and the CDF count (K4) on the env row CDF, both bit-exact
  4. frame    render_frame at 1920x1080, depth 4: 1 warm-up + 4 timed frames,
              with every kernel's launch counter reset just before and read
              just after; fails unless each kernel launched
  5. parity   a 128x8 film at seeds 0-3 on the card (kernels) and on the CPU
              (plain versions): frame rel MSE <= 1e-5, >= 99% of pixels within
              rtol 1e-4, the RNG test AOV bit-equal
  6. oracle   render() at 64x64, 512 spp against tests/data/oracle_mesh_env_64.exr:
              mean ratio within 0.02, rel MSE < 1.5e-2
  7. no-jax   'jax' must not be in sys.modules

Output: progress lines, then a {"kernels": [...]} JSON line, the
``nvidia-smi --query-gpu=name,power.limit`` line, and as the last line
{"ok": true, "device": {...}}. Details also go to chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SCENE = REPO / "data" / "mesh_env.xml"
ORACLE = REPO / "tests" / "data" / "oracle_mesh_env_64.exr"
SUBSET = 65536

KERNEL_META = {
    "bvh_closest": ("pupiloptixlab_tpu_torch/csrc/bvh_traverse.cu",
                    "pupiloptixlab_tpu/accel/pallas_bvh.py:298"),
    "bvh_anyhit": ("pupiloptixlab_tpu_torch/csrc/bvh_traverse.cu",
                   "pupiloptixlab_tpu/accel/pallas_bvh.py:747"),
    "gather_planes": ("pupiloptixlab_tpu_torch/csrc/gather.cu",
                      "pupiloptixlab_tpu/accel/gather.py:44"),
    "count_less": ("pupiloptixlab_tpu_torch/csrc/gather.cu",
                   "pupiloptixlab_tpu/accel/gather.py:194"),
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


def load_mesh_env(width: int, height: int, device):
    from pupiloptixlab_tpu.scene import load_scene
    from pupiloptixlab_tpu_torch.flatten import camera_block_from_scene, flatten_scene

    scene = load_scene(SCENE)
    scene.sensor.film.w, scene.sensor.film.h = width, height
    data, config = flatten_scene(scene, device=device)
    return data, config, camera_block_from_scene(scene, device=device)


def main_path_rays(data, config, cam, seed: int = 0):
    """Primary, first-bounce and first NEE shadow rays exactly as the
    frame builds them (render_sample + the first _bounce)."""
    import torch

    from pupiloptixlab_tpu_torch.accel.intersect import intersect_closest
    from pupiloptixlab_tpu_torch.render import bsdf as bsdf_mod
    from pupiloptixlab_tpu_torch.render import emitter as emitter_mod
    from pupiloptixlab_tpu_torch.render import rng
    from pupiloptixlab_tpu_torch.render.camera import generate_rays_for
    from pupiloptixlab_tpu_torch.render.geometry import get_local_geometry
    from pupiloptixlab_tpu_torch.render.integrator import _block_pix
    from pupiloptixlab_tpu_torch.render.sampling import (
        MAX_DISTANCE, RAY_OFFSET, is_zero, to_local, to_world,
    )

    w, h = config.width, config.height
    n = w * h
    dev = data.tris.packed.device
    pix = _block_pix(w, h, dev)
    state = rng.tea_init(pix, seed)
    state, (jx, jy) = rng.next_floats(state, 2)
    ro, rd = generate_rays_for(cam, w, h, pix, jx, jy)
    tmin = torch.full((n,), RAY_OFFSET, dtype=torch.float32, device=dev)
    tmax = torch.full((n,), MAX_DISTANCE, dtype=torch.float32, device=dev)
    primary = (ro, rd, tmin, tmax)

    hit = intersect_closest(ro, rd, tmin, tmax, data, config)
    geo = get_local_geometry(data, hit, ro, rd, config.sphere_count, False,
                             config.curve_count)
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
    return {"primary": primary, "bounce": bounce, "shadow": shadow}


def planes_of(rays, lanes=None):
    ro, rd, tmin, tmax = rays
    ps = [ro.x, ro.y, ro.z, rd.x, rd.y, rd.z, tmin, tmax]
    ps = [p.expand(tmin.shape[0]) for p in ps]
    if lanes is not None:
        ps = [p[lanes] for p in ps]
    return [p.contiguous() for p in ps]


def phase_kernels(data, config, cam, results):
    import torch

    from pupiloptixlab_tpu_torch.accel import bvh_traverse as bt
    from pupiloptixlab_tpu_torch.accel import gather as ga

    tris = data.tris
    tabs = (tris.packed, tris.bvh_child, tris.bvh_axis, tris.bvh_boxes)
    kw = dict(tcl=config.bvh_tcl, depth=tris.bvh_depth)
    rays = main_path_rays(data, config, cam)
    n = config.width * config.height
    gen = torch.Generator(device="cpu").manual_seed(0)
    lanes = torch.randperm(n, generator=gen)[:SUBSET].to(tris.packed.device)
    out = {}

    # K1 closest hit: primary + bounce rays
    k1 = {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0, "mismatches": 0, "hits": 0}
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
        t0 = time.perf_counter()
        bt.plain_closest(*full, tris.packed)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        log(f"  K1 {label}: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms at N={n}")
        k1[f"{label}_ms"] = ms
        k1[f"{label}_plain_ms"] = plain_ms
        k1["ms"] += ms
        k1["plain_ms"] += plain_ms
        k1["max_abs_err"] = max(k1["max_abs_err"], err)
        k1["mismatches"] += mism
        k1["hits"] += int(hit.sum())
    out["bvh_closest"] = k1

    # K2 any hit: shadow rays (and bounce rays, whose occlusion = closest hit)
    k2 = {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0, "mismatches": 0}
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
            t0 = time.perf_counter()
            bt.plain_anyhit(*full, tris.packed)
            torch.cuda.synchronize()
            k2["plain_ms"] = (time.perf_counter() - t0) * 1e3
            log(f"  K2 shadow: kernel {k2['ms']:.3f} ms, plain {k2['plain_ms']:.1f} ms at N={n}")
        k2["mismatches"] += mism
        k2["max_abs_err"] = max(k2["max_abs_err"], float(mism > 0))
    out["bvh_anyhit"] = k2

    # K3 gather into planes: attrs at the primary hit rows, env column CDF
    # rows, texel pool (bilinear-quad pool too), all bit-exact
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
    k3 = {"ms": 0.0, "plain_ms": 0.0, "max_abs_err": 0.0}
    for label, (table, idx) in cases.items():
        got = ga.gather_planes(table, idx)
        want = ga.gather_planes_plain(table, idx)
        exact = bool(torch.equal(got, want))
        err = float((got - want).abs().max())
        ms = cuda_time_ms(lambda: ga.gather_planes(table, idx), reps=10)
        plain_ms = cuda_time_ms(lambda: ga.gather_planes_plain(table, idx), reps=10)
        log(f"  K3 {label} {tuple(table.shape)}: bit-equal {exact}, kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms")
        require(exact, f"K3 {label}: kernel disagrees with table[idx].T")
        k3[f"{label}_ms"], k3[f"{label}_plain_ms"] = ms, plain_ms
        k3["ms"] += ms
        k3["plain_ms"] += plain_ms
        k3["max_abs_err"] = max(k3["max_abs_err"], err)
    out["gather_planes"] = k3

    # K4 count below the env row CDF (flat runs where env rows are black)
    cdf = em.env_row_cdf
    require(bool((cdf[1:] >= cdf[:-1]).all()), "env_row_cdf must be nondecreasing")
    q = torch.rand(n, generator=g, device=dev)
    q[:cdf.shape[0]] = cdf  # exact table values: side='left' semantics
    got = ga.count_less(cdf, q)
    want = ga.count_less_plain(cdf, q)
    err = int((got - want).abs().max())
    ms = cuda_time_ms(lambda: ga.count_less(cdf, q), reps=10)
    plain_ms = cuda_time_ms(lambda: ga.count_less_plain(cdf, q), reps=3)
    log(f"  K4 env_row_cdf {tuple(cdf.shape)}: max |diff| {err}, kernel {ms:.3f} ms, "
        f"plain {plain_ms:.3f} ms")
    require(err == 0, "K4: kernel disagrees with the linear count")
    out["count_less"] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": float(err)}
    results["kernels"] = out


def phase_frame(data, config, cam, results):
    import torch

    from pupiloptixlab_tpu_torch import kernels
    from pupiloptixlab_tpu_torch.render.integrator import render_frame

    n = config.width * config.height
    accum = torch.zeros((n, 3), dtype=torch.float32, device="cuda")
    iters = 4
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
        f"peak {peak_gb:.2f} GB, launches {launches}")
    require(finite and mean > 0.0, "frame is not finite and non-zero")
    require(all(v > 0 for v in launches.values()),
            f"a kernel of the path was not launched: {launches}")
    results["frame"] = {"ms_per_frame": dt * 1e3, "mrays_per_s": rays / dt / 1e6,
                        "warmup_ms": warm_ms, "mean": mean, "peak_gb": peak_gb,
                        "rays_per_frame": rays, "launches": launches}
    return launches


def phase_parity(results):
    import numpy as np
    import torch

    from pupiloptixlab_tpu_torch.render.integrator import render_frame

    frames = {}
    for dev in ("cuda", "cpu"):
        data, config, cam = load_mesh_env(128, 8, dev)
        n = config.width * config.height
        accum = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        seq = []
        for i in range(4):
            _, bufs = render_frame(data, cam, i, i, accum, config)
            seq.append({k: v.cpu().numpy().copy() for k, v in bufs.items()})
        frames[dev] = seq
    worst = {"rel_mse": 0.0, "frac_within_1e-4": 1.0, "normal_max": 0.0, "albedo_max": 0.0}
    for i, (g, c) in enumerate(zip(frames["cuda"], frames["cpu"])):
        a, b = g["frame"], c["frame"]
        rel = float(np.mean((a - b) ** 2) / max(np.mean(b ** 2), 1e-30))
        frac = float(np.isclose(a, b, rtol=1e-4, atol=0.0).all(-1).mean())
        test_eq = bool(np.array_equal(g["test"], c["test"]))
        nmax = float(np.abs(g["normal"] - c["normal"]).max())
        amax = float(np.abs(g["albedo"] - c["albedo"]).max())
        log(f"  seed {i}: rel MSE {rel:.3e}, pixels within rtol 1e-4 {frac:.4f}, "
            f"test AOV equal {test_eq}, |d normal| {nmax:.2e}, |d albedo| {amax:.2e}")
        require(rel <= 1e-5 and frac >= 0.99 and test_eq,
                f"card and CPU frames disagree at seed {i}")
        worst["rel_mse"] = max(worst["rel_mse"], rel)
        worst["frac_within_1e-4"] = min(worst["frac_within_1e-4"], frac)
        worst["normal_max"] = max(worst["normal_max"], nmax)
        worst["albedo_max"] = max(worst["albedo_max"], amax)
    results["parity"] = worst


def phase_oracle(results):
    import numpy as np
    import torch

    from pupiloptixlab_tpu.utils.image import read_exr
    from pupiloptixlab_tpu_torch.render.integrator import render

    data, config, cam = load_mesh_env(64, 64, "cuda")
    spp = 512
    t0 = time.perf_counter()
    img = render(data, cam, config, spp=spp).cpu().numpy()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    oracle = read_exr(ORACLE)[::-1][..., :3]
    mean_ratio = float(img.mean() / oracle.mean())
    rel_mse = float(np.mean((img - oracle) ** 2) / np.mean(oracle ** 2))
    log(f"  64x64 {spp} spp in {secs:.1f} s: mean ratio {mean_ratio:.5f}, "
        f"rel MSE {rel_mse:.5e}")
    require(np.isfinite(img).all(), "oracle render is not finite")
    require(abs(mean_ratio - 1.0) < 0.02 and rel_mse < 1.5e-2,
            "mesh_env oracle gate failed (mean ratio within 0.02, rel MSE < 1.5e-2)")
    results["oracle"] = {"mean_ratio": mean_ratio, "rel_mse": rel_mse, "spp": spp,
                         "seconds": secs}


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

    from pupiloptixlab_tpu_torch import kernels

    log("[build] nvcc, one process per source")
    kernels.build_all()
    log(f"[build] {kernels.BUILD_SECONDS:.1f} s")
    for stem, text in kernels.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {stem}: {line.strip()}")
    results["build_seconds"] = kernels.BUILD_SECONDS

    t0 = time.perf_counter()
    data, config, cam = load_mesh_env(1920, 1080, "cuda")
    log(f"[flatten] mesh_env on cuda in {time.perf_counter() - t0:.2f} s: "
        f"{config.tri_count} tris, {config.bvh_nodes} nodes, tcl {config.bvh_tcl}, "
        f"depth {data.tris.bvh_depth}")
    with torch.inference_mode():
        log("[kernels] each kernel against its plain version")
        phase_kernels(data, config, cam, results)
        log("[frame] render_frame, 1 warm-up + 4 timed")
        launches = phase_frame(data, config, cam, results)
    del data
    torch.cuda.empty_cache()
    log("[parity] 128x8 film, seeds 0-3, card vs CPU")
    phase_parity(results)
    log("[oracle] mesh_env 64x64 against the brute-force oracle")
    phase_oracle(results)

    require("jax" not in sys.modules, "the port imported jax")
    log("[no-jax] jax not imported")
    results["seconds"] = time.perf_counter() - t_all
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(results, indent=1))

    line = []
    for name, (source, replaces) in KERNEL_META.items():
        k = results["kernels"][name]
        line.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name],
            "max_abs_err": k["max_abs_err"], "ms": k["ms"], "plain_ms": k["plain_ms"],
        })
    print(json.dumps({"kernels": line}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
