"""Dry run of the multi-device path over spawned ranks.

    python -m pupiloptixlab_tpu_torch.parallel.dryrun --ranks 2 --device cpu

starts ``--ranks`` processes (``torch.multiprocessing`` from a fork
server, a file store in a temporary directory), each one rank of a gloo
group on the CPU, or, without ``--device cpu``, of an NCCL group with one
card per rank (it raises on a machine with fewer cards). On ``data/mesh_env.xml`` every rank runs
``render_frame_sharded`` and ``render_frame_balanced`` at 128x64 (8 tiles),
``render_samples_sharded`` at 32x8, and ``ring_closest`` and
``ring_closest_bvh`` on its slab of a 64x32 film's primary rays, and writes
what it got to ``rank<r>.npz``. The parent then renders the same in one
process and prints the comparison: frames bit-equal, the sample mean
within 1e-6, both ring sweeps' t bit-equal to the brute sweep over the
whole table and rows equal except on exact ties of t across shards (both
rows hit the ray at that t), and ``bvh_closest`` on the whole table equal
to the brute sweep (these unjittered rays include some that run along box
faces). Frames run at depth 2 (primary rays, one bounce and its shadow
ray), which keeps a CPU frame to seconds.

The counterpart of ``__graft_entry__.py::dryrun_multichip`` (which renders
cornell on a virtual CPU mesh); the rank worker lives here so that the
ranks import only torch and the port.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

MESH_ENV = Path(__file__).resolve().parents[2] / "data" / "mesh_env.xml"
FILM = (128, 64)          # 8 tiles of the block lane order
SAMPLES_FILM = (32, 8)     # row-major lanes (32 is no multiple of 128)
RING_FILM = (64, 32)
DEPTH = 2
SEED = 7
FRAME_KEYS = ("frame", "albedo", "normal", "test")


def load(width: int, height: int, device, max_depth: int = DEPTH):
    """mesh_env flattened at ``width`` x ``height`` on ``device``."""
    from pupiloptixlab_tpu_torch.flatten import camera_block_from_scene, flatten_scene
    from pupiloptixlab_tpu_torch.scene import load_scene

    scene = load_scene(MESH_ENV)
    scene.sensor.film.w, scene.sensor.film.h = width, height
    data, config = flatten_scene(scene, device=device)
    config = dataclasses.replace(config, max_depth=max_depth)
    return data, config, camera_block_from_scene(scene, device=device)


def ring_rays(device):
    """Primary rays of the RING_FILM film without jitter, as the reference's
    ring tests make them: (3, n) origins and directions, (n,) intervals."""
    from pupiloptixlab_tpu_torch.render.camera import generate_rays

    _, config, cam = load(*RING_FILM, device)
    n = config.width * config.height
    zero = torch.zeros(n, device=device)
    ro, rd = generate_rays(cam, config.width, config.height, zero, zero)
    ro_flat = torch.stack([p.expand(n) for p in (ro.x, ro.y, ro.z)])
    rd_flat = torch.stack([rd.x, rd.y, rd.z])
    return (ro_flat, rd_flat, torch.full((n,), 1e-3, device=device),
            torch.full((n,), 1e16, device=device))


def _np(t):
    return t.detach().cpu().numpy()


def worker(rank: int, world: int, init_method: str, device: str, out_dir: str,
           depth: int = DEPTH) -> None:
    """One rank: the sharded, balanced and sample-sharded frames (at path
    depth ``depth``) and both ring sweeps; writes ``rank<rank>.npz`` into
    ``out_dir``."""
    import torch.distributed as dist

    from pupiloptixlab_tpu_torch.parallel.balance import (
        balanced_tile_perm, render_frame_balanced, tile_costs)
    from pupiloptixlab_tpu_torch.parallel.ring_sweep import (
        build_ring_bvh, ring_closest, ring_closest_bvh, shard_tris)
    from pupiloptixlab_tpu_torch.parallel.sharding import (
        make_mesh, rank_device, render_frame_sharded, render_samples_sharded, shard_scene)

    if device == "cpu":
        torch.set_num_threads(1)
    group = make_mesh(world, device=device, init_method=init_method, rank=rank)
    try:
        dev = rank_device(group)
        data, config, cam = load(*FILM, dev, depth)
        data = shard_scene(data, group)
        lanes = config.width * config.height // world
        out = {}
        acc = torch.zeros((lanes, 3), device=dev)
        acc, bufs = render_frame_sharded(group, data, cam, SEED, 0, acc, config)
        out["sharded_accum"] = _np(acc)
        out.update({f"sharded_{k}": _np(bufs[k]) for k in FRAME_KEYS})
        costs = tile_costs(data, cam, config)
        perm = balanced_tile_perm(costs, world)
        acc = torch.zeros((lanes, 3), device=dev)
        acc, bufs = render_frame_balanced(group, data, cam, SEED, 0, acc, config, perm)
        out.update(costs=costs, perm=perm, balanced_accum=_np(acc))
        out.update({f"balanced_{k}": _np(bufs[k]) for k in FRAME_KEYS})

        sdata, sconfig, scam = load(*SAMPLES_FILM, dev, depth)
        out["samples"] = _np(render_samples_sharded(group, shard_scene(sdata, group), scam,
                                                    SEED, sconfig))

        ro, rd, tmin, tmax = ring_rays(dev)
        per = tmin.shape[0] // world
        sl = slice(rank * per, (rank + 1) * per)
        table, shard_rows = shard_tris(data.tris.packed, world)
        t, i = ring_closest(group, ro[:, sl], rd[:, sl], tmin[sl], tmax[sl],
                            table[rank * shard_rows:(rank + 1) * shard_rows], shard_rows)
        out.update(ring_t=_np(t), ring_i=_np(i))
        ring = build_ring_bvh(data.tris.packed, world)
        t, i = ring_closest_bvh(group, ro[:, sl], rd[:, sl], tmin[sl], tmax[sl], ring)
        out.update(ring_bvh_t=_np(t), ring_bvh_i=_np(i))
        np.savez(Path(out_dir) / f"rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


def run(ranks: int, device: str, out_dir, depth: int = DEPTH) -> dict:
    """Spawn ``ranks`` workers and merge what they wrote: rank 0's frames,
    costs, permutation and samples; every rank's accumulation slabs and
    ring results (``*_accum`` and ``ring*`` as lists in rank order)."""
    import torch.multiprocessing as mp

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    store = out_dir / "store"
    store.unlink(missing_ok=True)
    # the ranks fork from one server process that has imported torch and
    # the port once (each spawned rank would import them anew); the server
    # holds no threads and no CUDA context when it forks
    multiprocessing.set_forkserver_preload(["pupiloptixlab_tpu_torch.parallel"])
    mp.start_processes(worker, args=(ranks, f"file://{store}", device, str(out_dir), depth),
                       nprocs=ranks, join=True, start_method="forkserver")
    per_rank = [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(ranks)]
    merged = dict(per_rank[0])
    for key in ("sharded_accum", "balanced_accum", "ring_t", "ring_i", "ring_bvh_t",
                "ring_bvh_i"):
        merged[key] = [p[key] for p in per_rank]
    return merged


def single_process(ranks: int, device, depth: int = DEPTH) -> dict:
    """The same work in one process: the whole frame, the mean of ``ranks``
    samples at seeds SEED.., and the closest hits over the whole table by
    the brute sweep (``closest_*``, what both ring sweeps must give) and by
    ``bvh_closest`` (``bvh_*``: K1 on the card, the brute sweep on the
    CPU), with the rays and the table for the tie check."""
    from pupiloptixlab_tpu_torch.accel.bvh_traverse import bvh_closest, plain_closest
    from pupiloptixlab_tpu_torch.render.integrator import render_frame, render_sample

    data, config, cam = load(*FILM, device, depth)
    n = config.width * config.height
    acc, bufs = render_frame(data, cam, SEED, 0, torch.zeros((n, 3), device=device), config)
    out = {f"frame_{k}": _np(bufs[k]) for k in FRAME_KEYS}
    sdata, sconfig, scam = load(*SAMPLES_FILM, device, depth)
    with torch.inference_mode():
        rad = [render_sample(sdata, scam, SEED + r, sconfig)["radiance"] for r in range(ranks)]
    out["samples_mean"] = _np(torch.stack(rad).mean(0))
    ro, rd, tmin, tmax = ring_rays(device)
    tris = data.tris
    planes = [p.contiguous() for p in (*ro, *rd, tmin, tmax)]
    t, i = plain_closest(*planes, tris.packed)
    out.update(closest_t=_np(t), closest_i=_np(i), rays=_np(torch.cat([ro, rd])),
               tri=_np(tris.packed))
    if tris.packed.device.type == "cpu":  # bvh_closest on CPU tables is the brute sweep
        out.update(bvh_t=out["closest_t"], bvh_i=out["closest_i"])
    else:
        t, i = bvh_closest(*planes, tris.packed, tris.bvh_child, tris.bvh_axis,
                           tris.bvh_boxes, tris.subleaf_rows, tris.subleaf_boxes,
                           tcl=config.bvh_tcl, depth=tris.bvh_depth)
        out.update(bvh_t=_np(t), bvh_i=_np(i))
    return out


def hits_at(rays: np.ndarray, tri: np.ndarray, lanes: np.ndarray, rows: np.ndarray):
    """t at which each ray of ``lanes`` hits row ``rows`` (1e16 where it
    misses), in the sweeps' arithmetic: to tell an exact tie of t between
    two rows from a wrong row."""
    from pupiloptixlab_tpu_torch.accel.sweep import mt_hit_t

    r = torch.from_numpy(rays[:, lanes])
    cols = torch.from_numpy(tri[rows])
    n = lanes.shape[0]
    return mt_hit_t(*r, torch.full((n,), 1e-3), torch.full((n,), 1e16),
                    [cols[:, k] for k in range(9)]).numpy()


def compare(got: dict, ref: dict) -> dict:
    """The dry run's checks; returns a summary whose "ok" is the verdict."""
    frames = {f"{mode}_{k}": bool(np.array_equal(got[f"{mode}_{k}"], ref[f"frame_{k}"]))
              for mode in ("sharded", "balanced") for k in FRAME_KEYS}
    samples_err = float(np.abs(got["samples"] - ref["samples_mean"]).max())
    ring = {}
    t_ref, i_ref = ref["closest_t"], ref["closest_i"]
    for name in ("ring", "ring_bvh"):
        t, i = np.concatenate(got[f"{name}_t"]), np.concatenate(got[f"{name}_i"])
        off = np.nonzero(i != i_ref)[0]
        # a row off is a tie when both rows hit that ray at its common t
        tie = ((i[off] >= 0) & (i_ref[off] >= 0)
               & (hits_at(ref["rays"], ref["tri"], off, i[off]) == t[off])
               & (hits_at(ref["rays"], ref["tri"], off, i_ref[off]) == t[off]))
        ring[name] = {"t_equal": bool(np.array_equal(t, t_ref)),
                      "rows_off": int(off.size), "ties": int(tie.sum()),
                      "hits": int((i_ref >= 0).sum())}
    # the tree walk against the brute sweep on the same rays, some of which
    # run along box faces (a direction component of exactly 0)
    walk = {"t_off": int((ref["bvh_t"] != t_ref).sum()),
            "rows_off": int((ref["bvh_i"] != i_ref).sum())}
    ok = (all(frames.values()) and samples_err <= 1e-6
          and all(r["t_equal"] and r["rows_off"] == r["ties"] for r in ring.values())
          and walk["t_off"] == 0 and walk["rows_off"] == 0)
    return {"ok": ok, "frames_bit_equal": frames, "samples_max_abs_err": samples_err,
            "ring": ring, "bvh_vs_brute": walk}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and torch.cuda.device_count() < args.ranks:
        raise SystemExit(f"dryrun: {args.ranks} ranks need one card each; this machine "
                         f"has {torch.cuda.device_count()} (pass --device cpu for gloo ranks)")
    with tempfile.TemporaryDirectory(prefix="pupil_dryrun_") as tmp:
        got = run(args.ranks, args.device, tmp)
    ref = single_process(args.ranks, args.device)
    summary = compare(got, ref)
    print(json.dumps({"ranks": args.ranks, "device": args.device, **summary}))
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
