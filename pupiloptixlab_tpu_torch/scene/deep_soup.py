"""A seeded triangle soup whose 8-wide BVH is deeper than 9 levels.

Scenes that span a wide range of scales build deep trees. This soup puts
``n_tris`` small triangles at log-normal centroids (sigma 4 per axis, so
positions span e^-12 to e^12), each vertex jittered by a normal draw of
scale 1e-2: 20,000 triangles at numpy seed 1 give a tree of depth 11 at
16-row leaves, whose walk may need 78 stack entries (7 * depth + 1), more
than a 64-entry stack holds. Rays are aimed at points inside randomly
chosen triangles from random directions.

Used to hold the traversal kernels on trees deeper than 64 stack entries
(``chip_smoke.py`` and ``tests/test_torch_parallel.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from pupiloptixlab_tpu_torch.accel.bvh import build_bvh, bvh_depth, pick_leaf_size
from pupiloptixlab_tpu_torch.accel.bvh_traverse import make_baked_subleaf


def soup_vertices(n_tris: int = 20000, sigma: float = 4.0, seed: int = 1,
                  jitter: float = 1e-2):
    """(p0, p1, p2), each (n_tris, 3) float32."""
    rng = np.random.default_rng(seed)
    c = rng.lognormal(0.0, sigma, (n_tris, 3))
    v = (c[:, None, :] + rng.normal(0.0, jitter, (n_tris, 3, 3))).astype(np.float32)
    return v[:, 0], v[:, 1], v[:, 2]


def soup_tables(n_tris: int = 20000, sigma: float = 4.0, seed: int = 1, device="cpu"):
    """The soup flattened as the flatten lays out a BVH scene: rows
    [p0, e1, e2, pad] in BVH order (padded to whole leaves with zero rows),
    the node tables, the sub-leaf table, the leaf size and the depth."""
    p0, p1, p2 = soup_vertices(n_tris, sigma, seed)
    tcl = pick_leaf_size(n_tris)
    t_pad = max(-(-n_tris // tcl), 2) * tcl

    def pad(a):
        return np.concatenate([a, np.zeros((t_pad - n_tris, 3), np.float32)])

    p0, p1, p2 = pad(p0), pad(p1), pad(p2)
    bv = build_bvh(p0, p1, p2, n_tris, tcl)
    rows = np.zeros((t_pad, 12), np.float32)
    rows[:n_tris, 0:3] = p0[:n_tris]
    rows[:n_tris, 3:6] = p1[:n_tris] - p0[:n_tris]
    rows[:n_tris, 6:9] = p2[:n_tris] - p0[:n_tris]
    rows = rows[bv.order]

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    tri = dev(rows)
    sub_rows, sub_boxes = make_baked_subleaf(tri, tcl)
    return {"tri": tri, "child": dev(bv.child), "axis": dev(bv.axis),
            "boxes": dev(bv.boxes), "subleaf_rows": sub_rows, "subleaf_boxes": sub_boxes,
            "tcl": tcl, "depth": bvh_depth(bv.child), "n_nodes": bv.n_nodes}


def soup_rays(tri: torch.Tensor, n_rays: int, seed: int = 2):
    """Eight ray planes (ox, oy, oz, dx, dy, dz, tmin, tmax), float32: each
    ray aims at a point inside a random non-empty row of ``tri`` from a
    random direction, starting 10 * (1 + |target|) before it."""
    rng = np.random.default_rng(seed)
    rows = tri.cpu().numpy()
    live = np.nonzero(np.abs(rows[:, 3:9]).sum(1) > 0)[0]
    pick = rows[rng.choice(live, n_rays)]
    u, v = rng.uniform(0.1, 0.45, (2, n_rays))
    target = pick[:, 0:3] + u[:, None] * pick[:, 3:6] + v[:, None] * pick[:, 6:9]
    d = rng.normal(size=(n_rays, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dist = 10.0 * (1.0 + np.linalg.norm(target, axis=1, keepdims=True))
    o = target - d * dist
    planes = [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
              np.full(n_rays, 1e-3), np.full(n_rays, 1e16)]
    return [torch.from_numpy(np.ascontiguousarray(p, np.float32)).to(tri.device)
            for p in planes]
