"""Cost-balanced tile sharding: the multi-device load balancer.

Counterpart of pupiloptixlab_tpu/parallel/balance.py. Lane-slab sharding
(parallel/sharding.py) gives every rank the same NUMBER of rays but not
the same WORK: traversal cost varies across a frame (sky tiles leave at the
root's slab test, tiles over dense geometry pop many nodes). With
contiguous slabs one rank owns the expensive region while the rest wait at
the frame's gather. The fix is the reference's static rebalance: PERMUTE
the 1024-pixel tiles of the block lane order before the lanes split into
slabs, so each rank's slab holds an equal-cost mix. Per-pixel RNG is keyed
by pixel id, so the image is bit-identical under any permutation; the cost
is one tile-granular un-permute of the gathered buffers.

Cost model (``tile_costs``): the traversal counter K11
(``bvh_closest(count_iters=True)``) on this viewpoint's primary rays, the
inner-node pops summed over each tile's 1024 rays. The TPU counts a tile's
lockstep loop iterations; the card walks one ray per thread, so the sum
over the tile's rays is the cost of the same kind. Refresh it when the
camera moves far enough that the per-rank sums drift: one extra primary
traversal, one K11 launch.
"""

from __future__ import annotations

import numpy as np
import torch

from pupiloptixlab_tpu_torch.accel.bvh_traverse import bvh_closest
from pupiloptixlab_tpu_torch.flatten.types import CameraBlock, RenderConfig, SceneData
from pupiloptixlab_tpu_torch.parallel.sharding import render_frame_sharded
from pupiloptixlab_tpu_torch.render.integrator import lane_pixels, primary_rays, uses_blocks


def tile_costs(scene: SceneData, camera: CameraBlock, config: RenderConfig) -> np.ndarray:
    """(T,) int64 per-tile cost for this viewpoint: the inner-node pops of
    the primary rays (seed 0's jitter, block lane order), summed over each
    tile of 1024 rays by K11 (the plain tree walk on CPU tables)."""
    if config.bvh_nodes <= 0 or config.instanced or not uses_blocks(config):
        raise ValueError("tile_costs: the cost model walks a baked BVH over a film "
                         "of whole (8 x 128) blocks")
    tris = scene.tris
    pix = lane_pixels(config, device=tris.packed.device)
    _, (ro, rd, tmin, tmax) = primary_rays(camera, config, 0, pix)
    n = pix.shape[0]
    planes = [p.expand(n).contiguous() for p in (ro.x, ro.y, ro.z, rd.x, rd.y, rd.z)]
    _, _, counts = bvh_closest(*planes, tmin, tmax, tris.packed, tris.bvh_child,
                               tris.bvh_axis, tris.bvh_boxes, tris.subleaf_rows,
                               tris.subleaf_boxes, tcl=config.bvh_tcl,
                               depth=tris.bvh_depth, count_iters=True)
    return counts[:, 0].cpu().numpy().astype(np.int64)


def balanced_tile_perm(costs: np.ndarray, n_chips: int) -> np.ndarray:
    """Permutation (T,) assigning tiles to ``n_chips`` contiguous lane slabs
    with near-equal cost sums: capacity-bounded greedy LPT, tiles sorted by
    cost descending, each given to the currently lightest slab that still
    has room (every slab ends with exactly T / n_chips tiles, since the
    lane slabs are equal). T must divide by ``n_chips``; nothing is padded.
    At 1920x1080, T = 2,025 = 3^4 x 5^2, so 3 or 5 ranks divide it and 2 or
    4 do not."""
    t = costs.shape[0]
    if t % n_chips:
        raise ValueError(f"balanced_tile_perm: {t} tiles do not split into {n_chips} "
                         "equal slabs")
    cap = t // n_chips
    order = np.argsort(-costs, kind="stable")
    bins: list[list[int]] = [[] for _ in range(n_chips)]
    sums = np.zeros(n_chips, np.int64)
    for tile in order:
        open_bins = [k for k in range(n_chips) if len(bins[k]) < cap]
        chip = min(open_bins, key=lambda k: sums[k])
        bins[chip].append(int(tile))
        sums[chip] += costs[tile]
    return np.concatenate([np.asarray(b, np.int32) for b in bins])


def render_frame_balanced(
    group,
    scene: SceneData,
    camera: CameraBlock,
    seed: int,
    sample_cnt: int,
    accum: torch.Tensor,
    config: RenderConfig,
    tile_perm: np.ndarray,
):
    """``render_frame_sharded`` with a cost-balanced tile permutation: each
    rank traces its slab of the permuted lane order (``accum`` is that
    slab), and the gathered buffers are un-permuted, so the displayable
    buffers are row-major exactly as on the unbalanced path."""
    return render_frame_sharded(group, scene, camera, seed, sample_cnt, accum, config,
                                tile_perm)
