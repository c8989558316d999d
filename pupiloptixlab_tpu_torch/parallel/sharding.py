"""Multi-device rendering over torch.distributed: lane-slab (pixel) sharding
and sample sharding.

Counterpart of pupiloptixlab_tpu/parallel/sharding.py. The reference's
``jax.sharding.Mesh`` is a ``torch.distributed`` process group here, one
process per device: NCCL for CUDA tensors (one card per rank, rank r on
``cuda:r``), gloo for CPU tensors. The device comes from the scene tables;
a group whose backend does not serve it raises, and nothing falls back
from NCCL to gloo or from the card to the CPU.

* **Pixel sharding** (``render_frame_sharded``): every rank holds the whole
  scene (``shard_scene``: rank 0's tables broadcast to all) and traces only
  its slab of the frame's lane order, ``render_frame(slab=(rank, D))``:
  whole 1024-pixel tiles on the block route, whole pixel rows on the
  row-major route. Its accumulation buffer is that slab, in lane order,
  and never leaves the rank; the displayable buffers are all-gathered and
  put back into pixel order. JAX's partitioner split the lanes for free;
  here the slab is explicit. The hot loop has no collective.
* **Sample sharding** (``render_samples_sharded``): every rank renders the
  full film at seed ``seed0 + rank``; an all-reduce mean merges them (the
  reference's ``pmean``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from pupiloptixlab_tpu_torch.device import resolve_device
from pupiloptixlab_tpu_torch.flatten.types import CameraBlock, RenderConfig, SceneData
from pupiloptixlab_tpu_torch.render.integrator import (
    lanes_to_pixels,
    render_frame,
    render_sample,
)


def make_mesh(n_devices: int | None = None, device=None, init_method: str | None = None,
              rank: int | None = None):
    """The process group the sharded calls run over: the default group,
    initialised here when it is not yet, with ``n_devices`` ranks,
    ``init_method`` (``tcp://host:port`` or ``file://path``) and this
    process's ``rank``. ``device`` None or CUDA: NCCL, this rank on
    ``cuda:<rank>`` (one card per rank, raises with fewer); ``"cpu"``:
    gloo. An initialised group is returned as it is, after checking
    ``n_devices`` against its size."""
    if dist.is_initialized():
        if n_devices is not None and dist.get_world_size() != n_devices:
            raise ValueError(f"make_mesh: the process group has {dist.get_world_size()} "
                             f"ranks, not {n_devices}")
        return dist.group.WORLD
    if n_devices is None or init_method is None or rank is None:
        raise ValueError("make_mesh: a new process group needs n_devices, init_method "
                         "and rank")
    dev = resolve_device(device)
    if dev.type == "cuda":
        if torch.cuda.device_count() < n_devices:
            raise RuntimeError(f"make_mesh: {n_devices} ranks need one card each; this "
                               f"machine has {torch.cuda.device_count()}")
        torch.cuda.set_device(rank)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=n_devices,
                            rank=rank)
    return dist.group.WORLD


def rank_device(group=None) -> torch.device:
    """The device this rank works on: its card under NCCL, the CPU under gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def check_group(group, device) -> None:
    """Raise unless ``group``'s backend serves tensors on ``device``."""
    want = "nccl" if torch.device(device).type == "cuda" else "gloo"
    got = dist.get_backend(group)
    if got != want:
        raise ValueError(f"tensors on {device} need a {want} process group, got {got}")


def _scene_tensors(scene: SceneData):
    for group_field in dataclasses.fields(scene):
        table = getattr(scene, group_field.name)
        for f in dataclasses.fields(table):
            value = getattr(table, f.name)
            if isinstance(value, torch.Tensor):
                yield group_field.name, f.name, value


def shard_scene(scene: SceneData, group=None) -> SceneData:
    """Replicate the scene tables on every rank: each rank flattens the
    same scene, then rank 0's tables are broadcast into new tensors on
    every rank, so all ranks hold identical tables (the reference
    device-puts one replicated copy). Raises on every rank when the ranks'
    table shapes differ."""
    check_group(group, scene.tris.packed.device)
    tensors = list(_scene_tensors(scene))
    sig = [(g, f, tuple(t.shape), str(t.dtype)) for g, f, t in tensors]
    sigs = [None] * dist.get_world_size(group)
    dist.all_gather_object(sigs, sig, group=group)
    if any(s != sigs[0] for s in sigs):
        raise ValueError("shard_scene: the ranks flattened scenes of different shapes")
    src = dist.get_global_rank(group, 0) if group is not None else 0
    new: dict[str, dict[str, torch.Tensor]] = {}
    for g, f, t in tensors:
        buf = t.clone().contiguous()
        if buf.numel():
            dist.broadcast(buf.view(torch.uint8) if buf.dtype == torch.bool else buf,
                           src=src, group=group)
        new.setdefault(g, {})[f] = buf
    return dataclasses.replace(scene, **{
        g: dataclasses.replace(getattr(scene, g), **fields) for g, fields in new.items()})


def render_frame_sharded(
    group,
    scene: SceneData,
    camera: CameraBlock,
    seed: int,
    sample_cnt: int,
    accum: torch.Tensor,
    config: RenderConfig,
    tile_perm=None,
):
    """One progressive frame with the lanes split over the group's ranks.

    ``accum`` is this rank's (N / D, 3) slab of the frame's lane order
    (``integrator.lane_pixels(config, tile_perm, (rank, D))`` names its
    pixels), updated in place; it never leaves the rank. Returns (accum,
    buffers): the displayable buffers (frame, albedo, normal, test) of the
    whole film in row-major pixel order, gathered from every rank.
    ``tile_perm``: see ``balance.render_frame_balanced``."""
    check_group(group, scene.tris.packed.device)
    rank, d = dist.get_rank(group), dist.get_world_size(group)
    with torch.inference_mode():
        accum, bufs = render_frame(scene, camera, seed, sample_cnt, accum, config,
                                   tile_perm, slab=(rank, d))
        out = {}
        for key, v in bufs.items():
            parts = [torch.empty_like(v) for _ in range(d)]
            dist.all_gather(parts, v.contiguous(), group=group)
            out[key] = lanes_to_pixels(torch.cat(parts), config, tile_perm)
    return accum, out


def render_samples_sharded(
    group,
    scene: SceneData,
    camera: CameraBlock,
    seed0: int,
    config: RenderConfig,
):
    """Sample-parallel rendering: every rank traces the full film at seed
    ``seed0 + rank``, and an all-reduce mean merges them (one collective a
    call). Effective spp = group size. Returns (h*w, 3) on every rank."""
    check_group(group, scene.tris.packed.device)
    rank, d = dist.get_rank(group), dist.get_world_size(group)
    with torch.inference_mode():
        rad = render_sample(scene, camera, seed0 + rank, config)["radiance"].contiguous()
        dist.all_reduce(rad, op=dist.ReduceOp.SUM, group=group)
        return rad / d
