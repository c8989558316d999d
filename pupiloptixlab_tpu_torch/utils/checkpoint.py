"""Checkpoint / resume of progressive accumulation state.

Counterpart of pupiloptixlab_tpu/utils/checkpoint.py, which writes orbax
checkpoints. The reference's nearest equivalents are the progressive accum
buffer + sample counter (reset on dirty, example/path_tracer/main.cu:187-192)
and the EXR screenshot export; a long offline accumulation that dies loses
everything. Here the renderer state checkpoints with ``torch.save`` so
progressive renders survive restarts:

    from pupiloptixlab_tpu_torch.utils.checkpoint import save_render_state, \\
        restore_render_state
    save_render_state(path, pt_pass)            # accum + sample_cnt (+ rng seed)
    restore_render_state(path, pt_pass)         # continue accumulating

Layout: a checkpoint is a directory (created if missing; a second save
replaces its content, as orbax's ``force=True`` does) that holds one file,
``tree.pt``: ``torch.save`` of the tree, nested dicts and lists whose leaves
are tensors (numpy arrays are taken as tensors) or Python scalars, every
tensor on the CPU. It is read back with ``torch.load(weights_only=True)``,
which rebuilds tensors and containers and runs no other code.
"""

from __future__ import annotations

import contextlib
import os
from pathlib import Path

import numpy as np
import torch

TREE_FILE = "tree.pt"


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, np.ndarray | np.generic):
        return torch.from_numpy(np.array(tree))
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def _like(tree, like, where: str):
    """``tree``'s tensors checked against and moved to ``like``'s."""
    if isinstance(like, dict):
        return {k: _like(tree[k], v, f"{where}/{k}") for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_like(a, b, f"{where}/{i}")
                          for i, (a, b) in enumerate(zip(tree, like, strict=True)))
    if isinstance(like, torch.Tensor):
        if tuple(tree.shape) != tuple(like.shape) or tree.dtype != like.dtype:
            raise ValueError(
                f"checkpoint leaf {where or '/'}: {tuple(tree.shape)} {tree.dtype} != "
                f"expected {tuple(like.shape)} {like.dtype}")
        return tree.to(like.device)
    return tree


def save_pytree(path: str | Path, tree) -> None:
    path = Path(path).resolve()
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / (TREE_FILE + ".tmp")
    torch.save(_to_host(tree), tmp)
    os.replace(tmp, path / TREE_FILE)  # a reader sees the old tree or the new one


def load_pytree(path: str | Path, like=None):
    """The saved tree on the CPU; with ``like`` (the same structure) each
    tensor goes to the device of its counterpart in ``like``, and a shape
    or dtype that differs raises ValueError (orbax's ``sharding=``
    counterpart)."""
    tree = torch.load(Path(path).resolve() / TREE_FILE, map_location="cpu",
                      weights_only=True)
    return tree if like is None else _like(tree, like, "")


def _between_frames(pt_pass):
    """The system's render mutex while the pass is bound, so that a save
    or a restore from another thread lands between two frames."""
    system = getattr(pt_pass, "system", None)
    return system._render_mutex if system is not None else contextlib.nullcontext()


def save_render_state(path: str | Path, pt_pass) -> None:
    """Checkpoint a PTPass's progressive accumulation (accum buffer,
    sample count, seed). The accum is copied to the host between frames:
    ``render_frame`` blends into it in place."""
    with _between_frames(pt_pass):
        state = {
            "accum": pt_pass._accum.detach().to("cpu", copy=True),
            "sample_cnt": torch.tensor(pt_pass.sample_cnt, dtype=torch.int32),
            "seed": torch.tensor(pt_pass.seed, dtype=torch.uint32),
        }
    save_pytree(path, state)


def restore_render_state(path: str | Path, pt_pass) -> None:
    """Restore a checkpoint into a PTPass (shapes must match the loaded
    scene's film: ValueError otherwise). Accumulation continues from the
    saved sample count.

    The saved accum is copied into the pass's own tensor, which the "pt
    frame", "pt accum" and "final result" buffers alias after a frame; they
    are pointed at it again here, so a resumed pass shows no stale
    buffer before its next frame."""
    like = {
        "accum": pt_pass._accum,
        "sample_cnt": torch.tensor(0, dtype=torch.int32),
        "seed": torch.tensor(0, dtype=torch.uint32),
    }
    state = load_pytree(path, like=like)
    with _between_frames(pt_pass), torch.inference_mode():
        pt_pass._accum.copy_(state["accum"])
        pt_pass.sample_cnt = int(state["sample_cnt"])
        pt_pass.seed = int(state["seed"])
        pt_pass._dirty = False
        system = getattr(pt_pass, "system", None)
        if system is not None:
            for name in ("pt frame", "pt accum", "final result"):
                if name in system.buffers:
                    system.buffers.set_array(name, pt_pass._accum)
