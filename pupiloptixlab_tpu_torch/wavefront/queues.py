"""Ray-queue primitives: stream compaction and key sorting.

Mirrors pupiloptixlab_tpu/wavefront/queues.py, the analog of the
reference's atomic-append queue cuda::DynamicArray (cuda/util.h:68-139):
a queue is a dict of (N,)-leading tensors of fixed capacity, compaction
is a stable sort on the alive mask (alive lanes packed to the front), and
a stable sort by a key (material, primitive) orders lanes for coherence.
"""

from __future__ import annotations

import torch


def compaction_permutation(alive: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable permutation packing alive lanes first; returns (perm, count),
    both int32, the count a 0-dim tensor on the mask's device."""
    perm = torch.argsort((~alive).to(torch.uint8), stable=True)
    return perm.to(torch.int32), torch.count_nonzero(alive).to(torch.int32)


def compact_queue(queue: dict, alive: torch.Tensor):
    """Apply the compaction permutation to every tensor of a queue. Returns
    (compacted queue, live count)."""
    perm, count = compaction_permutation(alive)
    idx = perm.long()
    return {k: v[idx] for k, v in queue.items()}, count


def sort_by_key(queue: dict, key: torch.Tensor):
    """Sort queue lanes by an integer key (e.g. material id), stably.
    Returns (sorted queue, int32 permutation)."""
    perm = torch.argsort(key, stable=True)
    return {k: v[perm] for k, v in queue.items()}, perm.to(torch.int32)
