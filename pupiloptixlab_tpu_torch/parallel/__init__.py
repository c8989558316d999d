"""Multi-device rendering on torch.distributed (counterpart of
pupiloptixlab_tpu/parallel/): lane-slab and sample sharding
(``sharding.py``), the cost-balanced tile permutation (``balance.py``) and
the ring-sharded traversal (``ring_sweep.py``); ``dryrun.py`` runs them
over spawned ranks."""

from pupiloptixlab_tpu_torch.parallel.sharding import (  # noqa: F401
    make_mesh,
    render_frame_sharded,
    shard_scene,
)
from pupiloptixlab_tpu_torch.parallel.balance import (  # noqa: F401
    balanced_tile_perm,
    render_frame_balanced,
    tile_costs,
)
