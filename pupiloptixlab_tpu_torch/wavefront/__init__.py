from pupiloptixlab_tpu_torch.wavefront.engine import render_wavefront  # noqa: F401
from pupiloptixlab_tpu_torch.wavefront.queues import compact_queue, sort_by_key  # noqa: F401
