from pupiloptixlab_tpu_torch.display.tonemap import aces_gamma_to_display  # noqa: F401
from pupiloptixlab_tpu_torch.display.client import DisplayClient  # noqa: F401
