from pupiloptixlab_tpu_torch.display.tonemap import aces_gamma_to_display  # noqa: F401
