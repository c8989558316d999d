from pupiloptixlab_tpu_torch.passes.pt import PTPass  # noqa: F401
