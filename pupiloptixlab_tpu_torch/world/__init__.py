from pupiloptixlab_tpu_torch.world.world import RenderObject, World  # noqa: F401
