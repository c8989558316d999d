from pupiloptixlab_tpu_torch.denoise.atrous import Denoiser, DenoiserMode, denoise  # noqa: F401
