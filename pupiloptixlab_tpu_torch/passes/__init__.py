from pupiloptixlab_tpu_torch.passes.pt import PTPass  # noqa: F401
from pupiloptixlab_tpu_torch.passes.compute import ComputePass  # noqa: F401
from pupiloptixlab_tpu_torch.passes.denoise import DenoisePass  # noqa: F401
from pupiloptixlab_tpu_torch.passes.restir import ReSTIRPass  # noqa: F401
