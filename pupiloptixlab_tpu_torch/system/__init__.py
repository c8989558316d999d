from pupiloptixlab_tpu_torch.system.buffers import Buffer, BufferDesc, BufferFlag, BufferManager  # noqa: F401
from pupiloptixlab_tpu_torch.system.pass_base import Pass, PassTag  # noqa: F401
from pupiloptixlab_tpu_torch.system.system import System  # noqa: F401
