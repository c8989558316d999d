"""Scene flattening to device tables (mirrors pupiloptixlab_tpu.flatten)."""

from pupiloptixlab_tpu_torch.flatten.types import (  # noqa: F401
    CameraBlock,
    EmitterTable,
    MaterialTable,
    RenderConfig,
    SceneData,
    Spheres,
    TextureTable,
    TriSoup,
)
from pupiloptixlab_tpu_torch.flatten.flatten import (  # noqa: F401
    camera_block,
    camera_block_from_scene,
    flatten_scene,
)
