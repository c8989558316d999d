from pupiloptixlab_tpu_torch.scene.scene import Scene, load_scene  # noqa: F401
from pupiloptixlab_tpu_torch.scene.materials import Material, MatType  # noqa: F401
from pupiloptixlab_tpu_torch.scene.emitters import Emitter, EmitterType  # noqa: F401
from pupiloptixlab_tpu_torch.scene.shapes import Shape, ShapeInstance, ShapeType  # noqa: F401
from pupiloptixlab_tpu_torch.scene.textures import (  # noqa: F401
    AddressMode,
    FilterMode,
    Texture,
    TextureType,
    checkerboard_texture,
    rgb_texture,
)
