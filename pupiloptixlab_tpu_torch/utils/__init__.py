from pupiloptixlab_tpu_torch.utils.math import (  # noqa: F401
    AABB,
    Transform,
    look_at_matrix,
    mitsuba_handedness_fix,
    rotate_matrix,
    scale_matrix,
    transform_normals,
    transform_point,
    transform_points,
    transform_vector,
    translate_matrix,
)
from pupiloptixlab_tpu_torch.utils.camera import Camera, CameraDesc  # noqa: F401
from pupiloptixlab_tpu_torch.utils.event import EventBus  # noqa: F401
from pupiloptixlab_tpu_torch.utils.log import get_logger  # noqa: F401
from pupiloptixlab_tpu_torch.utils.timer import Timer  # noqa: F401
