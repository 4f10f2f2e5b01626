"""Geometry core: transforms, camera model, field layout, tag model."""

from chalkydri_tpu_torch.geometry.transforms import (  # noqa: F401
    SE3,
    euler_to_matrix,
    matrix_to_quat,
    matrix_to_yaw,
    quat_to_matrix,
    robot_to_cam_from_offsets,
    smoothstep,
    wrap_angle,
)
from chalkydri_tpu_torch.geometry.camera import OpenCVModel5, stack_models  # noqa: F401
from chalkydri_tpu_torch.geometry.field_layout import (  # noqa: F401
    MAX_TAG_ID,
    FieldLayout,
    load_field_layout,
    parse_field_layout,
)
from chalkydri_tpu_torch.geometry.tags import (  # noqa: F401
    CORNER_DISTANCE,
    TAG_SIZE,
    corner_offsets,
    corners_world,
)
