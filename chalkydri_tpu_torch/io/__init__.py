"""Host I/O edges: robot comm (whacknet), config, capture, NT hooks (port
of ``chalkydri_tpu/io``)."""

from chalkydri_tpu_torch.io.whacknet import (  # noqa: F401
    Comm,
    RobotPose,
    VisionUncertainty,
    decode_measurement,
    encode_measurement,
    team_ip,
)
