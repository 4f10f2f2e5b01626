"""Robot-side client libraries (chalkydrilib / chalkydrilibj parity; port
of ``chalkydri_tpu/clients``)."""

from chalkydri_tpu_torch.clients.python_client import Chalkydri, Pose2d  # noqa: F401
