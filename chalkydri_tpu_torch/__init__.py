"""chalkydri-tpu on PyTorch and CUDA: frames -> robot poses on an NVIDIA GPU.

The port of ``chalkydri_tpu`` (JAX/Pallas on TPU), module for module:

- ``geometry``: SE3 transforms, the OpenCV lens model, the field layout,
- ``detector``: threshold -> CCL -> clustering -> quad fit -> refine ->
  decode, batched over cameras,
- ``solver``: batched SQPnP with gyro fusion,
- ``ops``: small linear algebra and the hand-written CUDA kernels
  (``csrc/``) that replace the JAX package's Pallas kernels,
- ``pipeline``: the fused per-rig step ``frames, gyro -> VisionOutput``,
- ``parallel``: that step over a grid of devices, cameras data-parallel
  and frame rows in bands.

Importing this package imports ``torch`` only: no JAX, no CUDA compiler.
The kernels build on first use (``ops/build.py``).
"""

__version__ = "0.1.0"

from chalkydri_tpu_torch.geometry import (  # noqa: F401
    SE3,
    OpenCVModel5,
    load_field_layout,
)
from chalkydri_tpu_torch.solver import SqPnP, solve_robot_pose  # noqa: F401

__all__ = [
    "SE3",
    "OpenCVModel5",
    "load_field_layout",
    "SqPnP",
    "solve_robot_pose",
]
