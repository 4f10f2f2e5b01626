"""Host-side subsystem tasks around the batched vision step (port of
``chalkydri_tpu/subsystems``).

Parity targets (SURVEY.md section 2.1): Calibrator, Monitor, AprilAdapter,
PythonSubsys (custom user code), MlSubsys (the Coral slot, now a torch
model hook on the App's device), and the AAEC exposure control.
"""

from chalkydri_tpu_torch.subsystems.calibration import CALIB, Calibrator  # noqa: F401
from chalkydri_tpu_torch.subsystems.monitor import Monitor  # noqa: F401
from chalkydri_tpu_torch.subsystems.apriltags_adapter import AprilAdapter  # noqa: F401
from chalkydri_tpu_torch.subsystems.custom import PythonSubsys  # noqa: F401
from chalkydri_tpu_torch.subsystems.ml import MlSubsys  # noqa: F401
from chalkydri_tpu_torch.subsystems.aaec import compute_exposure_gradients  # noqa: F401
