"""Runtime: dataflow graph, task model, scheduler, clock, unified logging
(port of ``chalkydri_tpu/runtime``) — the Copper (cu29) replacement, with
the App driving the torch step."""

from chalkydri_tpu_torch.runtime.clock import RobotClock, Stamped, Tov  # noqa: F401
from chalkydri_tpu_torch.runtime.graph import Edge, ResourceDecl, TaskGraph, TaskNode  # noqa: F401
from chalkydri_tpu_torch.runtime.tasks import (  # noqa: F401
    REGISTRY,
    BaseTask,
    ResourceManager,
    SinkTask,
    SrcTask,
    Task,
    register_task,
)
from chalkydri_tpu_torch.runtime.logging import UnifiedLogger, read_log, replay_frames  # noqa: F401
from chalkydri_tpu_torch.runtime.app import App  # noqa: F401

# Importing subsystems registers their task types.
import chalkydri_tpu_torch.subsystems  # noqa: F401,E402
