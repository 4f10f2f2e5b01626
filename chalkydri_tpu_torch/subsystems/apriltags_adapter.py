"""AprilAdapter: forwards (RobotPose, latency) messages to comm.

Port of ``crates/chalkydri/src/subsystems/apriltags.rs:27-93`` (used by the
alternate graph ``crates/chalkydri/copperconfig.ron:38-46,83-91``). In the
reference the publish body is commented out — superseded by the AprilTags
sink publishing directly; here the adapter is functional so graphs that
route pose messages through it behave.
"""

from __future__ import annotations

from chalkydri_tpu_torch.io.whacknet import RobotPose, VisionUncertainty
from chalkydri_tpu_torch.runtime.clock import RobotClock, Stamped
from chalkydri_tpu_torch.runtime.tasks import SinkTask, register_task


@register_task("AprilAdapter", "chalkydri::subsystems::apriltags::AprilAdapter")
class AprilAdapter(SinkTask):
    def __init__(self, config=None, resources=None):
        super().__init__(config, resources)
        self.cam_id = int(self.config.get("cam_id", 255))
        self._comm = None
        if resources is not None:
            try:
                self._comm = resources.get("comm.comm")
            except KeyError:
                self._comm = None

    def process(self, clock: RobotClock, msg: Stamped) -> None:
        if msg.payload is None or self._comm is None:
            return
        pose = msg.payload
        if isinstance(pose, dict):
            pose = RobotPose(
                pose.get("x", 0.0), pose.get("y", 0.0), pose.get("rot", 0.0)
            )
        latency = msg.latency_us(clock) or 0
        self._comm.publish(self.cam_id, 1, latency, pose, VisionUncertainty())
