"""Calibrator sink: stash the latest frame for the calibration driver.

Port of ``crates/chalkydri/src/subsystems/calibration.rs:11-57``: the in-graph
sink stores the newest frame in a global slot (``CALIB``); the configurator's
calibration loop drains it, detects the aprilgrid, and accumulates frame
features (``crates/configurator/src/calibration.rs:57-103``; driver loop
``configurator/src/main.rs:401-406``).
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from chalkydri_tpu_torch.runtime.clock import RobotClock, Stamped
from chalkydri_tpu_torch.runtime.tasks import SinkTask, register_task


class _CalibSlot:
    """Global latest-frame mailbox (the reference's ``CALIB`` mutex)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._frame: Optional[np.ndarray] = None
        self._tov: Optional[int] = None

    def put(self, frame: np.ndarray, tov_us: Optional[int]) -> None:
        with self._lock:
            self._frame = frame
            self._tov = tov_us

    def take(self):
        """Take-and-clear, like ``CALIB.take()``
        (configurator/src/calibration.rs:60)."""
        with self._lock:
            out = (self._frame, self._tov)
            self._frame = None
            self._tov = None
            return out if out[0] is not None else None


CALIB = _CalibSlot()


@register_task("Calibrator", "chalkydri::subsystems::calibration::Calibrator")
class Calibrator(SinkTask):
    def process(self, clock: RobotClock, msg: Stamped) -> None:
        if msg.payload is None:
            return
        CALIB.put(np.asarray(msg.payload), msg.tov.time_us)
