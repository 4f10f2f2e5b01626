"""RobotClock + time-of-validity stamps.

Mirrors Copper's ``RobotClock`` / ``Tov`` model used throughout the reference
(``crates/chalkydri/src/cameras/pipeline.rs:353,380``; latency delta
``clock.now() - tov`` goes into the wire packet,
``crates/apriltags/src/lib.rs:351``): a monotonic clock started at process
init, with every message carrying the capture-time stamp so end-to-end
latency is measurable at every hop (SURVEY.md section 5.1).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional


class RobotClock:
    """Monotonic clock; ``now_us()`` microseconds since construction."""

    def __init__(self):
        self._t0 = time.monotonic_ns()

    def now_us(self) -> int:
        return (time.monotonic_ns() - self._t0) // 1000

    def now_ms(self) -> int:
        return self.now_us() // 1000


@dataclass(frozen=True)
class Tov:
    """Time of validity: when the data a message carries was true (frame
    arrival time, not processing time). ``None`` = no payload."""

    time_us: Optional[int] = None

    @property
    def is_time(self) -> bool:
        return self.time_us is not None


@dataclass
class Stamped:
    """A message with its Tov — the (payload, CuDuration) pairs flowing
    through every reference connection (``chalkydri.ron:113-150``)."""

    payload: object
    tov: Tov

    def latency_us(self, clock: RobotClock) -> Optional[int]:
        if self.tov.time_us is None:
            return None
        return clock.now_us() - self.tov.time_us
