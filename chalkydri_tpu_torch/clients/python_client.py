"""Robot-side client library (port of
``chalkydri_tpu/clients/python_client.py``; chalkydrilib parity —
functional, unlike the reference stub ``crates/chalkydrilib/src/lib.rs:8-13``).

Receives the coprocessor's 64-byte VisionMeasurement packets, tracks the
latest pose per camera, and exposes the fused robot pose the way the Java
API promises (``crates/chalkydrilibj/api/Chalkydri.java:14-21``:
``getRobotPose() -> Pose2d``): a std-dev-weighted average over fresh camera
measurements. Also provides the gyro uplink (the :7002 channel the
coprocessor listens on, whacknet/src/lib.rs:112-130).
"""

from __future__ import annotations

import math
import socket
import struct
import threading
import time
from dataclasses import dataclass
from typing import Optional

from chalkydri_tpu_torch.io.whacknet import (
    DEFAULT_SEND_PORT,
    GYRO_PORT,
    PACKET_SIZE,
    decode_measurement,
)


@dataclass
class Pose2d:
    x: float = 0.0
    y: float = 0.0
    rotation: float = 0.0


@dataclass
class Measurement:
    pose: Pose2d
    std_devs: tuple[float, float, float]
    latency_us: int
    tag_count: int
    recv_time: float


class Chalkydri:
    """Robot-side endpoint: listens on :7001 for measurements and can stream
    the gyro heading back to the coprocessor on :7002."""

    def __init__(self, listen_port: int = DEFAULT_SEND_PORT,
                 coprocessor_addr: Optional[str] = None,
                 gyro_port: int = GYRO_PORT,
                 staleness_s: float = 0.5):
        self._staleness = staleness_s
        self._lock = threading.Lock()
        self._latest: dict[int, Measurement] = {}
        self._stop = threading.Event()

        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind(("0.0.0.0", listen_port))
        self._sock.settimeout(0.2)
        self._thread = threading.Thread(target=self._rx_loop, daemon=True)
        self._thread.start()

        self._gyro_target = (
            (coprocessor_addr, gyro_port) if coprocessor_addr else None
        )
        self._gyro_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def _rx_loop(self):
        while not self._stop.is_set():
            try:
                data, _ = self._sock.recvfrom(PACKET_SIZE)
            except socket.timeout:
                continue
            except OSError:
                return
            if len(data) < PACKET_SIZE:
                continue
            pose, std, ts, cam, n = decode_measurement(data)
            with self._lock:
                self._latest[cam] = Measurement(
                    pose=Pose2d(pose.x, pose.y, pose.rot),
                    std_devs=(std.x, std.y, std.rot),
                    latency_us=ts,
                    tag_count=n,
                    recv_time=time.monotonic(),
                )

    # -- java-API parity surface --------------------------------------------

    def get_camera(self, cam_id: int) -> Optional[Measurement]:
        """``Chalkydri.getCamera(name)`` analogue (Chalkydri.java:8-12)."""
        with self._lock:
            return self._latest.get(cam_id)

    def calculate_robot_pose(self) -> Optional[tuple[float, float, float]]:
        """``calculateRobotPose() -> double[3]`` (Chalkydri.java:14-17):
        inverse-variance weighted fuse of fresh, tag-bearing measurements."""
        now = time.monotonic()
        with self._lock:
            fresh = [
                m for m in self._latest.values()
                if now - m.recv_time < self._staleness and m.tag_count > 0
                and m.std_devs[0] < 1e30
            ]
        if not fresh:
            return None
        wx = wy = wsum = 0.0
        sin_sum = cos_sum = 0.0
        for m in fresh:
            w = 1.0 / max(m.std_devs[0] ** 2, 1e-6)
            wx += w * m.pose.x
            wy += w * m.pose.y
            wr = 1.0 / max(m.std_devs[2] ** 2, 1e-6)
            sin_sum += wr * math.sin(m.pose.rotation)
            cos_sum += wr * math.cos(m.pose.rotation)
            wsum += w
        return wx / wsum, wy / wsum, math.atan2(sin_sum, cos_sum)

    def get_robot_pose(self) -> Optional[Pose2d]:
        """``getRobotPose() -> Pose2d`` (Chalkydri.java:19-21)."""
        out = self.calculate_robot_pose()
        return Pose2d(*out) if out else None

    def send_gyro(self, heading_rad: float) -> None:
        """Stream the robot gyro heading to the coprocessor (LE f64,
        whacknet/src/lib.rs:123)."""
        if self._gyro_target is None:
            raise RuntimeError("no coprocessor address configured")
        self._gyro_sock.sendto(struct.pack("<d", heading_rad), self._gyro_target)

    def close(self) -> None:
        self._stop.set()
        self._sock.close()
        self._gyro_sock.close()
