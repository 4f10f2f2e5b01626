"""whacknet — the robot-facing UDP communication backend.

Byte-compatible rebuild of the reference's ``whacknet`` crate
(``crates/whacknet/src/lib.rs``):

- 64-byte ``#[repr(C)]`` ``VisionMeasurement`` packet: RobotPose (x, y, rot —
  3 f64) + VisionUncertainty (3 f64) + ts (u64 microseconds) + camera_id (u8)
  + tag_count (u8) + 6 reserved bytes (lib.rs:41-66), sent to the roboRIO at
  ``10.TE.AM.2:7001`` (lib.rs:13-14; team-IP convention
  ``crates/chalkydri/src/utils.rs:19-25``),
- a gyro return channel: single little-endian f64 datagrams on 0.0.0.0:7002
  (lib.rs:112-130),
- a dedicated sender thread draining a queue (lib.rs:135-141) and a listener
  thread for the gyro, with clean shutdown via a sentinel (lib.rs:180-185).

A C++ fast path (chalkydri_tpu_torch/native/src/whacknet.cpp) provides the same
send/recv loop without the GIL; this module transparently uses it when the
shared library has been built, else falls back to Python threads.
"""

from __future__ import annotations

import os
import queue
import socket
import struct
import threading
from dataclasses import dataclass

DEFAULT_SEND_PORT = 7001  # whacknet/src/lib.rs:14
GYRO_PORT = 7002  # whacknet/src/lib.rs:113
PACKET_SIZE = 64
# <  little-endian; 6 doubles, u64 ts, 2 u8, 6 pad bytes
_PACK = struct.Struct("<6dQ2B6x")
assert _PACK.size == PACKET_SIZE


def team_ip(team_number: int) -> str:
    """FRC team-IP convention 10.TE.AM.2
    (``crates/chalkydri/src/utils.rs:19-25``)."""
    te, am = divmod(team_number, 100)
    return f"10.{te}.{am}.2"


@dataclass
class RobotPose:
    """whacknet/src/lib.rs:19-26."""

    x: float = 0.0
    y: float = 0.0
    rot: float = 0.0


@dataclass
class VisionUncertainty:
    """whacknet/src/lib.rs:29-38."""

    x: float = 0.0
    y: float = 0.0
    rot: float = 0.0


def encode_measurement(
    pose: RobotPose,
    std_devs: VisionUncertainty,
    ts_us: int,
    camera_id: int,
    tag_count: int,
) -> bytes:
    """Pack a VisionMeasurement; layout parity checked in tests
    (the reference's one unit test is exactly this 64-byte assertion,
    whacknet/src/lib.rs:92-95)."""
    return _PACK.pack(
        pose.x, pose.y, pose.rot,
        std_devs.x, std_devs.y, std_devs.rot,
        ts_us & 0xFFFFFFFFFFFFFFFF,
        camera_id & 0xFF,
        tag_count & 0xFF,
    )


def decode_measurement(data: bytes):
    """Robot-side decode (used by the client library and tests)."""
    x, y, rot, sx, sy, srot, ts, cam, n = _PACK.unpack(data[:PACKET_SIZE])
    return RobotPose(x, y, rot), VisionUncertainty(sx, sy, srot), ts, cam, n


class _NativeComm:
    """ctypes binding to the C++ whacknet fast path (if built)."""

    def __init__(self, remote_addr: str, remote_port: int, gyro_port: int):
        from chalkydri_tpu_torch.native import load_native

        self._lib = load_native()
        if self._lib is None:
            raise OSError("native library not built")
        self._handle = self._lib.whacknet_start(
            remote_addr.encode(), remote_port, gyro_port
        )
        if self._handle < 0:
            raise OSError("whacknet_start failed")

    def send(self, payload: bytes) -> None:
        self._lib.whacknet_send(self._handle, payload, len(payload))

    def gyro_angle(self):
        import ctypes

        out = ctypes.c_double()
        ok = self._lib.whacknet_gyro(self._handle, ctypes.byref(out))
        return out.value if ok else None

    def close(self) -> None:
        self._lib.whacknet_stop(self._handle)


class Comm:
    """Pose uplink + gyro downlink, mirroring ``whacknet::Comm``
    (whacknet/src/lib.rs:100-185).

    Like the reference, construction spawns a gyro listener and a sender
    worker; ``publish`` never blocks the hot path.
    """

    def __init__(
        self,
        team_number: int | None = None,
        remote_addr: str | None = None,
        remote_port: int = DEFAULT_SEND_PORT,
        gyro_port: int = GYRO_PORT,
        use_native: bool = True,
    ):
        if remote_addr is None:
            # The reference hardcodes team 4533's 10.45.33.2 (lib.rs:14); we
            # derive from the configured team number instead.
            remote_addr = team_ip(team_number if team_number is not None else 4533)
        self._remote = (remote_addr, remote_port)

        self._native = None
        if use_native and os.environ.get("CHALKYDRI_NO_NATIVE") != "1":
            try:
                self._native = _NativeComm(remote_addr, remote_port, gyro_port)
                return
            except OSError:
                self._native = None

        # --- Python fallback path -----------------------------------------
        self._gyro_lock = threading.Lock()
        self._gyro_value: float | None = 0.0  # starts Some(0.0) like lib.rs:108
        self._shutdown = threading.Event()

        self._gyro_sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._gyro_sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._gyro_sock.bind(("0.0.0.0", gyro_port))
        self._gyro_sock.settimeout(0.2)
        self._gyro_thread = threading.Thread(
            target=self._gyro_loop, daemon=True, name="whacknet-gyro"
        )
        self._gyro_thread.start()

        self._queue: queue.Queue[bytes | None] = queue.Queue()
        self._send_thread = threading.Thread(
            target=self._send_loop, daemon=True, name="whacknet-send"
        )
        self._send_thread.start()

    # -- threads ------------------------------------------------------------

    def _gyro_loop(self):
        while not self._shutdown.is_set():
            try:
                data, _ = self._gyro_sock.recvfrom(8)
            except socket.timeout:
                continue
            except OSError:
                break
            if len(data) >= 8:
                (val,) = struct.unpack("<d", data[:8])
                with self._gyro_lock:
                    self._gyro_value = val
        self._gyro_sock.close()

    def _send_loop(self):
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        while True:
            item = self._queue.get()
            if item is None:
                break
            try:
                sock.sendto(item, self._remote)
            except OSError:
                pass
        sock.close()

    # -- API (parity with whacknet/src/lib.rs:152-178) ----------------------

    def publish(self, cam_id: int, tag_count: int, ts_us: int,
                pose: RobotPose, std_devs: VisionUncertainty) -> None:
        payload = encode_measurement(pose, std_devs, ts_us, cam_id, tag_count)
        if self._native is not None:
            self._native.send(payload)
        else:
            self._queue.put(payload)

    def gyro_angle(self) -> float | None:
        if self._native is not None:
            return self._native.gyro_angle()
        # try_read semantics: never blocks meaningfully
        if self._gyro_lock.acquire(blocking=False):
            try:
                return self._gyro_value
            finally:
                self._gyro_lock.release()
        return None

    def close(self) -> None:
        if self._native is not None:
            self._native.close()
            return
        self._shutdown.set()
        self._queue.put(None)
