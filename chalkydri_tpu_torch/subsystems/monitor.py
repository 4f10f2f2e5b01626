"""Monitor sink: JPEG-compressed frame telemetry.

Port of the reference's rerun monitor (``crates/configurator/src/monitor.rs:
11-102``): JPEG-compress each frame (quality 20, grayscale) and hand it to a
telemetry backend. The reference streams to a rerun gRPC server on :6767
with a 25%-of-RAM cap; rerun is an optional package, so the
default backend is an MJPEG ring buffer + optional on-disk dump, and the
MJPEG HTTP streamer (io/mjpeg.py) can serve it to a driver station —
covering the reference's MjpegProc role too
(``crates/chalkydri/src/cameras/mjpeg.rs:18-144``).

The sink is backend-pluggable, so that a swap is one file: a backend is anything
with ``publish(ts_us, jpeg_bytes, frame)``; ``Monitor`` fans each encoded
frame out to all of its backends. ``RerunBackend`` below IS the one-file
swap — when the ``rerun`` package is installed, config
``{"backend": "rerun"}`` streams to a rerun viewer exactly like
monitor.rs; without the package it degrades to a no-op with one warning.
"""

from __future__ import annotations

import collections
import logging
import os
import threading

import numpy as np

from chalkydri_tpu_torch.runtime.clock import RobotClock, Stamped
from chalkydri_tpu_torch.runtime.tasks import SinkTask, register_task

JPEG_QUALITY = 20  # monitor.rs:92 (quality 20, gray subsampling)


class FrameRing:
    """Bounded ring of (ts_us, jpeg bytes); newest-first access."""

    def __init__(self, capacity: int = 64):
        self._dq = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()

    def push(self, ts_us: int, jpeg: bytes) -> None:
        with self._lock:
            self._dq.append((ts_us, jpeg))

    def latest(self):
        with self._lock:
            return self._dq[-1] if self._dq else None

    def __len__(self):
        with self._lock:
            return len(self._dq)

    # backend protocol
    def publish(self, ts_us: int, jpeg: bytes, frame=None) -> None:
        self.push(ts_us, jpeg)


class DiskDumpBackend:
    """Write each encoded frame to ``dump_dir/frame_NNNNNN.jpg``."""

    def __init__(self, dump_dir: str):
        self.dump_dir = dump_dir
        self._n = 0

    def publish(self, ts_us: int, jpeg: bytes, frame=None) -> None:
        os.makedirs(self.dump_dir, exist_ok=True)
        path = os.path.join(self.dump_dir, f"frame_{self._n:06d}.jpg")
        with open(path, "wb") as f:
            f.write(jpeg)
        self._n += 1


class RerunBackend:
    """The reference's rerun gRPC stream (monitor.rs:11-57), as a one-file
    swap: lazily imports the ``rerun`` SDK, spawns/connects a viewer on
    construction, and logs each frame as an EncodedImage. The package is
    optional; absent, the backend warns once and no-ops so a graph configured for rerun
    still boots (degrade-don't-die policy)."""

    def __init__(self, app_id: str = "chalkydri", addr: str | None = None):
        self._rr = None
        try:
            import rerun as rr  # type: ignore

            rr.init(app_id)
            if addr:
                rr.connect_grpc(addr)
            else:
                rr.serve_grpc()  # :6767 default, like monitor.rs:20-28
            self._rr = rr
        except Exception as e:  # ImportError or viewer failure
            logging.getLogger(__name__).warning(
                "rerun backend unavailable (%s); monitor frames dropped "
                "on this backend", e,
            )

    def publish(self, ts_us: int, jpeg: bytes, frame=None) -> None:
        if self._rr is None:
            return
        self._rr.set_time("tov", timestamp=ts_us / 1e6)
        self._rr.log("camera", self._rr.EncodedImage(
            contents=jpeg, media_type="image/jpeg"))


@register_task("Monitor")
class Monitor(SinkTask):
    """config: {quality, dump_dir, ring_capacity, backend}.

    ``backend``: "mjpeg" (default — FrameRing for io/mjpeg.py) or
    "rerun" (adds RerunBackend; the ring stays on so the driver-station
    stream keeps working either way)."""

    def __init__(self, config=None, resources=None):
        super().__init__(config, resources)
        self.quality = int(self.config.get("quality", JPEG_QUALITY))
        self.ring = FrameRing(int(self.config.get("ring_capacity", 64)))
        self.backends = [self.ring]
        dump_dir = self.config.get("dump_dir")
        if dump_dir:
            self.backends.append(DiskDumpBackend(dump_dir))
        if self.config.get("backend") == "rerun":
            self.backends.append(RerunBackend(
                addr=self.config.get("rerun_addr")))

    def process(self, clock: RobotClock, msg: Stamped) -> None:
        if msg.payload is None:
            return
        import cv2

        frame = np.asarray(msg.payload)
        ok, enc = cv2.imencode(
            ".jpg", frame, [cv2.IMWRITE_JPEG_QUALITY, self.quality]
        )
        if not ok:
            return
        ts = msg.tov.time_us or clock.now_us()
        jpeg = enc.tobytes()
        for b in self.backends:
            # A telemetry sink must never take the vision loop down
            # (degrade-don't-die): isolate each backend and rate-limit
            # the complaint (e.g. dump_dir on a full disk raises ENOSPC
            # every frame).
            try:
                b.publish(ts, jpeg, frame)
            except Exception as e:
                import time as _time

                now = _time.monotonic()
                if now - getattr(self, "_last_backend_warn", 0.0) > 5.0:
                    self._last_backend_warn = now
                    logging.getLogger(__name__).warning(
                        "monitor backend %s failed: %s",
                        type(b).__name__, e,
                    )
