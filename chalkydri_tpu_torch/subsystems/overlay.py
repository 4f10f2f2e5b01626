"""Detection overlay for the driver-station preview.

Rerun-parity visualization (the reference streams frames AND detection
geometry to a rerun server, ``crates/configurator/src/monitor.rs:59-102``):
draw each camera's detected quads, tag ids, and decision margins onto its
preview frames, JPEG-encode, and push into a FrameRing that the MJPEG
streamer (io/mjpeg.py) serves.

Wiring: register ``on_frame`` as an App frame observer and ``on_detections``
as an App detection observer. Detections arrive one pipeline step behind the
frame (the app's async-dispatch publish path) — an acceptable preview lag of
one iteration; corners land on the right pixels because the scene moves
little in ~10 ms.
"""

from __future__ import annotations

import threading

import numpy as np

from chalkydri_tpu_torch.subsystems.monitor import FrameRing

OVERLAY_JPEG_QUALITY = 50  # the preview path's quality (mjpeg.rs:108-120)


class PreviewOverlay:
    """Combines frames and detections per camera into annotated JPEGs."""

    def __init__(self, ring: FrameRing | None = None,
                 quality: int = OVERLAY_JPEG_QUALITY):
        self.ring = ring or FrameRing()
        self.quality = quality
        self._lock = threading.Lock()
        # cam_id -> (ids [N], corners [N, 4, 2], margins [N])
        self._latest_dets: dict[int, tuple] = {}

    def on_detections(self, cam_id, ids, corners, margins) -> None:
        with self._lock:
            self._latest_dets[cam_id] = (
                np.asarray(ids), np.asarray(corners), np.asarray(margins)
            )

    def annotate(self, cam_id: int, frame: np.ndarray) -> np.ndarray:
        """Draw the camera's latest detections onto a BGR copy of frame."""
        import cv2

        if frame.ndim == 2:
            canvas = cv2.cvtColor(frame, cv2.COLOR_GRAY2BGR)
        else:
            canvas = frame.copy()
        with self._lock:
            dets = self._latest_dets.get(cam_id)
        if dets is not None:
            ids, corners, margins = dets
            for tid, quad, margin in zip(ids, corners, margins):
                pts = np.round(quad).astype(np.int32).reshape(-1, 1, 2)
                cv2.polylines(canvas, [pts], True, (0, 255, 0), 2)
                # corner 0 marked: decode-canonical orientation is visible
                cv2.circle(canvas, tuple(pts[0, 0]), 4, (0, 0, 255), -1)
                cx, cy = quad.mean(axis=0)
                cv2.putText(
                    canvas, f"{int(tid)} ({margin:.0f})",
                    (int(cx) - 10, int(cy)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.6, (0, 255, 255), 2,
                )
        return canvas

    def on_frame(self, cam_id: int, tov_us: int, frame: np.ndarray) -> None:
        import cv2

        canvas = self.annotate(cam_id, frame)
        ok, enc = cv2.imencode(
            ".jpg", canvas, [cv2.IMWRITE_JPEG_QUALITY, self.quality]
        )
        if ok:
            self.ring.push(tov_us or 0, enc.tobytes())
