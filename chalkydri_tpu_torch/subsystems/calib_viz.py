"""Calibration progress visualization (port of
``chalkydri_tpu/subsystems/calib_viz.py``; a host module, cv2 imported
inside the methods that draw, so importing it needs no cv2).

Rerun-parity for the reference's calibration loop, which logs each frame's
detected 2D corners and the board's 3D points to a rerun viewer
(``crates/configurator/src/calibration.rs:91-98``): accumulate corner
COVERAGE across the image plane (the operator's real question: "which parts
of the sensor have I covered?"), annotate each processed frame with the
current detections + progress, and after the solve overlay the reprojection
RMS. Frames go into a FrameRing served by the MJPEG streamer (io/mjpeg.py),
so the operator watches at http://<coprocessor>:<port>/stream while waving
the board — the same workflow the reference gets from its rerun URL.
"""

from __future__ import annotations

import numpy as np

from chalkydri_tpu_torch.subsystems.monitor import FrameRing

COVERAGE_GRID = (6, 8)  # rows x cols coverage cells


class CalibrationMonitor:
    """Feed via Calibrator(monitor=...); serve .ring over MjpegServer."""

    def __init__(self, ring: FrameRing | None = None, quality: int = 70):
        self.ring = ring or FrameRing()
        self.quality = quality
        self.all_corners: list[np.ndarray] = []  # one [N, 2] per accepted frame
        self.frames_seen = 0
        self.frames_accepted = 0
        self.result_rms: float | None = None
        self._shape = None

    # -- data hooks (called by tools/calibration.Calibrator) ----------------

    def on_frame(self, frame: np.ndarray, ids, corners, accepted: bool) -> None:
        """One processed calibration frame: detections [D, 4, 2] (valid only)."""
        self.frames_seen += 1
        self._shape = frame.shape[:2]
        pts = np.asarray(corners, np.float32).reshape(-1, 2) if len(corners) else None
        if accepted and pts is not None:
            self.frames_accepted += 1
            self.all_corners.append(pts)
        self._push(frame, pts, accepted)

    def on_result(self, rms_px: float, n_frames: int) -> None:
        self.result_rms = float(rms_px)
        if self._shape is not None:
            canvas = np.full((*self._shape, 3), 30, np.uint8)
            self._annotate(canvas, None, True, final=True)
            self._encode_push(canvas)

    # -- rendering ----------------------------------------------------------

    def coverage(self) -> np.ndarray:
        """Fraction-covered per coverage cell, [rows, cols] in [0, 1]."""
        rows, cols = COVERAGE_GRID
        grid = np.zeros((rows, cols), np.int32)
        if self._shape is None:
            return grid.astype(np.float32)
        h, w = self._shape
        for pts in self.all_corners:
            r = np.clip((pts[:, 1] / h * rows).astype(int), 0, rows - 1)
            c = np.clip((pts[:, 0] / w * cols).astype(int), 0, cols - 1)
            grid[r, c] = 1
        return grid.astype(np.float32)

    def coverage_fraction(self) -> float:
        cov = self.coverage()
        return float(cov.mean()) if cov.size else 0.0

    def _annotate(self, canvas, pts, accepted, final=False):
        import cv2

        h, w = canvas.shape[:2]
        rows, cols = COVERAGE_GRID
        # historical coverage: green tint on covered cells
        cov = self.coverage()
        for r in range(rows):
            for c in range(cols):
                if cov[r, c] > 0:
                    y0, y1 = int(r * h / rows), int((r + 1) * h / rows)
                    x0, x1 = int(c * w / cols), int((c + 1) * w / cols)
                    sub = canvas[y0:y1, x0:x1]
                    sub[:, :, 1] = np.minimum(255, sub[:, :, 1] + 40)
        # accumulated corner cloud (the reference's points2d log)
        for fpts in self.all_corners[-24:]:
            for x, y in fpts:
                cv2.circle(canvas, (int(x), int(y)), 1, (120, 200, 120), -1)
        # current frame's detections
        if pts is not None:
            color = (0, 255, 255) if accepted else (0, 0, 255)
            for x, y in pts:
                cv2.circle(canvas, (int(x), int(y)), 3, color, -1)
        status = (
            f"calib: {self.frames_accepted} frames, "
            f"coverage {self.coverage_fraction() * 100:.0f}%"
        )
        if self.result_rms is not None:
            status += f", rms {self.result_rms:.3f}px"
            if final:
                status += " — DONE"
        cv2.putText(canvas, status, (8, 22), cv2.FONT_HERSHEY_SIMPLEX,
                    0.6, (255, 255, 255), 2)

    def _push(self, frame, pts, accepted):
        import cv2

        canvas = (
            cv2.cvtColor(frame, cv2.COLOR_GRAY2BGR)
            if frame.ndim == 2 else frame.copy()
        )
        self._annotate(canvas, pts, accepted)
        self._encode_push(canvas)

    def _encode_push(self, canvas):
        import cv2

        ok, enc = cv2.imencode(
            ".jpg", canvas, [cv2.IMWRITE_JPEG_QUALITY, self.quality]
        )
        if ok:
            import time

            self.ring.push(time.monotonic_ns() // 1000, enc.tobytes())
