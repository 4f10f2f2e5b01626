"""Top-down field view: tag layout + live robot pose trace + camera frusta.

The reference streams 3D state to a rerun server — the field layout and
solved poses land in a rerun viewer (``crates/configurator/src/monitor.rs:
22-31``, calibration point clouds ``crates/configurator/src/calibration.rs:
91-98``). Without the rerun SDK, this renders the same
operator picture as a live top-down field image served over the MJPEG
streamer's ``/field`` endpoint (io/mjpeg.py):

- the field rectangle with every layout tag drawn at its pose (id + facing
  normal),
- a fading per-camera trace of published robot poses,
- the current fused pose as a heading triangle with its std-dev ellipse,
- one field-of-view wedge per camera, rotated by the robot pose and the
  camera's mount yaw.

Wiring: register ``on_pose`` as an App pose observer; serve ``.ring`` via
``MjpegServer({"/field": view.ring, ...})``.
"""

from __future__ import annotations

import collections
import math
import threading
import time

import numpy as np

from chalkydri_tpu_torch.subsystems.monitor import FrameRing

FIELD_VIEW_QUALITY = 70
PX_PER_M = 48
MARGIN_PX = 24
TRACE_LEN = 400  # kept pose points per camera
MAX_RENDER_FPS = 15.0

# BGR trace colors per camera (cycled).
_CAM_COLORS = [
    (80, 220, 80), (80, 160, 255), (220, 160, 60), (180, 80, 220),
    (60, 220, 220), (200, 200, 200),
]


class FieldView:
    """Renders the field + pose state into a JPEG FrameRing."""

    def __init__(
        self,
        layout=None,
        ring: FrameRing | None = None,
        cam_yaws: dict[int, float] | None = None,
        cam_fov_deg: float = 70.0,
        quality: int = FIELD_VIEW_QUALITY,
        px_per_m: int = PX_PER_M,
        max_fps: float = MAX_RENDER_FPS,
    ):
        if layout is None:
            from chalkydri_tpu_torch.geometry.field_layout import load_field_layout

            layout = load_field_layout()
        self.ring = ring or FrameRing()
        self.quality = quality
        self.px_per_m = px_per_m
        self.cam_yaws = dict(cam_yaws or {})  # cam mount yaw (rad) per cam_id
        self.cam_fov = math.radians(cam_fov_deg)
        self._min_period = 1.0 / max_fps
        self._last_render = 0.0
        self._lock = threading.Lock()
        self._traces: dict[int, collections.deque] = {}
        # cam_id -> (x, y, yaw, std_x, std_y, tag_count)
        self._latest: dict[int, tuple] = {}
        # Rendering runs on its own thread: on_pose is called inline from
        # App's publish path, and a cv2 polylines/fillPoly pass over the
        # ~800x400 canvas plus imencode costs milliseconds — inline it
        # would delay the other cameras' UDP packets and the next capture
        # (the latency budget pipeline_depth=0 exists to protect).
        self._dirty = threading.Event()
        self._stop = threading.Event()
        self._render_thread: threading.Thread | None = None

        length, width = layout.field_size
        self.field_len = float(length) or 16.518
        self.field_wid = float(width) or 8.043
        self._w = int(self.field_len * px_per_m) + 2 * MARGIN_PX
        self._h = int(self.field_wid * px_per_m) + 2 * MARGIN_PX

        # Static tag geometry (small host arrays).
        # (the layout's tensors may live on the card: read them once)
        present = layout.present.cpu().numpy()
        self._tag_ids = np.nonzero(present)[0]
        self._tag_xy = layout.translations.cpu().numpy()[self._tag_ids][:, :2]
        rot = layout.rotations.cpu().numpy()[self._tag_ids]
        # Tag facing normal: the tag-frame +x axis in world coordinates
        # (tag corner model spans tag YZ, crates/chalkydri_sqpnp/src/lib.rs:
        # 37-39, so +x is the face normal).
        self._tag_normal = rot[:, :2, 0]
        self._static = None  # lazily rendered background

    # -- coordinate mapping ---------------------------------------------------

    def _to_px(self, x: float, y: float) -> tuple[int, int]:
        """World meters (x right, y up) -> image pixels (y down)."""
        px = MARGIN_PX + int(round(x * self.px_per_m))
        py = self._h - MARGIN_PX - int(round(y * self.px_per_m))
        return px, py

    # -- observers ------------------------------------------------------------

    def on_pose(self, cam_id, pose, std, tag_count, latency_us=0) -> None:
        """App pose observer: record the pose (cheap) and wake the render
        thread; never renders inline on the publish path."""
        with self._lock:
            trace = self._traces.setdefault(
                int(cam_id), collections.deque(maxlen=TRACE_LEN)
            )
            trace.append((float(pose.x), float(pose.y)))
            self._latest[int(cam_id)] = (
                float(pose.x), float(pose.y), float(pose.rot),
                float(std.x), float(std.y), int(tag_count),
            )
            if self._render_thread is None:
                self._render_thread = threading.Thread(
                    target=self._render_loop, daemon=True,
                    name="field-view-render",
                )
                self._render_thread.start()
        self._dirty.set()

    def _render_loop(self) -> None:
        while not self._stop.is_set():
            if not self._dirty.wait(timeout=0.5):
                continue
            self._dirty.clear()
            wait = self._last_render + self._min_period - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            self._last_render = time.monotonic()
            try:
                self._render_push()
            except Exception:  # a render bug must not kill the thread
                import logging

                logging.getLogger(__name__).warning(
                    "field view render failed", exc_info=True
                )

    def close(self) -> None:
        self._stop.set()
        self._dirty.set()
        t = self._render_thread
        if t is not None and t.is_alive():
            t.join(timeout=1.0)

    # -- rendering ------------------------------------------------------------

    def _render_static(self):
        import cv2

        canvas = np.full((self._h, self._w, 3), 30, np.uint8)
        tl = self._to_px(0, self.field_wid)
        br = self._to_px(self.field_len, 0)
        cv2.rectangle(canvas, tl, br, (90, 90, 90), 2)
        # center line
        cv2.line(
            canvas,
            self._to_px(self.field_len / 2, 0),
            self._to_px(self.field_len / 2, self.field_wid),
            (60, 60, 60), 1,
        )
        for tid, (x, y), (nx, ny) in zip(
            self._tag_ids, self._tag_xy, self._tag_normal
        ):
            p = self._to_px(float(x), float(y))
            cv2.circle(canvas, p, 4, (0, 200, 255), -1)
            tip = self._to_px(float(x) + 0.35 * nx, float(y) + 0.35 * ny)
            cv2.line(canvas, p, tip, (0, 200, 255), 1)
            cv2.putText(
                canvas, str(int(tid)), (p[0] + 5, p[1] - 5),
                cv2.FONT_HERSHEY_SIMPLEX, 0.38, (0, 200, 255), 1,
            )
        return canvas

    def render(self) -> np.ndarray:
        """Compose the current frame (BGR)."""
        import cv2

        if self._static is None:
            self._static = self._render_static()
        canvas = self._static.copy()
        with self._lock:
            traces = {k: list(v) for k, v in self._traces.items()}
            latest = dict(self._latest)

        for cam_id, pts in traces.items():
            color = _CAM_COLORS[cam_id % len(_CAM_COLORS)]
            arr = np.array(
                [self._to_px(x, y) for x, y in pts], np.int32
            ).reshape(-1, 1, 2)
            if len(arr) >= 2:
                cv2.polylines(canvas, [arr], False, tuple(c // 2 for c in color), 1)

        for cam_id, (x, y, yaw, sx, sy, n) in latest.items():
            color = _CAM_COLORS[cam_id % len(_CAM_COLORS)]
            p = self._to_px(x, y)
            # std-dev ellipse (clipped to something drawable)
            ex = int(min(max(sx, 0.02), 3.0) * self.px_per_m)
            ey = int(min(max(sy, 0.02), 3.0) * self.px_per_m)
            cv2.ellipse(canvas, p, (ex, ey), 0, 0, 360, (0, 90, 160), 1)
            # heading triangle
            tri = []
            for ang, r in ((0.0, 0.30), (2.5, 0.16), (-2.5, 0.16)):
                tri.append(
                    self._to_px(
                        x + r * math.cos(yaw + ang), y + r * math.sin(yaw + ang)
                    )
                )
            cv2.fillPoly(canvas, [np.array(tri, np.int32)], color)
            # camera frustum wedge
            cam_yaw = yaw + self.cam_yaws.get(cam_id, 0.0)
            for s in (-0.5, 0.5):
                a = cam_yaw + s * self.cam_fov
                tip = self._to_px(x + 2.0 * math.cos(a), y + 2.0 * math.sin(a))
                cv2.line(canvas, p, tip, tuple(c // 2 for c in color), 1)
            cv2.putText(
                canvas, f"cam{cam_id} n={n}", (p[0] + 8, p[1] + 14),
                cv2.FONT_HERSHEY_SIMPLEX, 0.4, color, 1,
            )
        return canvas

    def _render_push(self) -> None:
        import cv2

        canvas = self.render()
        ok, enc = cv2.imencode(
            ".jpg", canvas, [cv2.IMWRITE_JPEG_QUALITY, self.quality]
        )
        if ok:
            self.ring.push(int(time.monotonic() * 1e6), enc.tobytes())
