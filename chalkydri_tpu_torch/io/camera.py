"""Camera capture: hotplug provider + per-camera capture pipelines.

Rebuild of the reference's L0 capture layer without GStreamer
(SURVEY.md section 2.3: the GStreamer C pipeline becomes a host capture shim;
color->gray moves on-device):

- ``V4l2Provider`` (``crates/chalkydri/src/cameras/providers.rs:16-167``):
  camera hotplug registry. The reference listens to GStreamer device-bus
  add/remove messages keyed by USB bus path; here we poll sysfs/dev nodes —
  same contract (``devices()``, add/remove callbacks, stable ids).
- ``CamPipeline`` (``crates/chalkydri/src/cameras/pipeline.rs:30-392``):
  per-camera capture with the reference's latency discipline — depth-1
  drop-oldest buffering, non-blocking latest-frame poll, time-of-validity
  stamped at frame arrival. Backed by cv2.VideoCapture (V4L2) when the
  device exists, or a deterministic synthetic tag scene for tests/dev (the
  reference's laptop-webcam graph entries play this role,
  ``chalkydri.ron:72-88``).
- tolerates absent/unplugged devices by emitting None payloads downstream
  tasks skip (``pipeline.rs:383-387``, SURVEY.md section 5.3).
"""

from __future__ import annotations

import glob
import os
import threading
import time
from typing import Callable, Optional

import numpy as np

from chalkydri_tpu_torch.runtime.clock import RobotClock, Stamped, Tov


class V4l2Provider:
    """Hotplug registry: stable-id -> /dev/videoN mapping, with add/remove
    callbacks (providers.rs:31-81 trait surface)."""

    def __init__(self, poll_interval: float = 1.0):
        self._devices: dict[str, str] = {}
        self._lock = threading.Lock()
        self._callbacks: list[Callable[[str, str, bool], None]] = []
        self._poll_interval = poll_interval
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    @staticmethod
    def _scan() -> dict[str, str]:
        """id -> device node. The id is the USB bus path when sysfs exposes
        it (matching the reference keying by ``device.bus_path``,
        providers.rs:119-123), else the node name."""
        out = {}
        for node in sorted(glob.glob("/dev/video*")):
            name = os.path.basename(node)
            sys_link = f"/sys/class/video4linux/{name}/device"
            dev_id = name
            try:
                target = os.readlink(sys_link)
                dev_id = target.split("/")[-1] or name
            except OSError:
                pass
            # only capture-capable even nodes by convention
            out.setdefault(dev_id, node)
        return out

    def start(self) -> None:
        self.refresh()
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._poll_loop, daemon=True, name="v4l2-provider"
            )
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread = None

    def _poll_loop(self):
        while not self._stop.wait(self._poll_interval):
            self.refresh()

    def refresh(self) -> None:
        found = self._scan()
        with self._lock:
            added = {k: v for k, v in found.items() if k not in self._devices}
            removed = {k: v for k, v in self._devices.items() if k not in found}
            self._devices = found
        for k, v in added.items():
            for cb in self._callbacks:
                cb(k, v, True)
        for k, v in removed.items():
            for cb in self._callbacks:
                cb(k, v, False)

    def devices(self) -> dict[str, str]:
        with self._lock:
            return dict(self._devices)

    def on_change(self, cb: Callable[[str, str, bool], None]) -> None:
        self._callbacks.append(cb)


PROVIDER = V4l2Provider()  # global, like providers.rs:16-20


def _orient(frame: np.ndarray, orientation: str) -> np.ndarray:
    """videoflip parity (VideoOrientation, chalkydri_core/src/config.rs:198-207)."""
    if orientation in ("clockwise", "Clockwise"):
        return np.rot90(frame, -1)
    if orientation in ("rotate-180", "Rotate180"):
        return np.rot90(frame, 2)
    if orientation in ("counterclockwise", "Counterclockwise"):
        return np.rot90(frame, 1)
    return frame


class _CvCapture:
    """cv2.VideoCapture wrapper with a reader thread and a depth-1
    drop-oldest slot (appsink max-buffers=1 drop=true, pipeline.rs:168-172)."""

    def __init__(self, node: str, width: int, height: int, fps: Optional[float],
                 auto_exposure: bool = True,
                 manual_exposure: Optional[int] = None,
                 fourcc: Optional[str] = None):
        import cv2

        self._cap = cv2.VideoCapture(node, cv2.CAP_V4L2)
        # Compressed USB cams: requesting MJPG (with cv2's built-in jpeg
        # decode) is how high resolutions reach full frame rate over USB2
        # — the role GStreamer's jpegdec plays in the reference's pipeline
        # (crates/chalkydri/src/cameras/pipeline.rs:92-101). fourcc config
        # values: "MJPG", "YUYV", ... (4 chars).
        if fourcc and len(fourcc) == 4:
            self._cap.set(
                cv2.CAP_PROP_FOURCC, cv2.VideoWriter_fourcc(*fourcc)
            )
        if width:
            self._cap.set(cv2.CAP_PROP_FRAME_WIDTH, width)
        if height:
            self._cap.set(cv2.CAP_PROP_FRAME_HEIGHT, height)
        if fps:
            self._cap.set(cv2.CAP_PROP_FPS, fps)
        # Exposure config parity (chalkydri_core/src/config.rs:64-65):
        # V4L2 convention: 1 = manual mode, 3 = aperture-priority auto.
        if not auto_exposure or manual_exposure is not None:
            self._cap.set(cv2.CAP_PROP_AUTO_EXPOSURE, 1)
            if manual_exposure is not None:
                self._cap.set(cv2.CAP_PROP_EXPOSURE, float(manual_exposure))
        else:
            self._cap.set(cv2.CAP_PROP_AUTO_EXPOSURE, 3)

        self._slot = None
        self._lock = threading.Lock()
        self._pending_exposure: Optional[int] = None  # mailbox, see below
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def set_exposure(self, value: int) -> None:
        """Runtime exposure update (the AAEC controller's actuator,
        subsystems/aaec.py). Non-blocking: the value lands in a mailbox the
        reader thread applies BETWEEN reads — cv2 documents concurrent
        read()/set() on one VideoCapture as not thread-safe, and holding a
        lock across the blocking read() would stall the app loop for up to
        a frame period per actuation (unbounded on a wedged device)."""
        with self._lock:
            self._pending_exposure = int(value)

    def _loop(self):
        import cv2

        while not self._stop.is_set():
            with self._lock:
                pending, self._pending_exposure = self._pending_exposure, None
            if pending is not None:
                # Manual mode first: V4L2 drivers silently drop
                # CAP_PROP_EXPOSURE writes while in auto mode (V4L2
                # convention: 1 = manual, 3 = aperture-priority auto).
                self._cap.set(cv2.CAP_PROP_AUTO_EXPOSURE, 1)
                self._cap.set(cv2.CAP_PROP_EXPOSURE, float(pending))
            ok, frame = self._cap.read()
            if not ok:
                time.sleep(0.05)
                continue
            if frame.ndim == 3:
                frame = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
            with self._lock:
                self._slot = (frame, time.monotonic_ns() // 1000)

    def latest(self):
        with self._lock:
            out, self._slot = self._slot, None
            return out

    def close(self):
        self._stop.set()
        self._thread.join(timeout=1.0)
        self._cap.release()


def build_gst_pipeline(
    source: str,
    node: str,
    width: int,
    height: int,
    fps: Optional[float],
    fourcc: Optional[str] = None,
) -> list[str]:
    """Build the gst-launch argv for a capture pipeline, mirroring the
    reference's GStreamer graph (``crates/chalkydri/src/cameras/
    pipeline.rs:76-165``): source -> (jpegdec for MJPG USB cams) ->
    videoconvert -> GRAY8 capsfilter -> fdsink. Rotation/flip stays
    host-side in ``_orient`` (the reference's videoflip), exposure via the
    V4L2 ioctl path.

    ``source``: "v4l2" (USB cams) or "libcamera" (Pi CSI camera stacks —
    the capability the cv2 shim can't reach; libcamerasrc is how the
    reference's GStreamer build talks to them).
    """
    if source == "libcamera":
        src = ["libcamerasrc"] + (
            [f"camera-name={node}"] if node and not node.startswith("/dev/")
            else []
        )
    else:
        src = ["v4l2src", f"device={node}"]
    dims = []
    if width:
        dims.append(f"width={int(width)}")
    if height:
        dims.append(f"height={int(height)}")
    if fps:
        dims.append(f"framerate={int(round(fps))}/1")
    caps_tail = ("," + ",".join(dims)) if dims else ""
    parts: list[str] = list(src)
    if fourcc == "MJPG":
        # Compressed wire format: negotiate JPEG at the source, decode in
        # the pipeline (the reference's jpegdec element, pipeline.rs:92-101).
        parts += ["!", f"image/jpeg{caps_tail}", "!", "jpegdec"]
    parts += [
        "!", "videoconvert",
        "!", f"video/x-raw,format=GRAY8{caps_tail}",
        # sync=false: never throttle to the clock — newest-frame latency
        # discipline, matching appsink sync=false (pipeline.rs:168-172).
        "!", "fdsink", "fd=1", "sync=false",
    ]
    return parts


class _GstCapture:
    """Capture via a ``gst-launch-1.0`` subprocess emitting raw GRAY8
    frames on stdout, read into the same depth-1 drop-oldest slot as
    ``_CvCapture``.

    This is the capture backend for camera stacks cv2/V4L2 can't open —
    Raspberry Pi CSI cameras via libcamerasrc — and for exercising the
    reference's exact GStreamer graph shape on hosts that have it
    (pipeline.rs:76-165). Selected with ``capture_backend = "gstreamer"``
    or ``"libcamera"`` in the camera config; requires the gst-launch
    binary (override with CHALKYDRI_GST_LAUNCH for tests)."""

    def __init__(self, node: str, width: int, height: int,
                 fps: Optional[float], source: str = "v4l2",
                 fourcc: Optional[str] = None):
        import shutil
        import subprocess

        binary = os.environ.get("CHALKYDRI_GST_LAUNCH", "gst-launch-1.0")
        if shutil.which(binary) is None:
            raise RuntimeError(f"{binary} not found")
        if not (width and height):
            raise ValueError("gstreamer capture needs explicit width/height "
                             "(frames are framed by size on the raw pipe)")
        self.width, self.height = int(width), int(height)
        argv = [binary, "-q"] + build_gst_pipeline(
            source, node, width, height, fps, fourcc=fourcc
        )
        self._proc = subprocess.Popen(
            argv, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
            bufsize=0,
        )
        self._slot = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.dead = False  # set when the subprocess exits; CamPipeline
        #                    re-opens (or falls back) instead of silently
        #                    never producing frames again
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        # GStreamer raw GRAY8 rows are stride-padded to 4 bytes
        # (GST_ROUND_UP_4); reading exactly width*height would skew every
        # frame after the first for widths not divisible by 4.
        stride = (self.width + 3) & ~3
        n = stride * self.height
        stdout = self._proc.stdout
        while not self._stop.is_set():
            chunks = []
            got = 0
            while got < n:
                chunk = stdout.read(n - got)
                if not chunk:  # EOF: pipeline exited (error or unplug)
                    self.dead = True
                    return
                chunks.append(chunk)
                got += len(chunk)
            frame = np.frombuffer(b"".join(chunks), np.uint8).reshape(
                self.height, stride
            )[:, : self.width]
            with self._lock:
                self._slot = (frame, time.monotonic_ns() // 1000)

    def latest(self):
        with self._lock:
            out, self._slot = self._slot, None
            return out

    def close(self):
        self._stop.set()
        self._proc.terminate()
        try:
            self._proc.wait(timeout=1.0)
        except Exception:
            self._proc.kill()
        self._thread.join(timeout=1.0)


class SyntheticCapture:
    """Deterministic synthetic camera: renders a moving 36h11 tag scene at a
    fixed rate. Used when the configured device is absent (dev machines, CI)
    so the full pipeline runs hardware-free (SURVEY.md section 4)."""

    N_PHASES = 24  # pre-rendered animation cycle (rendering 1 MP frames in
    #                numpy per poll would throttle the whole app loop)

    OPTIMAL_EXPOSURE = 100  # exposure at which the synthetic scene's
    #                         gradient metric peaks (see set_exposure)

    def __init__(self, width: int, height: int, fps: float = 30.0,
                 tag_ids=(3, 4), seed: int = 0, family: str = "tag36h11"):
        self.width = max(width, 160) or 640
        self.height = max(height, 120) or 480
        self._period_us = int(1e6 / fps)
        self._last_emit = 0
        self._n = 0
        self._tag_ids = tag_ids
        self.exposure = self.OPTIMAL_EXPOSURE
        from chalkydri_tpu_torch.detector.families import load_family

        self._family = load_family(family)
        self._cycle: list = []  # rendered scene per phase (uint8 — float32
        #                         here cost 4x the RSS and dominated soak
        #                         memory-drift readings)
        self._exposed: dict = {}  # phase -> exposed uint8 frame (current
        #                           exposure; cleared by set_exposure)

    def set_exposure(self, value: int) -> None:
        """Synthetic exposure model: emitted pixel = clip(lum * e/100) with
        scene luminance lum = 20 + 0.85*rendered (a real sensor's black has
        a photon floor — pure 0 would be exposure-invariant). The Sobel
        gradient metric is then unimodal in exposure with its peak near
        OPTIMAL_EXPOSURE: under-exposure compresses contrast, over-exposure
        saturates blacks and whites alike. Lets the AAEC loop be
        integration-tested hardware-free."""
        value = max(1, int(value))
        if value != self.exposure:
            self.exposure = value
            self._exposed.clear()  # re-expose cached frames lazily

    def latest(self):
        now = time.monotonic_ns() // 1000
        if now - self._last_emit < self._period_us:
            return None
        self._last_emit = now
        self._n += 1
        if len(self._cycle) < self.N_PHASES:
            self._cycle.append(_render_synthetic(
                self._family, self.width, self.height, self._tag_ids,
                len(self._cycle),
            ))
        phase = self._n % len(self._cycle)
        frame = self._exposed.get(phase)
        if frame is None:
            # Exposed pixel = clip(lum * e/E0) with scene luminance
            # lum = 20 + 0.85*rendered (see set_exposure) — an elementwise
            # function of the uint8 scene value, so ONE 256-entry LUT
            # replaces per-pixel float math (bit-identical result, no
            # megapixel float temps; applied once per (phase, exposure)).
            lut = np.clip(
                (20.0 + 0.85 * np.arange(256, dtype=np.float32))
                * (self.exposure / self.OPTIMAL_EXPOSURE),
                0, 255,
            ).astype(np.uint8)
            frame = lut[self._cycle[phase]]
            self._exposed[phase] = frame
        return frame, now

    def close(self):
        pass


def _render_synthetic(family, width, height, tag_ids, phase):
    """Render a frame with tags drifting sinusoidally."""
    from chalkydri_tpu_torch.detector.families import render_tag

    canvas = np.full((height, width), 150, np.uint8)
    for i, tid in enumerate(tag_ids):
        img = render_tag(family, tid, cell_px=max(4, height // 60))
        side = img.shape[0]
        cx = int(width * (0.3 + 0.4 * i) + 0.1 * width * np.sin(phase / 20 + i))
        cy = int(height * 0.5 + 0.1 * height * np.cos(phase / 17 + i))
        x0, y0 = cx - side // 2, cy - side // 2
        x0 = np.clip(x0, 0, width - side)
        y0 = np.clip(y0, 0, height - side)
        canvas[y0 : y0 + side, x0 : x0 + side] = img
    return canvas


class CamPipeline:
    """Per-camera capture source (CuSrcTask parity, pipeline.rs:274-392).

    ``process()`` is non-blocking: returns the newest frame with its
    time-of-validity, or a payload-less Stamped when no frame is ready /
    device absent (downstream skips, pipeline.rs:383-387).
    """

    def __init__(self, config: dict, synthetic_ok: bool = True):
        self.cam_id_str = config.get("id", "")
        self.name = config.get("name", "")
        self.width = int(config.get("width", 0) or 0)
        self.height = int(config.get("height", 0) or 0)
        self.fps = config.get("fps")
        self.orientation = config.get("orientation", "none")
        self.auto_exposure = bool(config.get("auto_exposure", True))
        self.manual_exposure = config.get("manual_exposure")
        # Capture wire format (e.g. "MJPG" for compressed USB cams, the
        # reference's jpegdec role; None = driver default).
        self.capture_fourcc = config.get("capture_format")
        # Capture backend: "v4l2" (default, cv2-backed), "gstreamer"
        # (gst-launch subprocess, reference graph shape), or "libcamera"
        # (gst-launch + libcamerasrc — Pi CSI camera stacks).
        self.capture_backend = str(config.get("capture_backend", "v4l2"))
        self._synthetic_ok = synthetic_ok
        # Synthetic-scene knobs (tests/dev only; ignored with real devices).
        self._synth_family = str(config.get("synthetic_family", "tag36h11"))
        self._synth_tag_ids = config.get("synthetic_tag_ids", (3, 4))
        self._cap = None
        self._was_present = False
        self._retry_after = 0.0  # monotonic gate on re-open attempts

    def start(self, clock: RobotClock) -> None:
        self._open()

    def _open(self):
        node = PROVIDER.devices().get(self.cam_id_str)
        if node is None and os.path.exists(self.cam_id_str):
            node = self.cam_id_str  # allow raw /dev/videoN ids
        if self.capture_backend in ("gstreamer", "libcamera"):
            # CSI/libcamera cameras have no /dev/videoN the provider can
            # see; the camera id itself names the libcamera device.
            try:
                self._cap = _GstCapture(
                    node or self.cam_id_str, self.width, self.height,
                    self.fps,
                    source=("libcamera" if self.capture_backend == "libcamera"
                            else "v4l2"),
                    fourcc=self.capture_fourcc,
                )
                self._was_present = True
                return
            except Exception:
                self._cap = None
        elif node is not None:
            try:
                self._cap = _CvCapture(
                    node, self.width, self.height, self.fps,
                    auto_exposure=self.auto_exposure,
                    manual_exposure=self.manual_exposure,
                    fourcc=self.capture_fourcc,
                )
                self._was_present = True
                return
            except Exception:
                self._cap = None

        if self._synthetic_ok:
            # The synthetic scene honors the chain's detector config so
            # heterogeneous (multi-family) rigs are testable hardware-free.
            self._cap = SyntheticCapture(
                self.width, self.height,
                family=self._synth_family,
                tag_ids=tuple(self._synth_tag_ids),
            )

    def set_exposure(self, value: int) -> None:
        if self._cap is not None and hasattr(self._cap, "set_exposure"):
            self._cap.set_exposure(value)

    def process(self, clock: RobotClock) -> Stamped:
        if self._cap is not None and getattr(self._cap, "dead", False):
            # The gst subprocess exited (caps negotiation error, crash,
            # camera unplug): close and re-open — next _open() retries the
            # backend or falls back to synthetic, instead of this camera
            # silently never producing a frame again.
            self._cap.close()
            self._cap = None
            self._retry_after = time.monotonic() + 1.0  # don't respawn a
            #   failing subprocess at app-loop rate
        if self._cap is None:
            if time.monotonic() < self._retry_after:
                return Stamped(None, Tov())
            self._open()
            if self._cap is None:
                return Stamped(None, Tov())
        item = self._cap.latest()
        if item is None:
            return Stamped(None, Tov())
        frame, _wall_us = item
        frame = _orient(frame, self.orientation)
        return Stamped(frame, Tov(clock.now_us()))

    def stop(self, clock: RobotClock) -> None:
        if self._cap is not None:
            self._cap.close()
            self._cap = None


# ---------------------------------------------------------------------------
# Device capability enumeration (configurator caps parity)
# ---------------------------------------------------------------------------
#
# The reference queries GStreamer device caps and lets the operator pick a
# supported (format, resolution, framerate) combination
# (``crates/configurator/src/main.rs:518-568``). Equivalent here via raw
# V4L2 ioctls (VIDIOC_ENUM_FMT / _FRAMESIZES / _FRAMEINTERVALS) — no
# GStreamer, no cv2, just fcntl on the device node. Absent devices fall
# back to a synthetic caps list so the configurator stays scriptable in CI.

_VIDIOC_ENUM_FMT = 0xC0405702
_VIDIOC_ENUM_FRAMESIZES = 0xC02C564A
_VIDIOC_ENUM_FRAMEINTERVALS = 0xC034564B
_V4L2_BUF_TYPE_VIDEO_CAPTURE = 1
_FRMSIZE_TYPE_DISCRETE = 1
_FRMIVAL_TYPE_DISCRETE = 1

SYNTHETIC_CAPS = [
    {"format": "SYNT", "width": w, "height": h, "fps": [30.0, 60.0]}
    for (w, h) in [(640, 480), (1280, 720), (1280, 800), (1600, 1304),
                   (1920, 1080)]
]


def _fourcc_str(v: int) -> str:
    return bytes((v >> s) & 0xFF for s in (0, 8, 16, 24)).decode(
        "ascii", "replace"
    )


def query_caps(node: str) -> list[dict]:
    """Enumerate a V4L2 capture device's formats/sizes/rates.

    Returns [{"format", "width", "height", "fps": [floats]}, ...]; the
    SYNTHETIC_CAPS list when the node can't be opened (absent device).
    """
    import fcntl
    import struct as _st

    try:
        fd = os.open(node, os.O_RDWR | os.O_NONBLOCK)
    except OSError:
        return list(SYNTHETIC_CAPS)
    caps = []
    try:
        fidx = 0
        while fidx < 64:
            # struct v4l2_fmtdesc: index, type, flags, description[32],
            # pixelformat, mbus_code, reserved[3]
            buf = bytearray(_st.pack("<III32sIIII", fidx,
                                     _V4L2_BUF_TYPE_VIDEO_CAPTURE,
                                     0, b"", 0, 0, 0, 0))
            try:
                fcntl.ioctl(fd, _VIDIOC_ENUM_FMT, buf)
            except OSError:
                break
            pixfmt = _st.unpack_from("<I", buf, 44)[0]
            sidx = 0
            while sidx < 64:
                # struct v4l2_frmsizeenum: index, pixel_format, type,
                # union(24 bytes), reserved[2]
                sbuf = bytearray(_st.pack("<III24xII", sidx, pixfmt, 0, 0, 0))
                try:
                    fcntl.ioctl(fd, _VIDIOC_ENUM_FRAMESIZES, sbuf)
                except OSError:
                    break
                stype = _st.unpack_from("<I", sbuf, 8)[0]
                if stype != _FRMSIZE_TYPE_DISCRETE:
                    # STEPWISE/CONTINUOUS (common on UVC cams): report the
                    # max geometry as one cap, then stop enumerating sizes.
                    # struct v4l2_frmsize_stepwise: min_w, max_w, step_w,
                    # min_h, max_h, step_h at the union offset.
                    _minw, maxw, _sw, _minh, maxh, _sh = _st.unpack_from(
                        "<6I", sbuf, 12
                    )
                    caps.append(
                        {"format": _fourcc_str(pixfmt), "width": int(maxw),
                         "height": int(maxh), "fps": []}
                    )
                    break
                w, h = _st.unpack_from("<II", sbuf, 12)
                fps = []
                iidx = 0
                while iidx < 16:
                    # struct v4l2_frmivalenum: index, pixel_format, width,
                    # height, type, union(24), reserved[2]
                    ibuf = bytearray(
                        _st.pack("<IIIII24xII", iidx, pixfmt, w, h, 0, 0, 0)
                    )
                    try:
                        fcntl.ioctl(fd, _VIDIOC_ENUM_FRAMEINTERVALS, ibuf)
                    except OSError:
                        break
                    itype = _st.unpack_from("<I", ibuf, 16)[0]
                    if itype != _FRMIVAL_TYPE_DISCRETE:
                        break
                    num, den = _st.unpack_from("<II", ibuf, 20)
                    if num:
                        fps.append(round(den / num, 2))
                    iidx += 1
                caps.append(
                    {"format": _fourcc_str(pixfmt), "width": int(w),
                     "height": int(h), "fps": fps}
                )
                sidx += 1
            fidx += 1
    finally:
        os.close(fd)
    return caps or list(SYNTHETIC_CAPS)
