"""Driver-station MJPEG HTTP streamer.

Functional rebuild of the reference's dead-code ``MjpegProc``
(``crates/chalkydri/src/cameras/mjpeg.rs:18-144``): serve the
monitor's JPEG ring as ``multipart/x-mixed-replace`` with ``--frame``
boundaries at a capped rate (reference: <= 20 fps, 640x480, JPEG q50 —
mjpeg.rs:30-50,108-120), using only the standard library.
"""

from __future__ import annotations

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from chalkydri_tpu_torch.subsystems.monitor import FrameRing

BOUNDARY = b"frame"  # mjpeg.rs multipart boundary "--frame"
MAX_FPS = 20  # mjpeg.rs:30-50


class MjpegServer:
    """Serve FrameRings as MJPEG streams (and a trivial index at /).

    Accepts a single ring (served at ``/stream``) or
    a ``{path: ring}`` dict — e.g. ``{"/stream": preview_ring, "/field":
    field_view.ring}`` for the driver-station preview next to the top-down
    field/pose view (subsystems/field_view.py, the rerun 3D-state parity
    surface)."""

    def __init__(self, ring, host: str = "0.0.0.0", port: int = 8080,
                 max_fps: int = MAX_FPS):
        if isinstance(ring, FrameRing):
            self.rings = {"/stream": ring}
        else:
            self.rings = {
                ("/" + p.lstrip("/")): r for p, r in dict(ring).items()
            }
        self.ring = self.rings.get("/stream")
        self.max_fps = max_fps
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path.rstrip("/") in ("", "/index.html"):
                    imgs = "".join(
                        f"<div><h3>{p}</h3><img src='{p}'/></div>"
                        for p in sorted(outer.rings)
                    )
                    body = f"<html><body>{imgs}</body></html>".encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                target = outer.rings.get(self.path.rstrip("/") or self.path)
                if target is None:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    f"multipart/x-mixed-replace; boundary={BOUNDARY.decode()}",
                )
                self.end_headers()
                period = 1.0 / outer.max_fps
                last_ts = None
                try:
                    while True:
                        item = target.latest()
                        if item is not None and item[0] != last_ts:
                            last_ts, jpeg = item
                            self.wfile.write(b"--" + BOUNDARY + b"\r\n")
                            self.wfile.write(b"Content-Type: image/jpeg\r\n")
                            self.wfile.write(
                                f"Content-Length: {len(jpeg)}\r\n\r\n".encode()
                            )
                            self.wfile.write(jpeg)
                            self.wfile.write(b"\r\n")
                            self.wfile.flush()
                        time.sleep(period)
                except (BrokenPipeError, ConnectionResetError):
                    return

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True, name="mjpeg-http"
        )

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
