"""Unified structured logging with offline replay.

Rebuild of Copper's unified logger surface used by the reference
(``basic_copper_setup("chalkydri.copper")``,
``crates/chalkydri/src/main.rs:103-108``; export CLI
``crates/chalkydri/src/bin/logread.rs:1-9``; per-node ``logging:`` toggles in
the RON graph, SURVEY.md section 5.4): every frame arrival and pose publish
is appended to a binary log with its time-of-validity, so a session can be
replayed offline through the pipeline (record/replay debugging without the
robot).

Format: sequential records, each
  [u8 kind][u64 tov_us][u32 payload_len][payload]
kinds: 1 = frame (payload: u8 cam_id, u16 h, u16 w, raw gray bytes),
       2 = pose  (payload: u8 cam_id, u64 latency_us, 64-byte packet),
       3 = meta  (payload: UTF-8 JSON).
"""

from __future__ import annotations

import json
import struct
from typing import Iterator, Optional

import numpy as np

from chalkydri_tpu_torch.io.whacknet import (
    RobotPose,
    VisionUncertainty,
    decode_measurement,
    encode_measurement,
)

MAGIC = b"CKTPULOG1\n"
KIND_FRAME = 1
KIND_POSE = 2
KIND_META = 3

_HDR = struct.Struct("<BQI")


class UnifiedLogger:
    def __init__(self, path: str, meta: Optional[dict] = None):
        self._f = open(path, "wb")
        self._f.write(MAGIC)
        if meta:
            self._write(KIND_META, 0, json.dumps(meta).encode())

    def _write(self, kind: int, tov_us: int, payload: bytes) -> None:
        self._f.write(_HDR.pack(kind, tov_us, len(payload)))
        self._f.write(payload)

    def log_frame(self, cam_id: int, tov_us: Optional[int], frame: np.ndarray) -> None:
        frame = np.ascontiguousarray(frame, dtype=np.uint8)
        h, w = frame.shape[:2]
        payload = struct.pack("<BHH", cam_id & 0xFF, h, w) + frame.tobytes()
        self._write(KIND_FRAME, tov_us or 0, payload)

    def log_pose(self, cam_id: int, latency_us: int, pose: RobotPose,
                 std: VisionUncertainty) -> None:
        pkt = encode_measurement(pose, std, latency_us, cam_id, 0)
        payload = struct.pack("<BQ", cam_id & 0xFF, latency_us) + pkt
        self._write(KIND_POSE, latency_us, payload)

    def close(self) -> None:
        self._f.close()


def read_log(path: str) -> Iterator[dict]:
    """Iterate records as dicts (the logread export surface,
    src/bin/logread.rs:4-8)."""
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError("not a chalkydri-tpu unified log")
        while True:
            hdr = f.read(_HDR.size)
            if len(hdr) < _HDR.size:
                return
            kind, tov, ln = _HDR.unpack(hdr)
            payload = f.read(ln)
            if len(payload) < ln:
                return
            if kind == KIND_FRAME:
                cam, h, w = struct.unpack_from("<BHH", payload)
                frame = np.frombuffer(payload, np.uint8, h * w, 5).reshape(h, w)
                yield {"kind": "frame", "tov_us": tov, "cam_id": cam, "frame": frame}
            elif kind == KIND_POSE:
                cam, latency = struct.unpack_from("<BQ", payload)
                pose, std, ts, cam2, n = decode_measurement(payload[9:])
                yield {
                    "kind": "pose", "tov_us": tov, "cam_id": cam,
                    "latency_us": latency, "pose": pose, "std": std,
                    "tag_count": n,
                }
            elif kind == KIND_META:
                yield {"kind": "meta", "meta": json.loads(payload.decode())}


def replay_frames(path: str):
    """Yield (cam_id, tov_us, frame) for feeding back through a pipeline."""
    for rec in read_log(path):
        if rec["kind"] == "frame":
            yield rec["cam_id"], rec["tov_us"], rec["frame"]
