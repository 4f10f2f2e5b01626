"""The plain reference of the whole step, frames -> detections -> robot
pose fused with the gyro: a frozen copy of ``chalkydri_tpu_torch/pipeline.py``
(``FrameSolver``, ``VisionPipeline``, ``build_rig_from_config``) over this
package's frozen detector and solver, eager, with no graph and no kernel.

``precision`` sets the float32 matmul policy the reference runs under:
``"fp32"`` (TF32 off, what the program states) or ``"tf32"`` (the control
of the correctness check: the nearest precision below)."""

from __future__ import annotations

import json
from typing import NamedTuple

import torch
from torch import nn

from .camera import OpenCVModel5
from .detector import Detections, Detector
from .families import DEFAULT_BITS_CORRECTED, DEFAULT_FAMILY
from .field_layout import FieldLayout
from .robot_pose import SIGN_FLIP_CONST, solve_robot_pose
from .tags import TAG_SIZE
from .transforms import SE3, matrix_to_yaw, robot_to_cam_from_offsets


def set_precision(precision: str) -> None:
    """TF32 off and "highest" matmuls (``"fp32"``), or TF32 on
    (``"tf32"``)."""
    if precision not in ("fp32", "tf32"):
        raise ValueError(f"precision {precision!r}: fp32 or tf32")
    tf32 = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")


class VisionOutput(NamedTuple):
    pose_x: torch.Tensor  # [B]
    pose_y: torch.Tensor  # [B]
    pose_yaw: torch.Tensor  # [B]
    std_devs: torch.Tensor  # [B, 3]
    pose_valid: torch.Tensor  # [B] bool
    tag_count: torch.Tensor  # [B] int32
    detections: Detections


class FrameSolver(nn.Module):
    """Look up each detected id's tag pose, unproject the corners, solve."""

    def __init__(self, layout: FieldLayout, tag_size: float = TAG_SIZE,
                 sign_flip: float = SIGN_FLIP_CONST, dtype=torch.float32):
        super().__init__()
        self.register_buffer("rot_table", layout.rotations.to(dtype))
        self.register_buffer("t_table", layout.translations.to(dtype))
        self.register_buffer("present", layout.present)
        self.tag_size = tag_size
        self.sign_flip = sign_flip

    def forward(self, dets: Detections, cam_params, rc_rot, rc_t, gyro):
        ids = dets.ids  # [B, D]
        idx = torch.clamp(ids, 0, self.present.shape[0] - 1).to(torch.int64)
        known = self.present[idx] & (ids >= 0) & dets.valid
        rays, conv = OpenCVModel5(cam_params).unproject(dets.corners)
        tag_ok = known & conv.all(dim=-1)  # drop tags with bad corners
        res = solve_robot_pose(self.rot_table[idx], self.t_table[idx], tag_ok,
                               rays, SE3(rc_rot, rc_t), gyro,
                               sign_change_error=self.sign_flip,
                               tag_size=self.tag_size)
        return res, tag_ok.sum(dim=-1).to(torch.int32)


class VisionPipeline(nn.Module):
    """``step(frames [B, H, W] uint8 GREY, gyro [B]) -> VisionOutput``."""

    def __init__(self, detector: Detector, solver: FrameSolver,
                 camera_params: torch.Tensor, robot_to_cam: SE3):
        super().__init__()
        self.detector = detector
        self.solver = solver
        self.register_buffer("camera_params", camera_params.to(torch.float32))
        self.register_buffer("rc_rot", robot_to_cam.rotation.to(torch.float32))
        self.register_buffer("rc_t", robot_to_cam.translation.to(torch.float32))

    @torch.no_grad()
    def forward(self, frames: torch.Tensor, gyro: torch.Tensor) -> VisionOutput:
        dets = self.detector(frames)
        res, n_tags = self.solver(dets, self.camera_params, self.rc_rot,
                                  self.rc_t, gyro.to(torch.float32))
        return VisionOutput(
            pose_x=res.position[:, 0],
            pose_y=res.position[:, 1],
            pose_yaw=matrix_to_yaw(res.rotation),
            std_devs=res.std_devs,
            pose_valid=res.valid & (n_tags > 0),
            tag_count=n_tags,
            detections=dets,
        )


def build_rig(cameras, layout: FieldLayout, device):
    """(params [B, 9], SE3 [B]) from camera entries: dicts with a ``calib``
    JSON string and ``robot_to_cam`` offsets (a JSON string or a dict)."""
    params, rc_rots, rc_ts = [], [], []
    for cam in cameras:
        calib = cam.get("calib")
        model = (OpenCVModel5.from_json(calib, dtype=torch.float32)
                 if calib else OpenCVModel5.zeros(dtype=torch.float32))
        params.append(model.params)
        rtc = cam.get("robot_to_cam")
        if isinstance(rtc, str):
            rtc = json.loads(rtc)
        rtc = rtc or {}
        iso = robot_to_cam_from_offsets(
            rtc.get("x", 0.0), rtc.get("y", 0.0), rtc.get("z", 0.0),
            rtc.get("roll", 0.0), rtc.get("pitch", 0.0), rtc.get("yaw", 0.0),
            dtype=torch.float32)
        rc_rots.append(iso.rotation)
        rc_ts.append(iso.translation)
    return (torch.stack(params).to(device),
            SE3(torch.stack(rc_rots).to(device), torch.stack(rc_ts).to(device)))


def make_reference(layout: FieldLayout, cameras, quad_decimate: int,
                   family: str = DEFAULT_FAMILY,
                   bits_corrected: int = DEFAULT_BITS_CORRECTED,
                   max_detections: int = 16, device="cpu") -> VisionPipeline:
    """The reference step of a rig (``cameras`` as for ``build_rig``)."""
    params, rc = build_rig(cameras, layout, device)
    det = Detector(family=family, bits_corrected=bits_corrected,
                   max_detections=max_detections, quad_decimate=quad_decimate)
    solver = FrameSolver(layout)
    return VisionPipeline(det, solver, params, rc).to(device)
