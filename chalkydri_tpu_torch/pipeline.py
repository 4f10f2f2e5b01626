"""The fused multi-camera vision pipeline: frames -> robot poses (port of
``chalkydri_tpu/pipeline.py``).

Every camera's frame is one element of a leading batch axis, and on a
card ONE launch per iteration (the replay of a CUDA graph of the step,
``utils/graph.py``: the counterpart of the JAX package's jitted step)
runs

    grayscale frames [B, H, W] (or raw color, converted on device)
      -> AprilTag detect (threshold/CCL/cluster/quad/refine/decode)
      -> field-layout pose lookup per detected id
      -> lens unprojection of corners (per-camera intrinsics)
      -> batched SQPnP + gyro fusion
      -> poses, std-devs, validity, per-frame detections

on the rig's device. Host code around it only moves bytes (capture in,
UDP packets out). The rig state (field layout, per-camera intrinsics
[B, 9], robot->camera SE3, family codebook) is held as tensors on that
device; there are no weights.
"""

from __future__ import annotations

import json
import logging
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from chalkydri_tpu_torch.detector.families import (
    DEFAULT_BITS_CORRECTED,
    DEFAULT_FAMILY,
)
from chalkydri_tpu_torch.detector.grayscale import to_gray_device
from chalkydri_tpu_torch.detector.pipeline import Detections, Detector
from chalkydri_tpu_torch.geometry.camera import OpenCVModel5
from chalkydri_tpu_torch.geometry.field_layout import FieldLayout
from chalkydri_tpu_torch.geometry.tags import TAG_SIZE
from chalkydri_tpu_torch.geometry.transforms import (
    SE3,
    matrix_to_yaw,
    robot_to_cam_from_offsets,
)
from chalkydri_tpu_torch.solver.robot_pose import (
    SIGN_FLIP_CONST,
    solve_robot_pose,
)
from chalkydri_tpu_torch.utils.graph import CapturedStep
from chalkydri_tpu_torch.utils.precision import full_fp32
from chalkydri_tpu_torch.utils.tracing import stage, step_stamps


class VisionOutput(NamedTuple):
    """Everything the host needs to build wire packets."""

    pose_x: torch.Tensor  # [B]
    pose_y: torch.Tensor  # [B]
    pose_yaw: torch.Tensor  # [B]
    std_devs: torch.Tensor  # [B, 3]
    pose_valid: torch.Tensor  # [B] bool
    tag_count: torch.Tensor  # [B] int32
    detections: Detections


class FrameSolver(nn.Module):
    """``solver(dets, cam_params [B, 9], rc_rot, rc_t, gyro) ->
    (RobotPoseResult, n_tags [B])`` over a field layout (its tag tables
    are buffers): look up each detected id's tag pose, unproject the
    corners, solve."""

    def __init__(self, layout: FieldLayout, tag_size: float = TAG_SIZE,
                 sign_flip: float = SIGN_FLIP_CONST,
                 decision_margin_min: float = 0.0, dtype=torch.float32):
        super().__init__()
        self.register_buffer("rot_table", layout.rotations.to(dtype))
        self.register_buffer("t_table", layout.translations.to(dtype))
        self.register_buffer("present", layout.present)
        self.tag_size = tag_size
        self.sign_flip = sign_flip
        self.decision_margin_min = decision_margin_min

    def forward(self, dets: Detections, cam_params, rc_rot, rc_t, gyro):
        ids = dets.ids  # [B, D]
        idx = torch.clamp(ids, 0, self.present.shape[0] - 1).to(torch.int64)
        known = self.present[idx] & (ids >= 0) & dets.valid
        if self.decision_margin_min > 0:
            known = known & (dets.decision_margins > self.decision_margin_min)
        rays, conv = OpenCVModel5(cam_params).unproject(dets.corners)
        tag_ok = known & conv.all(dim=-1)  # drop tags with bad corners
        res = solve_robot_pose(self.rot_table[idx], self.t_table[idx], tag_ok,
                               rays, SE3(rc_rot, rc_t), gyro,
                               sign_change_error=self.sign_flip,
                               tag_size=self.tag_size)
        return res, tag_ok.sum(dim=-1).to(torch.int32)


def make_frame_solver(layout: FieldLayout, tag_size: float = TAG_SIZE,
                      sign_flip: float = SIGN_FLIP_CONST,
                      decision_margin_min: float = 0.0,
                      dtype=torch.float32) -> FrameSolver:
    """The ``FrameSolver`` over ``layout``, on the layout's device."""
    full_fp32()
    return FrameSolver(layout, tag_size=tag_size, sign_flip=sign_flip,
                       decision_margin_min=decision_margin_min, dtype=dtype)


class VisionPipeline(nn.Module):
    """``step(frames, gyro [B]) -> VisionOutput`` for a fixed rig: the
    detector, the frame solver and the per-camera intrinsics and
    robot->camera extrinsics (buffers). Frames are [B, H, W] uint8 GREY,
    or raw color in ``input_format``, converted on the frames' device
    (``detector.grayscale.to_gray_device``). On a card the step stamps
    its stages (``utils/tracing.py``): entry, then ``front`` and
    ``cluster`` (``Detector.detect``), ``quad``, ``refine`` and ``decode``
    (``make_post_cluster``) and ``solve`` here."""

    def __init__(self, detector: Detector, solver: FrameSolver,
                 camera_params: torch.Tensor, robot_to_cam: SE3,
                 input_format: str = "GREY"):
        super().__init__()
        self.detector = detector
        self.solver = solver
        self.input_format = input_format
        self.register_buffer("camera_params", camera_params.to(torch.float32))
        self.register_buffer("rc_rot", robot_to_cam.rotation.to(torch.float32))
        self.register_buffer("rc_t", robot_to_cam.translation.to(torch.float32))

    @torch.no_grad()
    def forward(self, frames: torch.Tensor, gyro: torch.Tensor) -> VisionOutput:
        with step_stamps(frames.device):
            dets = self.detector(to_gray_device(frames,
                                                fourcc=self.input_format))
            res, n_tags = self.solver(dets, self.camera_params, self.rc_rot,
                                      self.rc_t, gyro.to(torch.float32))
            out = VisionOutput(
                pose_x=res.position[:, 0],
                pose_y=res.position[:, 1],
                pose_yaw=matrix_to_yaw(res.rotation),
                std_devs=res.std_devs,
                pose_valid=res.valid & (n_tags > 0),
                tag_count=n_tags,
                detections=dets,
            )
            stage("solve")
        return out


def make_vision_pipeline(
    layout: FieldLayout,
    camera_params: torch.Tensor,  # [B, 9] per-camera OpenCVModel5 params
    robot_to_cam: SE3,  # [B, 3, 3] / [B, 3]
    family: str = DEFAULT_FAMILY,
    bits_corrected: int = DEFAULT_BITS_CORRECTED,
    tag_size: float = TAG_SIZE,
    sign_flip: float = SIGN_FLIP_CONST,
    decision_margin_min: float = 0.0,
    refine: bool = True,
    detector_kwargs: dict | None = None,
    input_format: str = "GREY",
    device: str | torch.device = "cuda",
) -> VisionPipeline | CapturedStep:
    """Build the rig's ``VisionPipeline`` with all its state on ``device``
    (the card unless the caller asks for the CPU). On a card it comes
    captured: a ``CapturedStep`` that replays a CUDA graph of the step
    (captured on the first call for each frame shape), with the eager
    ``VisionPipeline`` as its ``.module``. On the CPU it is the eager
    ``VisionPipeline``.

    ``detector_kwargs`` go to the ``Detector`` (``make_detector``'s
    keywords), less two keys that belong
    to other layers, as in the JAX package: ``ccl_impl`` (the multi-card
    spatial path's CCL choice) and ``capacity_fallback`` (a two-program
    dispatch with a host read, which the fused step does not make; it
    reports ``dropped_points`` instead)."""
    dk = dict(detector_kwargs or {})
    dk.pop("ccl_impl", None)
    if dk.pop("capacity_fallback", False):
        logging.getLogger(__name__).warning(
            "capacity_fallback is not applicable inside the fused pipeline; "
            "build make_detector(capacity_fallback=True) for the two-program "
            "dispatch")
    full_fp32()
    detector = Detector(family=family, bits_corrected=bits_corrected,
                        refine=refine, **dk)
    solver = make_frame_solver(layout, tag_size=tag_size, sign_flip=sign_flip,
                               decision_margin_min=decision_margin_min)
    pipe = VisionPipeline(detector, solver, camera_params, robot_to_cam,
                          input_format=input_format).to(device)
    if torch.device(device).type == "cuda":
        return CapturedStep(pipe)
    return pipe


def build_rig_from_config(cameras, layout: FieldLayout, device="cuda"):
    """Per-camera parameter batches from config camera entries: dicts with
    a ``calib`` JSON string and ``robot_to_cam`` offsets (JSON string or
    dict), or objects with ``calib`` and ``cam_offsets`` (translation in
    meters, rotation in degrees). Returns (params [B, 9], SE3 [B]) on
    ``device`` (the card unless the caller asks for the CPU)."""
    params, rc_rots, rc_ts = [], [], []
    for cam in cameras:
        calib = cam.get("calib") if isinstance(cam, dict) else cam.calib
        model = (OpenCVModel5.from_json(calib, dtype=torch.float32)
                 if calib else OpenCVModel5.zeros(dtype=torch.float32))
        params.append(model.params)
        if isinstance(cam, dict):
            rtc = cam.get("robot_to_cam")
        else:
            offs = cam.cam_offsets
            rtc = {"x": offs.translation.x, "y": offs.translation.y,
                   "z": offs.translation.z, "roll": offs.rotation.x,
                   "pitch": offs.rotation.y, "yaw": offs.rotation.z}
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


def rig_from_numpy(tag_rotations, tag_translations, tag_present,
                   camera_params, rc_rot, rc_t, device="cuda"):
    """The rig from plain arrays (e.g. another implementation's layout and
    camera batch): tag tables [T, 3, 3] / [T, 3] / [T] bool, intrinsics
    [B, 9], robot->camera [B, 3, 3] / [B, 3]. Returns (FieldLayout,
    params [B, 9] float32, SE3 [B] float32) on ``device`` (the card unless
    the caller asks for the CPU)."""

    def f32(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    layout = FieldLayout(
        rotations=f32(tag_rotations), translations=f32(tag_translations),
        present=torch.from_numpy(np.array(tag_present, dtype=bool)).to(device),
        field_size=(0.0, 0.0))
    return layout, f32(camera_params), SE3(f32(rc_rot), f32(rc_t))
