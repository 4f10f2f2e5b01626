"""Robot-pose layer on top of SQPnP: std-devs, gyro disambiguation and
pivot (port of ``chalkydri_tpu/solver/robot_pose.py``), batched over
frames.

Constants: XY_STD_DEV_SCALAR = 5, THETA_STD_DEV_SCALAR = 2,
MAX_TRUSTABLE_RMS = 0.1 (std-devs go to the dtype max above it),
MAX_GYRO_DELTA = 30 deg (full pivot to the gyro heading at and after it),
SIGN_FLIP_CONST = 600 (the gyro energy penalty weight).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from chalkydri_tpu_torch.geometry.tags import TAG_SIZE, corners_world
from chalkydri_tpu_torch.geometry.transforms import (
    SE3,
    matrix_to_yaw,
    smoothstep,
    wrap_angle,
)
from chalkydri_tpu_torch.solver.sqpnp import MAX_ITER, solve_sqpnp

XY_STD_DEV_SCALAR = 5.0
THETA_STD_DEV_SCALAR = 2.0
MAX_TRUSTABLE_RMS = 0.1
MAX_GYRO_DELTA_DEG = 30.0
SIGN_FLIP_CONST = 600.0


class RobotPoseResult(NamedTuple):
    rotation: torch.Tensor  # [B, 3, 3] robot rotation in world (gyro-pivoted)
    position: torch.Tensor  # [B, 3]
    std_devs: torch.Tensor  # [B, 3] (x, y, theta)
    valid: torch.Tensor  # [B] bool


def compute_std_devs(pure_energy, distance, n_tags, dtype):
    """Distance- and tag-count-scaled measurement std-devs; above
    MAX_TRUSTABLE_RMS they go to the dtype max (vision auto-distrust)."""
    n_points = n_tags.to(dtype) * 4.0
    rms = torch.sqrt(torch.clamp(pure_energy, min=0.0)
                     / torch.clamp(n_points, min=1.0))
    mult = 1.0 + distance / TAG_SIZE
    sqrt_n = torch.sqrt(torch.clamp(n_tags.to(dtype), min=1.0))
    xy = torch.clamp(rms * mult / sqrt_n * XY_STD_DEV_SCALAR, 0.01, 10.0)
    theta = torch.clamp((rms / TAG_SIZE) * mult / sqrt_n * THETA_STD_DEV_SCALAR,
                        0.05, math.pi)
    big = torch.finfo(dtype).max
    distrust = rms > MAX_TRUSTABLE_RMS
    xy = torch.where(distrust, big, xy)
    theta = torch.where(distrust, big, theta)
    return torch.stack([xy, xy, theta], dim=-1)


def solve_robot_pose(
    tag_rotations: torch.Tensor,  # [B, T, 3, 3] world tag rotations (padded)
    tag_translations: torch.Tensor,  # [B, T, 3]
    tag_mask: torch.Tensor,  # [B, T] bool
    camera_rays: torch.Tensor,  # [B, T, 4, 3] unprojected corner rays
    robot_to_cam: SE3,  # [B, 3, 3] / [B, 3] robot -> camera(CV)
    gyro: torch.Tensor,  # [B] gyro heading (rad)
    sign_change_error: float = SIGN_FLIP_CONST,
    max_iter: int = MAX_ITER,
    tag_size: float = TAG_SIZE,
) -> RobotPoseResult:
    """Batched robot pose: world->cam SQPnP over every visible tag's four
    corners, std-devs from the pure energy, robot pose =
    (world->cam)^-1 o robot_to_cam, then the yaw pivot toward the gyro
    heading, smoothstep-weighted by the yaw delta, about the tag
    centroid."""
    dtype = tag_translations.dtype
    lead = tag_rotations.shape[:-3]
    t_cap = tag_rotations.shape[-3]
    world_pts = corners_world(SE3(tag_rotations, tag_translations), tag_size)
    world_flat = world_pts.reshape(*lead, t_cap * 4, 3)
    rays_flat = camera_rays.reshape(*lead, t_cap * 4, 3)
    mask_flat = tag_mask.repeat_interleave(4, dim=-1)
    fwd_in_cam = robot_to_cam.rotation[..., :, 0]

    def ground_plane_plausibility(r_mats, t_all):
        """|robot z| per candidate: the physical tiebreak for the planar
        two-fold ambiguity (the robot drives on the floor, z = 0)."""
        rc = SE3(robot_to_cam.rotation[..., None, :, :],
                 robot_to_cam.translation[..., None, :])
        t_world_robot = SE3(r_mats, t_all).inverse().compose(rc)
        return torch.abs(t_world_robot.translation[..., 2])

    res = solve_sqpnp(world_flat, rays_flat, mask_flat, fwd_in_cam,
                      torch.cos(gyro), torch.sin(gyro), sign_change_error,
                      max_iter=max_iter, plaus_fn=ground_plane_plausibility)

    n_tags = tag_mask.sum(dim=-1)
    distance = torch.sqrt(torch.sum(res.translation * res.translation, dim=-1))
    std_devs = compute_std_devs(res.energy, distance, n_tags, dtype)

    t_world_robot = SE3(res.rotation, res.translation).inverse().compose(
        robot_to_cam)
    robot_pos = t_world_robot.translation
    robot_rot = t_world_robot.rotation
    tag_centroid = ((tag_translations * tag_mask.to(dtype)[..., None]).sum(dim=-2)
                    / torch.clamp(n_tags.to(dtype), min=1.0)[..., None])

    vision_yaw = matrix_to_yaw(robot_rot)
    delta_yaw = wrap_angle(gyro - vision_yaw)
    delta_deg = torch.abs(torch.rad2deg(delta_yaw))
    applied = delta_yaw * smoothstep(delta_deg / MAX_GYRO_DELTA_DEG)
    c, s = torch.cos(applied), torch.sin(applied)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    rot_z = torch.stack([c, -s, zero, s, c, zero, zero, zero, one],
                        dim=-1).reshape(*c.shape, 3, 3)
    pivoted_pos = tag_centroid + (rot_z @ (robot_pos - tag_centroid)[..., None])[..., 0]
    return RobotPoseResult(rotation=rot_z @ robot_rot, position=pivoted_pos,
                           std_devs=std_devs, valid=res.valid)


def solve_robot_pose_batched(
    tag_rotations: torch.Tensor,  # [B, T, 3, 3]
    tag_translations: torch.Tensor,  # [B, T, 3]
    tag_mask: torch.Tensor,  # [B, T]
    camera_rays: torch.Tensor,  # [B, T, 4, 3]
    robot_to_cam_rot: torch.Tensor,  # [B, 3, 3]
    robot_to_cam_t: torch.Tensor,  # [B, 3]
    gyro: torch.Tensor,  # [B]
    sign_change_error: float = SIGN_FLIP_CONST,
    max_iter: int = MAX_ITER,
    tag_size: float = TAG_SIZE,
) -> RobotPoseResult:
    """``solve_robot_pose`` with the robot->camera transform given as its
    rotation and translation (one camera frame per batch element)."""
    return solve_robot_pose(
        tag_rotations, tag_translations, tag_mask, camera_rays,
        SE3(robot_to_cam_rot, robot_to_cam_t), gyro,
        sign_change_error=sign_change_error, max_iter=max_iter,
        tag_size=tag_size)


class SqPnP:
    """Builder facade of the reference's ``SqPnP`` API:
    ``SqPnP().max_iter(n).tolerance(t).solve_robot_pose(...)``. Stateless:
    each builder call returns a new facade, each solve is one
    ``solve_robot_pose`` call. The tolerance is kept for the API; the
    solver's Newton loop runs its ``max_iter`` masked steps."""

    def __init__(self, max_iter: int = MAX_ITER, tol: float = 1e-8):
        self._max_iter = max_iter
        self._tol = tol

    def max_iter(self, n: int) -> "SqPnP":
        return SqPnP(n, self._tol)

    def tolerance(self, tol: float) -> "SqPnP":
        return SqPnP(self._max_iter, tol)

    def solve_robot_pose(self, tag_rotations, tag_translations, tag_mask,
                         camera_rays, robot_to_cam: SE3, gyro,
                         sign_change_error=SIGN_FLIP_CONST) -> RobotPoseResult:
        return solve_robot_pose(
            tag_rotations, tag_translations, tag_mask, camera_rays,
            robot_to_cam, gyro, sign_change_error=sign_change_error,
            max_iter=self._max_iter)
