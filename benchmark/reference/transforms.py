# Frozen copy of chalkydri_tpu_torch/geometry/transforms.py for the benchmark's plain
# reference; imports rewritten to this package. Do not edit to follow
# the program: the reference is held still while the program changes.
"""Batched rigid-body transforms (SE3) and rotation utilities.

Port of ``chalkydri_tpu/geometry/transforms.py``. Conventions are the same:
rotations are [..., 3, 3] matrices, quaternions are (w, x, y, z)
scalar-first (the WPILib field-layout schema), Euler angles are intrinsic
roll/pitch/yaw with R = Rz(yaw) @ Ry(pitch) @ Rx(roll).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


def _matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", m, v)


class SE3(NamedTuple):
    """A rigid transform ``x -> R @ x + t`` with leading batch dims."""

    rotation: torch.Tensor  # [..., 3, 3]
    translation: torch.Tensor  # [..., 3]

    def apply(self, points: torch.Tensor) -> torch.Tensor:
        """Transform points of shape [..., 3]."""
        return _matvec(self.rotation, points) + self.translation

    def compose(self, other: "SE3") -> "SE3":
        """self o other: first apply ``other``, then ``self``."""
        rot = torch.einsum("...ij,...jk->...ik", self.rotation, other.rotation)
        t = _matvec(self.rotation, other.translation) + self.translation
        return SE3(rot, t)

    def inverse(self) -> "SE3":
        rot_t = self.rotation.transpose(-1, -2)
        return SE3(rot_t, -_matvec(rot_t, self.translation))


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(w, x, y, z) quaternion [..., 4] -> rotation matrix [..., 3, 3],
    normalizing first."""
    q = q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    w, x, y, z = q.unbind(-1)
    r = torch.stack(
        [
            1 - 2 * (y * y + z * z),
            2 * (x * y - w * z),
            2 * (x * z + w * y),
            2 * (x * y + w * z),
            1 - 2 * (x * x + z * z),
            2 * (y * z - w * x),
            2 * (x * z - w * y),
            2 * (y * z + w * x),
            1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.reshape(*q.shape[:-1], 3, 3)


def euler_to_matrix(roll: torch.Tensor, pitch: torch.Tensor,
                    yaw: torch.Tensor) -> torch.Tensor:
    """Roll/pitch/yaw -> rotation matrix, R = Rz(yaw) @ Ry(pitch) @ Rx(roll)."""
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    r = torch.stack(
        [
            cy * cp,
            cy * sp * sr - sy * cr,
            cy * sp * cr + sy * sr,
            sy * cp,
            sy * sp * sr + cy * cr,
            sy * sp * cr - cy * sr,
            -sp,
            cp * sr,
            cp * cr,
        ],
        dim=-1,
    )
    return r.reshape(*cy.shape, 3, 3)


def matrix_to_yaw(rot: torch.Tensor) -> torch.Tensor:
    """The Z (yaw) Euler angle of rotation matrices [..., 3, 3]."""
    return torch.atan2(rot[..., 1, 0], rot[..., 0, 0])


def wrap_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap to [-pi, pi): ``(theta + pi) mod 2 pi - pi`` (floored mod)."""
    return torch.remainder(theta + math.pi, 2 * math.pi) - math.pi


def smoothstep(x: torch.Tensor) -> torch.Tensor:
    """Hermite smoothstep on clamped x: x^2 (3 - 2x)."""
    x = torch.clamp(x, 0.0, 1.0)
    return x * x * (3.0 - 2.0 * x)


# NWU robot frame (x fwd, y left, z up) -> OpenCV camera frame (x right,
# y down, z fwd).
_NWU_TO_CV = ((0.0, 0.0, 1.0), (-1.0, 0.0, 0.0), (0.0, -1.0, 0.0))


def robot_to_cam_from_offsets(fwd_m, left_m, up_m, roll_deg, pitch_deg,
                              yaw_deg, dtype=torch.float64,
                              device=None) -> SE3:
    """The robot->camera(CV) isometry from NWU mounting offsets: the NWU
    camera pose on the robot composed with the NWU->CV basis change,
    inverted."""

    def to(v):
        return torch.as_tensor(v, dtype=dtype, device=device)

    nwu_rot = euler_to_matrix(torch.deg2rad(to(roll_deg)),
                              torch.deg2rad(to(pitch_deg)),
                              torch.deg2rad(to(yaw_deg)))
    nwu_t = torch.stack([to(fwd_m), to(left_m), to(up_m)], dim=-1)
    nwu_to_cv = SE3(to(_NWU_TO_CV), torch.zeros(3, dtype=dtype, device=device))
    return SE3(nwu_rot, nwu_t).compose(nwu_to_cv).inverse()
