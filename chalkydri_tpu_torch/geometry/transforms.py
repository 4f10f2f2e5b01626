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


def matrix_to_quat(rot: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> (w, x, y, z) quaternion [..., 4], with
    w >= 0. Branch-free Shepperd's method: of the four candidate
    formulations, the one whose dominant component (trace, m00, m11 or
    m22; the first on ties) is largest is taken with a gather."""
    m00, m01, m02 = rot[..., 0, 0], rot[..., 0, 1], rot[..., 0, 2]
    m10, m11, m12 = rot[..., 1, 0], rot[..., 1, 1], rot[..., 1, 2]
    m20, m21, m22 = rot[..., 2, 0], rot[..., 2, 1], rot[..., 2, 2]
    tr = m00 + m11 + m22
    # four candidate quaternions (unnormalized), one per dominant component
    qw = torch.stack([1 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20],
                     dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21],
                     dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22],
                     dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)  # [..., 4 (case), 4 (wxyz)]
    diag = torch.stack([tr, m00, m11, m22], dim=-1)
    pos = torch.arange(4, device=rot.device)
    case = torch.where(diag == diag.amax(dim=-1, keepdim=True), pos,
                       4).amin(dim=-1).clamp(max=3)
    idx = case[..., None, None].expand(*case.shape, 1, 4)
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = q / torch.sqrt(torch.clamp(torch.sum(q * q, dim=-1, keepdim=True),
                                   min=1e-30))
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)  # canonical sign


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
