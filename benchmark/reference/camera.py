# Frozen copy of chalkydri_tpu_torch/geometry/camera.py for the benchmark's plain
# reference; imports rewritten to this package. Do not edit to follow
# the program: the reference is held still while the program changes.
"""Batched OpenCV 5-parameter lens model (port of
``chalkydri_tpu/geometry/camera.py``).

Parameters are a flat [..., 9] tensor ordered (fx, fy, cx, cy, k1, k2, p1,
p2, k3), parsed from the reference's calib JSON:

    {"OpenCVModel5": {"fx": ..., "fy": ..., "cx": ..., "cy": ...,
                      "k1": ..., "k2": ..., "p1": ..., "p2": ..., "k3": ...,
                      "width": ..., "height": ...}}
"""

from __future__ import annotations

import json
from typing import NamedTuple

import torch


PARAM_NAMES = ("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3")
UNDISTORT_ITERS = 20


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1))


class OpenCVModel5(NamedTuple):
    """OpenCV 5-distortion-coefficient pinhole model. ``params`` [..., 9]
    broadcasts against the leading dims of the points it maps."""

    params: torch.Tensor  # [..., 9]
    width: int = 0
    height: int = 0

    @staticmethod
    def from_dict(d: dict, dtype=torch.float64, device=None) -> "OpenCVModel5":
        """Parse the inner dict of the calib JSON (the ``OpenCVModel5``
        value)."""
        params = torch.tensor([float(d[k]) for k in PARAM_NAMES], dtype=dtype,
                              device=device)
        return OpenCVModel5(params, int(d.get("width", 0)),
                            int(d.get("height", 0)))

    @staticmethod
    def from_json(s: str, dtype=torch.float64, device=None) -> "OpenCVModel5":
        """Parse the reference's calib JSON string."""
        outer = json.loads(s)
        if "OpenCVModel5" in outer:
            outer = outer["OpenCVModel5"]
        return OpenCVModel5.from_dict(outer, dtype=dtype, device=device)

    @staticmethod
    def zeros(dtype=torch.float64, device=None) -> "OpenCVModel5":
        """The unconfigured camera (all-zero parameters)."""
        return OpenCVModel5(torch.zeros(9, dtype=dtype, device=device), 0, 0)

    @property
    def fx(self) -> torch.Tensor:
        return self.params[..., 0]

    @property
    def fy(self) -> torch.Tensor:
        return self.params[..., 1]

    @property
    def cx(self) -> torch.Tensor:
        return self.params[..., 2]

    @property
    def cy(self) -> torch.Tensor:
        return self.params[..., 3]

    @property
    def dist(self) -> torch.Tensor:
        """(k1, k2, p1, p2, k3)."""
        return self.params[..., 4:9]

    def _p(self, i: int, lead: int) -> torch.Tensor:
        """Parameter ``i`` with ``lead`` trailing singleton dims, so a
        [B, 9] model broadcasts over [B, ...] points."""
        p = self.params[..., i]
        return p.reshape(*p.shape, *([1] * lead))

    def distort(self, xn: torch.Tensor) -> torch.Tensor:
        """Radial + tangential distortion of normalized coords [..., 2]."""
        lead = xn.dim() - 1 - (self.params.dim() - 1)
        k1, k2, p1, p2, k3 = (self._p(i, lead) for i in range(4, 9))
        x, y = xn[..., 0], xn[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        xy2 = 2.0 * x * y
        xd = x * radial + p1 * xy2 + p2 * (r2 + 2.0 * x * x)
        yd = y * radial + p2 * xy2 + p1 * (r2 + 2.0 * y * y)
        return torch.stack([xd, yd], dim=-1)

    def project(self, points_cam: torch.Tensor):
        """Camera-frame points [..., 3] -> (pixels [..., 2], valid z > 0)."""
        lead = points_cam.dim() - 1 - (self.params.dim() - 1)
        z = points_cam[..., 2]
        valid = z > 1e-9
        zs = torch.where(valid, z, torch.ones_like(z))
        xd = self.distort(points_cam[..., :2] / zs[..., None])
        u = self._p(0, lead) * xd[..., 0] + self._p(2, lead)
        v = self._p(1, lead) * xd[..., 1] + self._p(3, lead)
        return torch.stack([u, v], dim=-1), valid

    def undistort(self, xd: torch.Tensor, iters: int = UNDISTORT_ITERS):
        """Invert the distortion by ``iters`` Newton steps on the analytic
        2x2 Jacobian. Returns (normalized coords [..., 2], converged)."""
        lead = xd.dim() - 1 - (self.params.dim() - 1)
        k1, k2, p1, p2, k3 = (self._p(i, lead) for i in range(4, 9))
        xn = xd
        for _ in range(iters):
            x, y = xn[..., 0], xn[..., 1]
            r2 = x * x + y * y
            radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
            dradial_dr2 = k1 + r2 * (2.0 * k2 + 3.0 * k3 * r2)
            fx_ = x * radial + p1 * 2.0 * x * y + p2 * (r2 + 2.0 * x * x)
            fy_ = y * radial + p2 * 2.0 * x * y + p1 * (r2 + 2.0 * y * y)
            j00 = radial + x * dradial_dr2 * 2.0 * x + 2.0 * p1 * y + 6.0 * p2 * x
            j01 = x * dradial_dr2 * 2.0 * y + 2.0 * p1 * x + 2.0 * p2 * y
            j10 = y * dradial_dr2 * 2.0 * x + 2.0 * p2 * y + 2.0 * p1 * x
            j11 = radial + y * dradial_dr2 * 2.0 * y + 2.0 * p2 * x + 6.0 * p1 * y
            det = j00 * j11 - j01 * j10
            det = torch.where(torch.abs(det) < 1e-12, torch.ones_like(det), det)
            rx = fx_ - xd[..., 0]
            ry = fy_ - xd[..., 1]
            dx = (j11 * rx - j01 * ry) / det
            dy = (-j10 * rx + j00 * ry) / det
            xn = torch.stack([x - dx, y - dy], dim=-1)
        converged = _norm(self.distort(xn) - xd) < 1e-6
        return xn, converged

    def unproject(self, pixels: torch.Tensor):
        """Pixels [..., 2] -> (normalized camera rays [..., 3] with z = 1,
        converged mask)."""
        lead = pixels.dim() - 1 - (self.params.dim() - 1)
        xd = torch.stack(
            [(pixels[..., 0] - self._p(2, lead)) / self._p(0, lead),
             (pixels[..., 1] - self._p(3, lead)) / self._p(1, lead)],
            dim=-1,
        )
        xn, converged = self.undistort(xd)
        rays = torch.cat([xn, torch.ones_like(xn[..., :1])], dim=-1)
        return rays, converged
