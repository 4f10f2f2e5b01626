"""Camera intrinsics calibration from aprilgrid board views (port of
``chalkydri_tpu/tools/calibration.py``).

Replaces the reference's external ``camera-intrinsic-calibration`` +
``aprilgrid`` crates (``configurator/src/calibration.rs:4-11,110-142``):
views of a 6x6 aprilgrid board go through the production detector
(kernels B1 + B2 at ``quad_decimate=2``), are kept as (board 3D, image 2D)
correspondences, and are solved for an ``OpenCVModel5``:

1. Zhang's closed-form init on the host (numpy: homography per view ->
   image of the absolute conic -> K; extrinsics from K^-1 H), the JAX
   package's arithmetic line for line,
2. a joint Levenberg-Marquardt-damped Gauss-Newton over
   [fx, fy, cx, cy, k1, k2, p1, p2, k3] and every view's pose, in float64
   on the device: one batched residual over all views through the
   production lens model (``geometry/camera.py``), its Jacobian by
   ``torch.func.jacfwd``, and one host read of the cost per iteration.

Reference knobs kept: 6x6 board, MIN_CORNERS = 24 per view
(``calibration.rs:33-35,76``), up to 5 solve attempts
(``calibration.rs:110-142``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from chalkydri_tpu_torch.geometry.camera import OpenCVModel5
from chalkydri_tpu_torch.utils.platform import resolve_device

MIN_CORNERS = 24  # configurator/src/calibration.rs:76
BOARD_ROWS = 6
BOARD_COLS = 6
MAX_ATTEMPTS = 5  # calibration.rs:110-142


@dataclass
class FrameFeature:
    """One calibration view: matched board/image corner sets."""

    points_3d: np.ndarray  # [N, 3] board frame (z = 0 plane)
    points_2d: np.ndarray  # [N, 2] pixels


def aprilgrid_board_corners(tag_size: float = 0.022, spacing_ratio: float = 0.3):
    """{tag id on the board: [4, 3] corners} of a 6x6 aprilgrid (tags in a
    ROWS x COLS grid, separation ``spacing_ratio * tag_size``), corners in
    the detector's order (BL, BR, TR, TL)."""
    pitch = tag_size * (1.0 + spacing_ratio)
    out = {}
    for r in range(BOARD_ROWS):
        for c in range(BOARD_COLS):
            x0, y0 = c * pitch, r * pitch
            out[r * BOARD_COLS + c] = np.array(
                [
                    [x0, y0, 0.0],
                    [x0 + tag_size, y0, 0.0],
                    [x0 + tag_size, y0 + tag_size, 0.0],
                    [x0, y0 + tag_size, 0.0],
                ]
            )
    return out


def feature_from_detections(ids, corners, board=None) -> Optional[FrameFeature]:
    """The FrameFeature of one view's detections (ids [D], >= 0 valid;
    corners [D, 4, 2]), or None when fewer than MIN_CORNERS corners match
    the board (calibration.rs:76)."""
    board = board or aprilgrid_board_corners()
    p3, p2 = [], []
    for i, tid in enumerate(np.asarray(ids)):
        tid = int(tid)
        if tid < 0 or tid not in board:
            continue
        p3.append(board[tid])
        p2.append(np.asarray(corners[i]))
    if not p3:
        return None
    p3 = np.concatenate(p3)
    p2 = np.concatenate(p2)
    if len(p3) < MIN_CORNERS:
        return None
    return FrameFeature(points_3d=p3, points_2d=p2)


# ---------------------------------------------------------------------------
# Zhang closed-form initialization (host, numpy)
# ---------------------------------------------------------------------------


def _homography(p3, p2) -> np.ndarray:
    """DLT homography board (x, y) -> pixels, normalized."""
    n = len(p3)
    a = np.zeros((2 * n, 9))
    for i in range(n):
        x, y = p3[i, 0], p3[i, 1]
        u, v = p2[i]
        a[2 * i] = [x, y, 1, 0, 0, 0, -u * x, -u * y, -u]
        a[2 * i + 1] = [0, 0, 0, x, y, 1, -v * x, -v * y, -v]
    _, _, vt = np.linalg.svd(a)
    h = vt[-1].reshape(3, 3)
    return h / h[2, 2]


def _zhang_init(features: list[FrameFeature]) -> np.ndarray:
    """Closed-form K from the image of the absolute conic."""
    hs = [_homography(f.points_3d, f.points_2d) for f in features]

    def v_ij(h, i, j):
        return np.array(
            [
                h[0, i] * h[0, j],
                h[0, i] * h[1, j] + h[1, i] * h[0, j],
                h[1, i] * h[1, j],
                h[2, i] * h[0, j] + h[0, i] * h[2, j],
                h[2, i] * h[1, j] + h[1, i] * h[2, j],
                h[2, i] * h[2, j],
            ]
        )

    rows = []
    for h in hs:
        rows.append(v_ij(h, 0, 1))
        rows.append(v_ij(h, 0, 0) - v_ij(h, 1, 1))
    v = np.stack(rows)
    _, _, vt = np.linalg.svd(v)
    b11, b12, b22, b13, b23, b33 = vt[-1]

    cy = (b12 * b13 - b11 * b23) / (b11 * b22 - b12 * b12)
    lam = b33 - (b13 * b13 + cy * (b12 * b13 - b11 * b23)) / b11
    fx = np.sqrt(abs(lam / b11))
    fy = np.sqrt(abs(lam * b11 / (b11 * b22 - b12 * b12)))
    cx = -b13 * fx * fx / lam
    return np.array([fx, fy, cx, cy, 0.0, 0.0, 0.0, 0.0, 0.0])


def _pose_from_homography(k: np.ndarray, h: np.ndarray):
    kinv = np.linalg.inv(k)
    h1, h2, h3 = h[:, 0], h[:, 1], h[:, 2]
    lam = 1.0 / np.linalg.norm(kinv @ h1)
    r1 = lam * (kinv @ h1)
    r2 = lam * (kinv @ h2)
    r3 = np.cross(r1, r2)
    t = lam * (kinv @ h3)
    r = np.stack([r1, r2, r3], axis=1)
    u, _, vt = np.linalg.svd(r)
    r = u @ vt
    if np.linalg.det(r) < 0:
        r = -r
    if t[2] < 0:  # the board must be in front of the camera
        r[:, 0:2] *= -1
        t = -t
    return r, t


def _rvec_from_matrix(r: np.ndarray) -> np.ndarray:
    import scipy.spatial.transform as sst

    return sst.Rotation.from_matrix(r).as_rotvec()


# ---------------------------------------------------------------------------
# Gauss-Newton refinement (torch, float64, on the device)
# ---------------------------------------------------------------------------


def _rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Rotation vectors [F, 3] -> matrices [F, 3, 3]:
    I + sin(t) K + (1 - cos(t)) K^2 with t = |rvec| + 1e-12 and K the
    cross-product matrix of rvec / t."""
    theta = torch.sqrt(torch.sum(rvec * rvec, dim=-1)) + 1e-12  # [F]
    k = rvec / theta[:, None]
    zero = torch.zeros_like(k[:, 0])
    kx = torch.stack(
        [zero, -k[:, 2], k[:, 1],
         k[:, 2], zero, -k[:, 0],
         -k[:, 1], k[:, 0], zero], dim=-1).reshape(-1, 3, 3)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    return (eye + torch.sin(theta)[:, None, None] * kx
            + (1.0 - torch.cos(theta))[:, None, None] * (kx @ kx))


@dataclass
class CalibrationResult:
    params: np.ndarray  # [9] OpenCVModel5 ordering
    rms_px: float
    n_frames: int
    steps_accepted: int = 0  # Gauss-Newton steps taken of the iterations

    def to_model(self, width: int = 0, height: int = 0,
                 device: str | torch.device = "cuda") -> OpenCVModel5:
        return OpenCVModel5(
            torch.as_tensor(self.params, dtype=torch.float64,
                            device=resolve_device(device)), width, height)


def calibrate_camera(
    features: list[FrameFeature],
    iters: int = 30,
    point_cap: int = 144,
    device: str | torch.device = "cuda",
) -> CalibrationResult:
    """Full intrinsics solve from accumulated view features: the Zhang
    init on the host, then ``iters`` damped Gauss-Newton iterations on
    ``device`` in float64."""
    dev = resolve_device(device)
    feats = [f for f in features if len(f.points_3d) >= MIN_CORNERS]
    if len(feats) < 3:
        raise ValueError("need at least 3 usable calibration frames")

    k0 = _zhang_init(feats)
    kmat = np.array(
        [[k0[0], 0, k0[2]], [0, k0[1], k0[3]], [0, 0, 1]]
    )

    # Pad every view to point_cap correspondences with masks.
    f = len(feats)
    p3 = np.zeros((f, point_cap, 3))
    p2 = np.zeros((f, point_cap, 2))
    msk = np.zeros((f, point_cap), bool)
    rvecs = np.zeros((f, 3))
    tvecs = np.zeros((f, 3))
    for i, feat in enumerate(feats):
        n = min(len(feat.points_3d), point_cap)
        p3[i, :n] = feat.points_3d[:n]
        p2[i, :n] = feat.points_2d[:n]
        msk[i, :n] = True
        h = _homography(feat.points_3d, feat.points_2d)
        r, t = _pose_from_homography(kmat, h)
        rvecs[i] = _rvec_from_matrix(r)
        tvecs[i] = t

    def to_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float64)).to(dev)

    p3t, p2t, mt = to_dev(p3), to_dev(p2), to_dev(msk)

    def residuals(theta):
        cam = theta[:9]
        rv = theta[9:9 + 3 * f].reshape(f, 3)
        tv = theta[9 + 3 * f:].reshape(f, 3)
        pc = p3t @ _rodrigues(rv).transpose(-1, -2) + tv[:, None, :]
        pix, _ = OpenCVModel5(cam).project(pc)
        return ((pix - p2t) * mt[..., None]).reshape(-1)

    jacobian = torch.func.jacfwd(residuals)
    eye = torch.eye(9 + 6 * f, dtype=torch.float64, device=dev)

    def gn_step(theta, lm):
        r = residuals(theta)
        jac = jacobian(theta)
        # solve_ex: no error check, so no host read of its status
        step, _ = torch.linalg.solve_ex(jac.T @ jac + lm * eye, jac.T @ r)
        return theta - step, r

    theta = torch.cat([to_dev(k0), to_dev(rvecs).reshape(-1),
                       to_dev(tvecs).reshape(-1)])
    lm = 1e-3
    prev_cost = np.inf
    accepted = 0
    for _ in range(iters):
        new_theta, r = gn_step(theta, lm)
        cost = float(torch.sum(r * r))  # the iteration's one host read
        if not np.isfinite(cost):
            lm *= 10
            continue
        if cost > prev_cost:
            lm = min(lm * 10, 1e3)
        else:
            lm = max(lm / 3, 1e-9)
            theta = new_theta
            prev_cost = cost
            accepted += 1

    r = residuals(theta)
    n_pts = float(mt.sum())
    rms = float(torch.sqrt(torch.sum(r * r) / max(n_pts, 1.0)))
    return CalibrationResult(params=theta[:9].cpu().numpy(), rms_px=rms,
                             n_frames=f, steps_accepted=accepted)


class Calibrator:
    """Stateful driver of the configurator's Calibrator
    (``configurator/src/calibration.rs:30-143``): feed views, keep their
    features, then solve with up to MAX_ATTEMPTS attempts. The detector
    (built once, on ``device``) and the solve run on ``device``."""

    def __init__(self, detector=None, board=None, monitor=None,
                 device: str | torch.device = "cuda"):
        self.features: list[FrameFeature] = []
        self.board = board or aprilgrid_board_corners()
        self.device = resolve_device(device)
        self._detector = detector
        # Optional CalibrationMonitor (subsystems/calib_viz.py): per-view
        # corner/coverage streaming, the reference's rerun point logging
        # (configurator/src/calibration.rs:91-98).
        self.monitor = monitor

    def _detect(self, frame: np.ndarray):
        """(ids [D'], corners [D', 4, 2]) of the valid detections, fetched
        from the device in one copy."""
        if self._detector is None:
            from chalkydri_tpu_torch.detector.pipeline import make_detector

            self._detector = make_detector(device=self.device)
        x = torch.from_numpy(np.ascontiguousarray(frame))[None].to(self.device)
        out = self._detector(x)
        d = out.ids.shape[1]
        # int32 ids, float32 corners and the valid flags are exact in float64
        packed = torch.cat([out.ids[0, :, None].double(),
                            out.corners[0].reshape(d, 8).double(),
                            out.valid[0, :, None].double()], dim=1)
        packed = packed.cpu().numpy()
        ids = packed[:, 0].astype(np.int32)
        corners = packed[:, 1:9].astype(np.float32).reshape(d, 4, 2)
        valid = packed[:, 9] > 0
        return ids[valid], corners[valid]

    def process_frame(self, frame: np.ndarray) -> bool:
        """Detect the board in a view; True if it contributed."""
        ids, corners = self._detect(frame)
        feat = feature_from_detections(ids, corners, self.board)
        accepted = feat is not None
        if self.monitor is not None:
            self.monitor.on_frame(frame, ids, corners, accepted)
        if not accepted:
            return False
        self.features.append(feat)
        return True

    def calibrate(self) -> CalibrationResult:
        last_err = None
        for _ in range(MAX_ATTEMPTS):
            try:
                result = calibrate_camera(self.features, device=self.device)
                if self.monitor is not None:
                    self.monitor.on_result(result.rms_px, result.n_frames)
                return result
            except (ValueError, np.linalg.LinAlgError) as e:  # noqa: PERF203
                last_err = e
        raise RuntimeError(f"calibration failed after {MAX_ATTEMPTS} attempts: {last_err}")
