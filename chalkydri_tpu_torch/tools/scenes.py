"""Rendered scenes for the card runs (``chip_smoke.py``, ``perfprobe``,
``dryrun``): tag36h11 tags 28-31 of the 2026 field layout
(``examples/field_2026.json``, blue wall at x = 16.518 m, facing -x) seen
by a pinhole camera with no tilt, one known robot pose per camera, warped
onto a uniform gray frame with numpy (float64 geometry, bilinear sampling).

- ``"bench"``: 4 cameras of 1280x800, fx = fy = 1100, centered, 1 m up;
- ``"deployed"``: the deployed rig, 2 cameras of 1600x1304, fx = fy =
  1100, cx = 800, cy = 652, 1 m up;
- ``"spatial"``: the deployed rig with its frames padded to 1312 rows (a
  multiple of 4 bands x 8) and the cameras 1.2 m up, so that all four tags
  (1.22 m up) straddle row 656, the middle seam of four row bands.

``tiny_rig`` and ``render_tiny`` are the dry run's scene: a three-tag
layout of its own with two tags 0.6 m before the camera.

``board_views`` renders views of the 6x6 aprilgrid (tag36h11 ids 0-35)
through a lens with distortion, from random poses, for the calibration
path.

``serpentine``, ``blob_tern`` and ``mixed_terns`` are ternary pages that
stress the capped CCL rounds (kernels B1, B3 and B4), at the shapes
``CCL_STRESS_SHAPES``; the card run and the CPU tests against the JAX
package share them.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

FIELD_JSON = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "examples", "field_2026.json")
TAGS = (28, 29, 30, 31)
MOUNT = {"roll": 0, "pitch": 0, "yaw": 0, "x": 0, "y": 0, "z": 1.0}
_LENS = {"fx": 1100.0, "fy": 1100.0, "k1": 0.0, "k2": 0.0, "p1": 0.0,
         "p2": 0.0, "k3": 0.0}
# One robot pose (x m, y m, yaw rad) per camera, so a slot mix-up shows.
_POSES = ((13.0, 4.0215, 0.0), (12.9, 3.99, 0.015), (13.1, 4.06, -0.015),
          (12.8, 3.95, 0.04))
# name -> (lens and frame size, robot poses, camera mount)
SCENES = {
    "bench": (dict(_LENS, cx=640.0, cy=400.0, width=1280, height=800),
              _POSES, MOUNT),
    "deployed": (dict(_LENS, cx=800.0, cy=652.0, width=1600, height=1304),
                 _POSES[:2], MOUNT),
    "spatial": (dict(_LENS, cx=800.0, cy=656.0, width=1600, height=1312),
                _POSES[:2], dict(MOUNT, z=1.2)),
}

# The dry run's rig: one camera looking down field +x at two tags on a
# wall 0.6 m ahead, centered on the lens axis, so they render large enough
# to decode in a 128x256 frame; and the same scene through a 1280x800 lens.
TINY_CALIB = {"fx": 220.0, "fy": 220.0, "cx": 128.0, "cy": 64.0, "k1": 0.0,
              "k2": 0.0, "p1": 0.0, "p2": 0.0, "k3": 0.0, "width": 256,
              "height": 128}
PROD_CALIB = {"fx": 900.0, "fy": 900.0, "cx": 640.0, "cy": 400.0, "k1": 0.0,
              "k2": 0.0, "p1": 0.0, "p2": 0.0, "k3": 0.0, "width": 1280,
              "height": 800}
TINY_MOUNT = dict(MOUNT, z=1.1)  # camera height == tag height
TINY_ROBOT = (10.7, 4.4, 0.0)  # 0.6 m from the tag wall at x = 11.3
TINY_TAGS = (1, 2)


# [B, H, W] for the CCL rounds: widths that are no multiple of 32, of 8 or
# of 4, one strip of columns 4096 rows tall, and 4096-pixel rows.
CCL_STRESS_SHAPES = ((1, 52, 200), (2, 100, 36), (1, 7, 9), (1, 4096, 8),
                     (1, 8, 4096))


def serpentine(h: int = 64, w: int = 128, stripes: int = 20) -> np.ndarray:
    """[h, w] uint8: a white snake on black (vertical 1-px stripes joined
    alternately at the top and bottom row). Its minimum label moves one
    stripe a round, so it needs ``stripes - 1`` CCL rounds: with 20 stripes
    the cap of 12 binds. Every tile neighborhood has contrast, so as a
    gray frame it thresholds to itself."""
    g = np.zeros((h, w), np.uint8)
    cols = np.linspace(2, w - 3, stripes).astype(int)
    g[:, cols] = 255
    for i in range(len(cols) - 1):
        g[0 if i % 2 == 0 else h - 1, cols[i]:cols[i + 1] + 1] = 255
    return g


def blob_tern(shape, seed: int) -> np.ndarray:
    """``shape`` = [B, H, W] uint8 in {0, 127, 255}: 4x4 blocks of random
    value with 8 % of the pixels redrawn, so runs of every length start
    and end at every offset."""
    rng = np.random.default_rng(seed)
    b, h, w = shape
    values = np.array([0, 127, 255], np.uint8)
    t = rng.choice(values, size=(b, -(-h // 4), -(-w // 4)), p=(.45, .1, .45))
    t = np.repeat(np.repeat(t, 4, axis=1), 4, axis=2)[:, :h, :w]
    redrawn = rng.random(shape) < 0.08
    return np.ascontiguousarray(
        np.where(redrawn, rng.choice(values, size=shape), t))


def mixed_terns(h: int, w: int, stripes: int, seed: int) -> np.ndarray:
    """[4, h, w] uint8 whose frames leave the CCL rounds at different
    times: a flat white page (needs 1 round), a snake of 5 stripes (4
    rounds), blobs (over a dozen) and a snake of ``stripes`` stripes."""
    return np.stack([np.full((h, w), 255, np.uint8),
                     serpentine(h, w, 5),
                     blob_tern((1, h, w), seed)[0],
                     serpentine(h, w, stripes)])


def homography(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """3x3 homography mapping 4 src points onto 4 dst points (DLT)."""
    a, b = [], []
    for (x, y), (u, v) in zip(src, dst):
        a.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        a.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        b += [u, v]
    h = np.linalg.solve(np.asarray(a, np.float64), np.asarray(b, np.float64))
    return np.append(h, 1.0).reshape(3, 3)


def place_tag(canvas: np.ndarray, tag: np.ndarray, cell_px: int,
              corners: np.ndarray) -> None:
    """Warp a rendered tag (white border of one cell) onto the canvas so its
    outer black-border corners (BL, BR, TR, TL) land on ``corners``:
    inverse mapping with bilinear sampling; pixels that map outside the
    tag image are left as they are."""
    side = tag.shape[0]
    b = cell_px
    src = np.array([[b, side - b], [side - b, side - b], [side - b, b],
                    [b, b]], np.float64) - 0.5
    hinv = np.linalg.inv(homography(src, corners.astype(np.float64)))
    x0, y0 = np.floor(corners.min(axis=0) - 2 * cell_px).astype(int)
    x1, y1 = np.ceil(corners.max(axis=0) + 2 * cell_px).astype(int)
    x0, y0 = max(x0, 0), max(y0, 0)
    x1, y1 = min(x1, canvas.shape[1] - 1), min(y1, canvas.shape[0] - 1)
    ys, xs = np.mgrid[y0:y1 + 1, x0:x1 + 1].astype(np.float64)
    p = hinv @ np.stack([xs.ravel(), ys.ravel(), np.ones(xs.size)])
    sx, sy = p[0] / p[2], p[1] / p[2]
    inside = (sx >= 0) & (sx <= side - 1) & (sy >= 0) & (sy <= side - 1)
    sx, sy = sx[inside], sy[inside]
    ix = np.minimum(np.floor(sx).astype(int), side - 2)
    iy = np.minimum(np.floor(sy).astype(int), side - 2)
    fx, fy = sx - ix, sy - iy
    t = tag.astype(np.float64)
    val = ((t[iy, ix] * (1 - fx) + t[iy, ix + 1] * fx) * (1 - fy)
           + (t[iy + 1, ix] * (1 - fx) + t[iy + 1, ix + 1] * fx) * fy)
    rows = ys.ravel()[inside].astype(int)
    cols = xs.ravel()[inside].astype(int)
    canvas[rows, cols] = np.clip(np.rint(val), 0, 255).astype(np.uint8)


def render_scene(layout, rig_rc, robot_x, robot_y, robot_yaw, calib: dict,
                 tags=TAGS, cell_px: int = 16) -> np.ndarray:
    """The camera's view of ``tags`` from a robot pose, on a
    ``calib["height"] x calib["width"]`` uint8 frame."""
    from chalkydri_tpu_torch.detector.families import load_family, render_tag
    from chalkydri_tpu_torch.geometry.tags import corners_world

    h, w = int(calib["height"]), int(calib["width"])
    fam = load_family("tag36h11")
    c, s = math.cos(robot_yaw), math.sin(robot_yaw)
    w2r_rot = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])
    w2r_t = -w2r_rot @ np.array([robot_x, robot_y, 0.0])
    rc_rot = rig_rc.rotation[0].double().cpu().numpy()
    rc_t = rig_rc.translation[0].double().cpu().numpy()
    canvas = np.full((h, w), 150, np.uint8)
    for tid in tags:
        pose = layout.tag_pose(torch.tensor(tid))
        pose = type(pose)(pose.rotation.double().cpu(),
                          pose.translation.double().cpu())
        cw = corners_world(pose).numpy()  # [4, 3]
        pc = (rc_rot @ (w2r_rot @ cw.T + w2r_t[:, None])) + rc_t[:, None]
        if not (pc[2] > 0.5).all():
            raise AssertionError(f"tag {tid} is not in front of the camera")
        pix = np.stack([calib["fx"] * pc[0] / pc[2] + calib["cx"],
                        calib["fy"] * pc[1] / pc[2] + calib["cy"]], axis=1)
        if not ((pix > 0).all() and (pix[:, 0] < w - 1).all()
                and (pix[:, 1] < h - 1).all()):
            raise AssertionError(f"tag {tid} is not inside the frame: {pix}")
        place_tag(canvas, render_tag(fam, tid, cell_px=cell_px), cell_px, pix)
    return canvas


def load_scene(name: str, device):
    """``(layout, params [B, 9], robot->camera SE3 [B], frames [B, H, W]
    uint8, poses)`` of scene ``name`` on ``device``, the rig built through
    ``build_rig_from_config`` as a user's config would."""
    from chalkydri_tpu_torch.geometry.field_layout import load_field_layout
    from chalkydri_tpu_torch.pipeline import build_rig_from_config

    calib, poses, mount = SCENES[name]
    layout = load_field_layout(FIELD_JSON, dtype=torch.float32)
    cams = [{"calib": json.dumps({"OpenCVModel5": calib}),
             "robot_to_cam": json.dumps(mount)}] * len(poses)
    params, rc = build_rig_from_config(cams, layout, device=device)
    frames = torch.from_numpy(np.stack(
        [render_scene(layout, rc, *pose, calib) for pose in poses]))
    return layout, params, rc, frames.to(device), poses


def tiny_rig(calib: dict | None = None):
    """``(layout, cams)``: a three-tag field layout (tags 1 and 2 side by
    side on a wall at x = 11.3 m facing -x, tag 3 elsewhere) and the config
    entry of one camera with lens ``calib`` (default ``TINY_CALIB``), for
    ``build_rig_from_config(cams * n, layout)``."""
    from chalkydri_tpu_torch.geometry.field_layout import parse_field_layout

    tags = [{"ID": tid,
             "pose": {"translation": {"x": x, "y": y, "z": 1.1},
                      "rotation": {"quaternion": {"W": 0.0, "X": 0.0,
                                                  "Y": 0.0, "Z": 1.0}}}}
            for tid, (x, y) in enumerate(
                [(11.3, 4.4), (11.3, 4.15), (11.9, 6.6)], start=1)]
    layout = parse_field_layout(
        {"tags": tags, "field": {"length": 16.518, "width": 8.043}},
        dtype=torch.float32)
    cams = [{"calib": json.dumps({"OpenCVModel5": calib or TINY_CALIB}),
             "robot_to_cam": json.dumps(TINY_MOUNT)}]
    return layout, cams


def render_tiny(layout, rig_rc, n_frames: int, calib: dict | None = None,
                cell_px: int = 16) -> np.ndarray:
    """[n_frames, H, W] uint8: the view of ``TINY_TAGS`` from
    ``TINY_ROBOT`` through ``calib`` (default ``TINY_CALIB``), repeated."""
    frame = render_scene(layout, rig_rc, *TINY_ROBOT, calib or TINY_CALIB,
                         tags=TINY_TAGS, cell_px=cell_px)
    return np.stack([frame] * n_frames)


# The calibration path's lens (``tests/test_calibration.py``'s, centred on
# a 1280x800 frame) and its views of the aprilgrid: 12 poses, the board
# 0.40-0.55 m away and tilted up to ~35 degrees about each axis.
CALIB_LENS = {"fx": 880.0, "fy": 870.0, "cx": 640.0, "cy": 400.0,
              "k1": -0.12, "k2": 0.04, "p1": 0.001, "p2": -0.0008,
              "k3": 0.0, "width": 1280, "height": 800}
CALIB_VIEWS = 12
CALIB_DISTANCE_M = (0.40, 0.55)
CALIB_TILT_RAD = 0.6


def board_views(n: int = CALIB_VIEWS, calib: dict = CALIB_LENS,
                seed: int = 1, distance=CALIB_DISTANCE_M,
                tilt: float = CALIB_TILT_RAD, cell_px: int = 16):
    """``n`` views of the 6x6 aprilgrid of ``tools/calibration.py``:
    ``(frames [n, H, W] uint8, rotations [n, 3, 3], translations [n, 3])``
    with board -> camera poses drawn from ``seed``. The board faces the
    camera upright (turned half a revolution about x, so its +y runs up
    the image), tilted by Euler angles (extrinsic xyz) up to ``tilt``,
    its centre ``distance`` m away and off the axis by up to 5 % of that.
    Each tag's four corners go through the lens with its distortion; the
    tag between them is warped by the homography of those corners."""
    from scipy.spatial.transform import Rotation

    from chalkydri_tpu_torch.detector.families import load_family, render_tag
    from chalkydri_tpu_torch.geometry.camera import OpenCVModel5
    from chalkydri_tpu_torch.tools.calibration import aprilgrid_board_corners

    rng = np.random.default_rng(seed)
    model = OpenCVModel5.from_dict(calib)
    fam = load_family("tag36h11")
    board = aprilgrid_board_corners()
    ids = sorted(board)
    pts = np.concatenate([board[t] for t in ids])  # [144, 3]
    center = pts.mean(axis=0)
    upright = np.diag([1.0, -1.0, -1.0])
    h, w = int(calib["height"]), int(calib["width"])
    frames, rots, ts = [], [], []
    for _ in range(n):
        rot = Rotation.from_euler("xyz", rng.uniform(-tilt, tilt, 3)
                                  ).as_matrix() @ upright
        z = rng.uniform(*distance)
        t = np.array([rng.uniform(-0.05, 0.05) * z,
                      rng.uniform(-0.05, 0.05) * z, z]) - rot @ center
        pix, valid = model.project(torch.from_numpy(pts @ rot.T + t))
        pix = pix.numpy().reshape(len(ids), 4, 2)
        if not (bool(valid.all()) and (pix > 0).all()
                and (pix[..., 0] < w - 1).all() and (pix[..., 1] < h - 1).all()):
            raise AssertionError("the board leaves the frame")
        canvas = np.full((h, w), 150, np.uint8)
        for tid, corners in zip(ids, pix):
            place_tag(canvas, render_tag(fam, tid, cell_px=cell_px), cell_px,
                      corners)
        frames.append(canvas)
        rots.append(rot)
        ts.append(t)
    return np.stack(frames), np.stack(rots), np.stack(ts)
