"""The inputs of a run, made from its seed: a drive path of robot poses in
front of a tag wall, one fixed gyro heading, and every camera's view of
every pose, rendered once in set-up.

The renderer is a frozen copy of the program's ``tools/scenes.py``
(``homography``, ``place_tag``, ``render_scene``): a tag36h11 tag warped
onto a uniform gray frame by the homography of its four projected
corners, bilinear sampling, float64 geometry. It reads the field layout,
the tag codes and the camera geometry through ``benchmark.reference``,
never through the program.

A seed draws the heading and, for each of ``poses`` distances spread
evenly over ``distance_m`` (one in each of ``poses`` equal slices), a
lateral position at which every camera sees between
``tags_per_camera[0]`` and ``tags_per_camera[1]`` tags whole, each at
least ``margin_px`` inside the frame. Tags that reach into a frame only
in part are drawn too, cut at its edge, as a camera would see them. So every
seed has the same spread of tag sizes; the seed changes where they sit.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass

import numpy as np
import torch

from benchmark.reference.families import load_family, render_tag
from benchmark.reference.field_layout import load_field_layout
from benchmark.reference.pipeline import build_rig
from benchmark.reference.tags import corners_world

CELL_PX = 16  # pixels a tag cell is rendered at before the warp
BACKGROUND = 150  # the frame's uniform gray
_TRIES = 400  # lateral draws per pose before its distance is drawn again


@dataclass
class Scene:
    """A run's inputs: ``frames[c][k]`` is camera ``c``'s view of pose
    ``k`` ([H, W] uint8); ``poses[k]`` is (x m, y m); ``tags[c][k]`` the
    ids drawn in camera ``c``'s view (those it sees whole, at least
    ``margin_px`` inside, and those that reach into the frame in part); ``heading`` the fixed yaw (rad) the gyro
    reports."""

    heading: float
    poses: list
    tags: list
    frames: list


def camera_entries(cfg: dict) -> list:
    """The cameras of a configuration as the program's config takes them:
    ``{"calib": <calib JSON>, "robot_to_cam": <mount JSON>}``."""
    lens = dict(cfg["lens"], width=cfg["width"], height=cfg["height"])
    return [{"calib": json.dumps({"OpenCVModel5": lens}),
             "robot_to_cam": json.dumps(mount)} for mount in cfg["mounts"]]


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


class Rig:
    """The cameras' geometry (float64) and the field's tag corners, for
    projecting tags and rendering views."""

    def __init__(self, cfg: dict, layout_path: str):
        layout = load_field_layout(layout_path, dtype=torch.float64)
        ids = [int(i) for i in torch.nonzero(layout.present).flatten()]
        self.ids = ids
        pose = layout.tag_pose(torch.tensor(ids))
        self.corners = corners_world(pose).numpy()  # [T, 4, 3]
        self.normals = pose.rotation[:, :, 0].numpy()  # tag +x: its face
        _, rc = build_rig(camera_entries(cfg), layout, "cpu")
        self.rc_rot = rc.rotation.double().numpy()  # [C, 3, 3]
        self.rc_t = rc.translation.double().numpy()  # [C, 3]
        self.lens = cfg["lens"]
        self.w, self.h = int(cfg["width"]), int(cfg["height"])
        self.family = load_family(cfg.get("family", "tag36h11"))

    def project(self, cam: int, x: float, y: float, yaw: float):
        """(pixels [T, 4, 2], depth [T, 4], facing [T]) of every tag in
        camera ``cam`` from robot pose (x, y, yaw)."""
        c, s = math.cos(yaw), math.sin(yaw)
        w2r_rot = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])
        w2r_t = -w2r_rot @ np.array([x, y, 0.0])
        pw = self.corners.reshape(-1, 3).T
        pc = self.rc_rot[cam] @ (w2r_rot @ pw + w2r_t[:, None]) \
            + self.rc_t[cam][:, None]
        z = pc[2].reshape(-1, 4)
        zs = np.where(np.abs(pc[2]) < 1e-9, 1e-9, pc[2])
        pix = np.stack([self.lens["fx"] * pc[0] / zs + self.lens["cx"],
                        self.lens["fy"] * pc[1] / zs + self.lens["cy"]],
                       axis=1).reshape(-1, 4, 2)
        cam_world = np.linalg.inv(w2r_rot) @ (
            np.linalg.inv(self.rc_rot[cam]) @ -self.rc_t[cam] - w2r_t)
        to_cam = cam_world[None, :] - self.corners.mean(axis=1)
        facing = np.einsum("ti,ti->t", self.normals, to_cam) > 0
        return pix, z, facing

    def visible(self, cam: int, x: float, y: float, yaw: float,
                 margin: float):
        """(ids camera ``cam`` sees whole, at least ``margin`` pixels
        inside the frame; ids to render: those and every tag facing the
        camera that reaches into the frame in part), or None when a tag
        facing the camera straddles its plane."""
        pix, z, facing = self.project(cam, x, y, yaw)
        whole, drawn = [], []
        for t, tid in enumerate(self.ids):
            if not facing[t] or (z[t] <= 0.05).all():
                continue
            if (z[t] <= 0.05).any():
                return None
            p = pix[t]
            if ((p[:, 0] >= margin).all()
                    and (p[:, 0] <= self.w - 1 - margin).all()
                    and (p[:, 1] >= margin).all()
                    and (p[:, 1] <= self.h - 1 - margin).all()):
                whole.append(tid)
                drawn.append(tid)
            elif ((p[:, 0].max() >= -2 * CELL_PX)
                  and (p[:, 0].min() <= self.w + 2 * CELL_PX)
                  and (p[:, 1].max() >= -2 * CELL_PX)
                  and (p[:, 1].min() <= self.h + 2 * CELL_PX)):
                drawn.append(tid)
        return whole, drawn

    def render(self, cam: int, x: float, y: float, yaw: float,
               tags) -> np.ndarray:
        """Camera ``cam``'s [H, W] uint8 view of ``tags`` from (x, y,
        yaw)."""
        pix, _, _ = self.project(cam, x, y, yaw)
        canvas = np.full((self.h, self.w), BACKGROUND, np.uint8)
        for tid in tags:
            place_tag(canvas, render_tag(self.family, tid, cell_px=CELL_PX),
                      CELL_PX, pix[self.ids.index(tid)])
        return canvas


def drive_path(rig: Rig, scene: dict, wall_x: float, seed: int):
    """(heading, [(x, y)], [[ids] per pose] per camera) of a seed."""
    rng = np.random.default_rng(seed)
    yaw = float(rng.uniform(*scene["yaw_rad"]))
    n = int(scene["poses"])
    d0, d1 = scene["distance_m"]
    lo, hi = scene["tags_per_camera"]
    poses, tags = [], [[] for _ in rig.rc_rot]
    for k in range(n):
        for _ in range(_TRIES):
            d = d0 + (d1 - d0) * (k + rng.uniform()) / n
            for _ in range(_TRIES):
                y = float(rng.uniform(*scene["lateral_m"]))
                seen = [rig.visible(c, wall_x - d, y, yaw,
                                    scene["margin_px"])
                        for c in range(len(rig.rc_rot))]
                if all(s is not None and lo <= len(s[0]) <= hi
                       for s in seen):
                    break
            else:
                continue
            break
        else:
            raise ValueError(f"no pose {d0 + (d1 - d0) * k / n:.2f}-"
                             f"{d0 + (d1 - d0) * (k + 1) / n:.2f} m from the "
                             f"wall shows every camera {lo}-{hi} whole tags")
        poses.append((wall_x - d, y))
        for c, (_, drawn) in enumerate(seen):
            tags[c].append(drawn)
    if rng.uniform() < 0.5:  # drive towards the wall or away from it
        poses.reverse()
        tags = [t[::-1] for t in tags]
    return yaw, poses, tags


def make_scene(cfg: dict, traffic: dict, layout_path: str,
               seed: int) -> Scene:
    """The run's inputs for configuration ``cfg`` under ``traffic``."""
    rig = Rig(cfg, layout_path)
    scene = traffic["scene"]
    heading, poses, tags = drive_path(rig, scene, scene["wall_x_m"], seed)
    frames = [[rig.render(c, x, y, heading, tags[c][k])
               for k, (x, y) in enumerate(poses)]
              for c in range(len(rig.rc_rot))]
    return Scene(heading=heading, poses=poses, tags=tags, frames=frames)
