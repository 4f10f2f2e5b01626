"""The comparison that decides ``correct``: every frame the App polled in
the window, its detections and its pose packet, against the plain
reference (``benchmark/reference``) on the same frame and heading.

The numbers compared, each with a limit from ``benchmark/limits/<config>.json``:

- ``ids_differ``: polled frames whose detected tag ids differ from the
  reference's (limit 0);
- ``packets_differ``: polled frames whose pose packet is missing though the
  reference finds a valid pose, or present though it finds none, or whose
  tag count differs from the reference's (limit 0);
- ``unmatched``: pose packets of the window that belong to no polled
  frame (limit 0);
- ``corner_px``: the largest gap, in pixels, of a corner of a tag both
  found;
- ``xy_m``: the largest distance between a packet's position and the
  reference's;
- ``yaw_rad``: the largest gap of heading;
- ``std_rel``: the largest gap of a standard deviation, over the
  reference's;
- ``truth_median_m``: the median, over the frames compared, of the
  distance between a pose and the pose the frame was rendered at. It
  does not read the reference, so a fault that the program and its
  frozen plain copy share (a mount, a layout, a sign) still fails it. It
  is a median, not a worst: a frame of one small tag far off can solve
  metres from where it was rendered, in both alike.
"""

from __future__ import annotations

import math

import numpy as np
import torch

NUMBERS = ("ids_differ", "packets_differ", "unmatched", "corner_px", "xy_m",
           "yaw_rad", "std_rel", "truth_median_m")


def reference_outputs(cfg: dict, scene, layout_path: str, device: str,
                      precision: str = "fp32") -> list:
    """``out[c][k]``: the reference's answer for camera ``c``'s view of
    pose ``k`` (dict: ids, corners {id: [4, 2]}, valid, count, x, y, yaw,
    std [3]), the K poses run one batch of the rig's cameras at a time."""
    from benchmark.reference.field_layout import load_field_layout
    from benchmark.reference.pipeline import make_reference, set_precision
    from benchmark.scene import camera_entries

    set_precision(precision)
    try:
        layout = load_field_layout(layout_path, dtype=torch.float32,
                                   device=device)
        ref = make_reference(layout, camera_entries(cfg),
                             int(cfg["quad_decimate"]), family=cfg["family"],
                             bits_corrected=int(cfg["bits_corrected"]),
                             max_detections=int(cfg["max_detections"]),
                             device=device)
        n_cams = len(scene.frames)
        out = [[] for _ in range(n_cams)]
        for k in range(len(scene.poses)):
            frames = torch.from_numpy(np.stack(
                [scene.frames[c][k] for c in range(n_cams)])).to(device)
            gyro = torch.full((n_cams,), scene.heading, dtype=torch.float32,
                              device=device)
            res = ref(frames, gyro)
            d = res.detections
            ids, corners, valid = (x.cpu().numpy() for x in
                                   (d.ids, d.corners, d.valid))
            fields = [x.cpu().numpy() for x in
                      (res.pose_x, res.pose_y, res.pose_yaw, res.std_devs,
                       res.pose_valid, res.tag_count)]
            for c in range(n_cams):
                keep = valid[c]
                out[c].append({
                    "ids": sorted(int(i) for i in ids[c][keep]),
                    "corners": {int(i): corners[c][j].astype(np.float64)
                                for j, i in enumerate(ids[c]) if keep[j]},
                    "x": float(fields[0][c]), "y": float(fields[1][c]),
                    "yaw": float(fields[2][c]),
                    "std": fields[3][c].astype(np.float64),
                    "valid": bool(fields[4][c]), "count": int(fields[5][c])})
        del ref
        return out
    finally:
        set_precision("fp32")


def wrap(a: float) -> float:
    return math.atan2(math.sin(a), math.cos(a))


class Gaps:
    """The running worst of each number."""

    def __init__(self):
        self.v = dict.fromkeys(NUMBERS, 0.0)
        self.v.update(ids_differ=0, packets_differ=0, unmatched=0)
        self.frames = 0
        self.truth = []  # each compared pose's distance from its rendering

    def detections(self, ids, corners: dict, want: dict) -> None:
        self.frames += 1
        if sorted(ids) != want["ids"]:
            self.v["ids_differ"] += 1
        for i in set(ids) & set(want["ids"]):
            gap = float(np.abs(corners[i] - want["corners"][i]).max())
            self.v["corner_px"] = max(self.v["corner_px"], gap)

    def pose(self, got, want: dict, rendered: tuple) -> None:
        """``got``: (x, y, yaw, sx, sy, syaw, tag count) or None;
        ``rendered``: the (x, y) the frame was rendered at."""
        if got is not None:
            self.truth.append(math.hypot(got[0] - rendered[0],
                                         got[1] - rendered[1]))
            self.v["truth_median_m"] = float(np.median(self.truth))
        if got is None or not want["valid"]:
            if (got is None) == want["valid"]:
                self.v["packets_differ"] += 1
            return
        x, y, yaw, sx, sy, syaw, count = got
        if count != want["count"]:
            self.v["packets_differ"] += 1
        self.v["xy_m"] = max(self.v["xy_m"],
                             math.hypot(x - want["x"], y - want["y"]))
        self.v["yaw_rad"] = max(self.v["yaw_rad"], abs(wrap(yaw - want["yaw"])))
        for g, w in zip((sx, sy, syaw), want["std"]):
            rel = abs(g - w) / max(abs(w), 1e-12)
            self.v["std_rel"] = max(self.v["std_rel"], rel)


def program_gaps(obs, matched: dict, unmatched: int, ref: list,
                 scene) -> Gaps:
    """The program's numbers: each frame the App polled in the window."""
    gaps = Gaps()
    gaps.v["unmatched"] = unmatched
    for c, cam in enumerate(obs.cams):
        for p in cam.polled:
            got = obs.detections[c].get(p.n)
            if got is None:  # the App never ran a step on it
                gaps.v["ids_differ"] += 1
                continue
            ids, corners, _ = got
            gaps.detections([int(i) for i in ids],
                            {int(i): np.asarray(corners[j], np.float64)
                             for j, i in enumerate(ids)}, ref[c][p.pose])
        for p in cam.polled:
            m = matched.get((c, p.n))
            gaps.pose(None if m is None else m[:6] + (m[8],), ref[c][p.pose],
                      scene.poses[p.pose])
    return gaps


def control_gaps(control: list, ref: list, scene) -> Gaps:
    """The numbers of ``control``, answers in the form of
    ``reference_outputs`` put in the program's place (the reference at a
    lower precision, or with a fault planted), over every distinct
    frame."""
    gaps = Gaps()
    for c in range(len(ref)):
        for k, (got, want) in enumerate(zip(control[c], ref[c])):
            gaps.detections(got["ids"], got["corners"], want)
            gaps.pose((got["x"], got["y"], got["yaw"], *got["std"],
                       got["count"]) if got["valid"] else None, want,
                      scene.poses[k])
    return gaps


def truth_gap_m(obs, matched: dict, scene) -> float:
    """The largest distance of a packet's position from the pose the frame
    was rendered at (printed; ``truth_median_m`` is the number
    compared)."""
    worst = 0.0
    for c, cam in enumerate(obs.cams):
        for p in cam.polled:
            m = matched.get((c, p.n))
            if m is not None:
                x, y = scene.poses[p.pose]
                worst = max(worst, math.hypot(m[0] - x, m[1] - y))
    return worst


def judge(values: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) for every number."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in NUMBERS}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
