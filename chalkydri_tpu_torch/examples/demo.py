"""Runnable demo: a rendered field view -> the fused detect + pose step ->
the solved robot pose beside the true one (twin of ``examples/demo.py``).

    python -m chalkydri_tpu_torch.examples.demo [--device cpu]

The view is rendered with the port's own numpy renderer
(``tools/scenes.py``): tags 3 and 4 on a wall at x = 11.3 m, seen from a
robot at (9.6, 4.2) facing +x through a camera 1 m up.
"""

from __future__ import annotations

import argparse
import json

import torch

from chalkydri_tpu_torch.geometry.field_layout import parse_field_layout
from chalkydri_tpu_torch.pipeline import build_rig_from_config, make_vision_pipeline
from chalkydri_tpu_torch.tools.scenes import render_scene
from chalkydri_tpu_torch.utils.platform import resolve_device

CALIB = {
    "fx": 900.0, "fy": 900.0, "cx": 320.0, "cy": 240.0,
    "k1": 0.0, "k2": 0.0, "p1": 0.0, "p2": 0.0, "k3": 0.0,
    "width": 640, "height": 480,
}
MOUNT = {"roll": 0, "pitch": 0, "yaw": 0, "x": 0, "y": 0, "z": 1.0}
ROBOT = (9.6, 4.2, 0.0)  # x m, y m, yaw rad
TAGS = (3, 4)


def run(device="cuda"):
    """(the step's VisionOutput, the true robot pose) of the demo view."""
    dev = resolve_device(device)
    tags = [
        {"ID": t, "pose": {"translation": {"x": 11.3, "y": y, "z": 1.0},
                           "rotation": {"quaternion": {"W": 0, "X": 0, "Y": 0, "Z": 1}}}}
        for t, y in ((3, 4.38), (4, 4.02))
    ]
    layout = parse_field_layout(
        {"tags": tags, "field": {"length": 16.5, "width": 8.0}},
        dtype=torch.float32)
    cams = [{"calib": json.dumps({"OpenCVModel5": CALIB}),
             "robot_to_cam": json.dumps(MOUNT)}]
    _, rc_cpu = build_rig_from_config(cams, layout, device="cpu")
    canvas = render_scene(layout, rc_cpu, *ROBOT, CALIB, tags=TAGS)

    layout = parse_field_layout(
        {"tags": tags, "field": {"length": 16.5, "width": 8.0}},
        dtype=torch.float32, device=dev)
    params, rc = build_rig_from_config(cams, layout, device=dev)
    step = make_vision_pipeline(layout, params, rc, device=dev)
    out = step(torch.from_numpy(canvas)[None].to(dev),
               torch.zeros(1, dtype=torch.float32, device=dev))
    return out, ROBOT


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="demo", description=__doc__)
    p.add_argument("--device", default="cuda",
                   help="torch device of the step (default: cuda; cpu "
                        "without a card)")
    args = p.parse_args(argv)
    out, (x, y, yaw) = run(args.device)
    print(f"true robot pose:    x={x:.3f} y={y:.3f} yaw={yaw:.3f}")
    print(f"solved robot pose:  x={float(out.pose_x[0]):.3f} "
          f"y={float(out.pose_y[0]):.3f} yaw={float(out.pose_yaw[0]):.3f} "
          f"(valid={bool(out.pose_valid[0])}, tags={int(out.tag_count[0])})")
    print("detections:")
    for b, tid, corners, margin in out.detections.filtered_by_decision_margin(10.0):
        print(f"  tag {tid}: margin {margin:.1f}, corners {corners.round(2).tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
