"""WPILib AprilTag field-layout loader (port of
``chalkydri_tpu/geometry/field_layout.py``): JSON in, a dense tag-pose
table of tensors out, indexed by tag id."""

from __future__ import annotations

import json
import os
from typing import NamedTuple

import torch

from chalkydri_tpu_torch.geometry.transforms import SE3, quat_to_matrix

# Dense table capacity: ids 0..MAX_TAG_ID inclusive.
MAX_TAG_ID = 63


class FieldLayout(NamedTuple):
    """Dense tag-pose table. ``present[id]`` is True for ids in the layout;
    rows for absent ids are identity poses. ``field_size`` is (length,
    width) in meters."""

    rotations: torch.Tensor  # [MAX_TAG_ID + 1, 3, 3]
    translations: torch.Tensor  # [MAX_TAG_ID + 1, 3]
    present: torch.Tensor  # [MAX_TAG_ID + 1] bool
    field_size: tuple[float, float]

    def tag_pose(self, tag_id) -> SE3:
        """Tag pose(s) by (possibly batched, possibly invalid) id."""
        idx = torch.clamp(torch.as_tensor(tag_id, device=self.present.device),
                          0, MAX_TAG_ID)
        return SE3(self.rotations[idx], self.translations[idx])

    def to(self, device) -> "FieldLayout":
        return FieldLayout(self.rotations.to(device),
                           self.translations.to(device),
                           self.present.to(device), self.field_size)


def parse_field_layout(data: dict, dtype=torch.float64,
                       device=None) -> FieldLayout:
    """Parse an already-decoded WPILib layout dict: ``{"tags": [{"ID": n,
    "pose": {"translation": {x,y,z}, "rotation": {"quaternion":
    {W,X,Y,Z}}}}], "field": {"length", "width"}}``."""
    n = MAX_TAG_ID + 1
    rotations = torch.eye(3, dtype=dtype).repeat(n, 1, 1)
    translations = torch.zeros(n, 3, dtype=dtype)
    present = torch.zeros(n, dtype=torch.bool)
    for tag in data["tags"]:
        tid = int(tag["ID"])
        if not (0 <= tid <= MAX_TAG_ID):
            continue
        pose = tag["pose"]
        t = pose["translation"]
        q = pose["rotation"]["quaternion"]
        quat = torch.tensor([float(q["W"]), float(q["X"]), float(q["Y"]),
                             float(q["Z"])], dtype=dtype)
        rotations[tid] = quat_to_matrix(quat)
        translations[tid] = torch.tensor(
            [float(t["x"]), float(t["y"]), float(t["z"])], dtype=dtype)
        present[tid] = True
    field = data.get("field", {})
    return FieldLayout(
        rotations=rotations.to(device),
        translations=translations.to(device),
        present=present.to(device),
        field_size=(float(field.get("length", 0.0)),
                    float(field.get("width", 0.0))),
    )


def load_field_layout(path: str | None = None, dtype=torch.float64,
                      device=None) -> FieldLayout:
    """Load a WPILib ``field.json`` (default: ``field.json`` in the working
    directory, the reference's convention)."""
    if path is None:
        path = "field.json"
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"field layout {path!r} not found: drop the season's WPILib "
            "field.json in the working directory or pass a path"
        )
    with open(path) as f:
        return parse_field_layout(json.load(f), dtype=dtype, device=device)
