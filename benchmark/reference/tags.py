# Frozen copy of chalkydri_tpu_torch/geometry/tags.py for the benchmark's plain
# reference; imports rewritten to this package. Do not edit to follow
# the program: the reference is held still while the program changes.
"""Tag corner geometry (port of ``chalkydri_tpu/geometry/tags.py``).

Tags are squares of side ``TAG_SIZE`` in the tag frame's YZ plane (X is
the outward normal), corners ordered

    0: (0, -S, -S)   image bottom-left for an upright tag
    1: (0, +S, -S)   image bottom-right
    2: (0, +S, +S)   image top-right
    3: (0, -S, +S)   image top-left

with S = TAG_SIZE / 2: libapriltag's detection corner order, which the
detector reproduces.
"""

from __future__ import annotations

import functools

import torch

from .transforms import SE3

TAG_SIZE = 0.1651  # meters, 2026 season
CORNER_DISTANCE = TAG_SIZE / 2.0


@functools.lru_cache(maxsize=16)
def corner_offsets(dtype=torch.float64, tag_size: float = TAG_SIZE,
                   device=None) -> torch.Tensor:
    """[4, 3] corner offsets in the tag frame (made once per dtype, size
    and device; callers must not modify it)."""
    s = tag_size / 2.0
    return torch.tensor(
        [[0.0, -s, -s], [0.0, s, -s], [0.0, s, s], [0.0, -s, s]],
        dtype=dtype, device=device,
    )


def corners_world(tag_pose: SE3, tag_size: float = TAG_SIZE) -> torch.Tensor:
    """World-frame corners [..., 4, 3] for tag pose(s) with leading dims."""
    t = tag_pose.translation
    offs = corner_offsets(t.dtype, tag_size, device=t.device)  # [4, 3]
    rot = tag_pose.rotation[..., None, :, :]  # [..., 1, 3, 3]
    return torch.einsum("...ij,...j->...i", rot, offs) + t[..., None, :]
