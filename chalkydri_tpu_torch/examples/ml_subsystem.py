"""Example ML-subsystem model: a bright-disk (game piece) finder on the
App's device (twin of ``examples/ml_subsystem.py``).

The reference reserved a Coral Edge TPU + TFLite slot for this kind of
auxiliary inference (``MlSubsys {}`` config slot,
``chalkydri_core/src/config.rs:101-102``); here a model is a torch
function called on each frame as a tensor on the App's device
(``subsystems/ml.py``). This one is multi-scale zero-mean disk
correlation (``torch.nn.functional.conv2d``), the best match per frame.

Use it from a graph node:

    (id: "ml", type: "MlSubsys", config: {"model": "chalkydri_tpu_torch.examples.ml_subsystem:model"})

or run it alone on a synthetic scene:

    python -m chalkydri_tpu_torch.examples.ml_subsystem [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

RADII = (12, 20, 32)  # template radii in pixels (multi-scale)


def _disk_kernel(radius: int, device) -> torch.Tensor:
    """Zero-mean disk template [1, 1, 2r+1, 2r+1]: +1 inside the disk,
    unit norm, so it responds to contrast, not brightness."""
    side = 2 * radius + 1
    y, x = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    disk = (x * x + y * y <= radius * radius).astype(np.float32)
    disk -= disk.mean()
    disk /= np.sqrt((disk * disk).sum()) + 1e-6
    return torch.from_numpy(disk.reshape(1, 1, side, side)).to(device)


def model(frame: torch.Tensor) -> dict:
    """frame [H, W] uint8 (or [B, H, W]) -> {"x", "y", "radius", "score"}
    tensors on the frame's device: the best disk match per frame (the
    smaller radius on equal scores)."""
    squeeze = frame.dim() == 2
    if squeeze:
        frame = frame[None]
    x = frame.to(torch.float32)[:, None]  # NCHW
    best = None
    for r in RADII:
        resp = F.conv2d(x, _disk_kernel(r, frame.device), padding=r)[:, 0]
        flat = resp.reshape(resp.shape[0], -1)
        score, idx = flat.max(dim=-1)
        cand = ((idx % resp.shape[-1]).to(torch.float32),
                (idx // resp.shape[-1]).to(torch.float32),
                torch.full_like(score, float(r)), score)
        if best is None:
            best = cand
        else:
            take = score > best[3]
            best = tuple(torch.where(take, c, b) for c, b in zip(cand, best))
    out = dict(zip(("x", "y", "radius", "score"), best))
    if squeeze:
        out = {k: v[0] for k, v in out.items()}
    return out


def main(argv=None) -> int:
    from chalkydri_tpu_torch.utils.platform import resolve_device

    p = argparse.ArgumentParser(prog="ml_subsystem")
    p.add_argument("--device", default="cuda",
                   help="torch device of the model (default: cuda; cpu "
                        "without a card)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    # synthetic scene: noisy background + one bright disk
    rng = np.random.default_rng(7)
    frame = rng.normal(120, 12, (480, 640)).astype(np.float32)
    yy, xx = np.mgrid[:480, :640]
    cx, cy, r = 417, 203, 21
    frame[(xx - cx) ** 2 + (yy - cy) ** 2 <= r * r] = 230
    frame = np.clip(frame, 0, 255).astype(np.uint8)
    out = model(torch.from_numpy(frame).to(dev))
    print(f"true disk: ({cx}, {cy}) r={r}; "
          f"found: ({float(out['x']):.0f}, {float(out['y']):.0f}) "
          f"r={float(out['radius']):.0f} score={float(out['score']):.1f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
