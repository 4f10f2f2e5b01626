"""Stage 6: sub-pixel edge refinement (port of
``chalkydri_tpu/detector/refine.py``).

Per quad edge: sample ``n_samples`` points along it (away from the
corners), walk the outward normal over [-R, R] with bilinear samples, take
the gradient-magnitude-weighted centroid of |d intensity / dn| as the edge
crossing, refit each edge line through its adjusted points, and intersect
neighbors. A corner that moves more than R + 1 px keeps its old value.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from chalkydri_tpu_torch.detector.homography import bilinear_sample
from chalkydri_tpu_torch.detector.quad import corners_from_lines, line_fits

N_SAMPLES = 8  # points per edge
N_WALK = 9  # samples along the normal
WALK_RANGE = 2.0  # pixels each side


@functools.lru_cache(maxsize=16)
def _linspace_f32(start: float, stop: float, num: int, device) -> torch.Tensor:
    """``jnp.linspace(start, stop, num, dtype=float32)``'s values, made once
    per device."""
    return torch.from_numpy(
        np.linspace(start, stop, num, dtype=np.float32)).to(device)


def refine_quads(gray: torch.Tensor, corners: torch.Tensor,
                 valid: torch.Tensor, n_samples: int = N_SAMPLES,
                 n_walk: int = N_WALK,
                 walk_range: float = WALK_RANGE) -> torch.Tensor:
    """gray [B, H, W] uint8, corners [B, K, 4, 2], valid [B, K] ->
    refined corners [B, K, 4, 2]."""
    dev = corners.device
    c0 = corners
    c1 = torch.roll(corners, -1, dims=-2)
    t = _linspace_f32(0.15, 0.85, n_samples, dev)  # [S]
    d = c1 - c0
    px = c0[..., 0, None] + t * d[..., 0, None]  # [B, K, 4, S]
    py = c0[..., 1, None] + t * d[..., 1, None]

    ex, ey = d[..., 0], d[..., 1]  # [B, K, 4]
    elen = torch.sqrt(torch.clamp(ex * ex + ey * ey, min=1e-9))
    nx, ny = ey / elen, -ex / elen  # outward normal of a CCW (y down) quad

    w = _linspace_f32(-walk_range, walk_range, n_walk, dev)  # [W]
    sx = px[..., None] + nx[..., None, None] * w  # [B, K, 4, S, W]
    sy = py[..., None] + ny[..., None, None] * w
    vals = bilinear_sample(gray, torch.stack([sx, sy], dim=-1))

    grad = torch.abs(vals[..., 1:] - vals[..., :-1])  # [B, K, 4, S, W-1]
    wmid = 0.5 * (w[1:] + w[:-1])
    gsum = torch.clamp(grad.sum(dim=-1), min=1e-6)
    offset = (grad * wmid).sum(dim=-1) / gsum  # [B, K, 4, S]
    conf = grad.sum(dim=-1)

    ax = px + offset * nx[..., None]
    ay = py + offset * ny[..., None]
    # one line per edge: the edge axis becomes a singleton line axis
    fcx, fcy, fnx, fny, _ = line_fits(ax, ay, conf[..., None, :])
    new_corners = corners_from_lines(fcx[..., 0], fcy[..., 0],
                                     fnx[..., 0], fny[..., 0])
    delta = torch.sqrt(((new_corners - corners) ** 2).sum(dim=-1))
    ok = (delta < walk_range + 1.0)[..., None] & torch.isfinite(new_corners)
    refined = torch.where(ok, new_corners, corners)
    return torch.where(valid[..., None, None], refined, corners)
