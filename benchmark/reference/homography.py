# Frozen copy of chalkydri_tpu_torch/detector/homography.py for the benchmark's plain
# reference; imports rewritten to this package. Do not edit to follow
# the program: the reference is held still while the program changes.
"""Homography estimation and bilinear image sampling for tag decoding
(port of ``chalkydri_tpu/detector/homography.py``).

Tag coordinates: the quad's corners correspond to (-1, -1), (1, -1),
(1, 1), (-1, 1), the outer edge of the black border ring, with tag +x to
the right and tag +y up in the image.
"""

from __future__ import annotations

import torch

from .linalg import lstsq_spd

TAG_CORNERS = ((-1.0, -1.0), (1.0, -1.0), (1.0, 1.0), (-1.0, 1.0))


def homography_from_corners(corners: torch.Tensor) -> torch.Tensor:
    """DLT homographies H [..., 3, 3] mapping tag coords -> image pixels,
    for corners [..., 4, 2] ordered like TAG_CORNERS (H[2, 2] = 1).

    The 8x8 DLT system is solved by its SPD normal equations after
    Hartley normalization of the pixel side (centroid shift, mean corner
    distance scaled to sqrt(2)), which keeps it well-conditioned in f32.
    """
    centroid = corners.mean(dim=-2)  # [..., 2]
    rel = corners - centroid[..., None, :]
    mean_dist = torch.sqrt((rel * rel).sum(dim=-1)).mean(dim=-1)
    scale = (2.0 ** 0.5) / torch.clamp(mean_dist, min=1e-6)  # [...]
    norm = rel * scale[..., None, None]

    zero = torch.zeros_like(scale)
    one = torch.ones_like(scale)
    rows, rhs = [], []
    for i, (x, y) in enumerate(TAG_CORNERS):
        u, v = norm[..., i, 0], norm[..., i, 1]
        rows.append(torch.stack([x * one, y * one, one, zero, zero, zero,
                                 -u * x, -u * y], dim=-1))
        rhs.append(u)
        rows.append(torch.stack([zero, zero, zero, x * one, y * one, one,
                                 -v * x, -v * y], dim=-1))
        rhs.append(v)
    a = torch.stack(rows, dim=-2)  # [..., 8, 8]
    b = torch.stack(rhs, dim=-1)  # [..., 8]
    h8 = lstsq_spd(a, b)
    hn = torch.cat([h8, one[..., None]], dim=-1).reshape(*h8.shape[:-1], 3, 3)
    # Denormalize element-wise: pixels = T^-1 @ normalized.
    inv_s = (1.0 / scale)[..., None]
    h = torch.stack([
        hn[..., 0, :] * inv_s + centroid[..., 0:1] * hn[..., 2, :],
        hn[..., 1, :] * inv_s + centroid[..., 1:2] * hn[..., 2, :],
        hn[..., 2, :],
    ], dim=-2)
    return h / h[..., 2:3, 2:3]


def apply_homography(h: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Map tag-frame points [S, 2] through H [..., 3, 3] -> pixels
    [..., S, 2]."""
    x, y = pts[..., 0], pts[..., 1]

    def e(i, j):
        return h[..., i, j, None]

    w = e(2, 0) * x + e(2, 1) * y + e(2, 2)
    w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    u = (e(0, 0) * x + e(0, 1) * y + e(0, 2)) / w
    v = (e(1, 0) * x + e(1, 1) * y + e(1, 2)) / w
    return torch.stack([u, v], dim=-1)


def bilinear_sample(gray: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of frames gray [B, H, W] uint8 at float pixel
    coordinates xy [B, ..., 2] -> float32 [B, ...]. Out-of-bounds
    coordinates clamp to the border (callers gate validity separately).
    The four neighbor reads are the values of the JAX package's packed
    2x2 word: the last row and column replicate."""
    b, h, w = gray.shape
    x = torch.clamp(xy[..., 0], 0.0, w - 1.000001)
    y = torch.clamp(xy[..., 1], 0.0, h - 1.000001)
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx, fy = x - x0f, y - y0f
    x0, y0 = x0f.to(torch.int64), y0f.to(torch.int64)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    base = (torch.arange(b, device=gray.device) * (h * w)).reshape(
        b, *([1] * (x.dim() - 1)))
    flat = gray.reshape(-1)

    def read(yy, xx):
        return flat[base + yy * w + xx].to(torch.float32)

    v00, v01 = read(y0, x0), read(y0, x1)
    v10, v11 = read(y1, x0), read(y1, x1)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy
