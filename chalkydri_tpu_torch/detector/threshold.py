"""Stage 1: adaptive (tile-local min/max) thresholding, the plain twin of
kernel B1's prologue (port of ``chalkydri_tpu/detector/threshold.py``).

Split the frame into 4x4 tiles, take each tile's min and max, dilate both
over the 3x3 tile neighborhood (out-of-frame tiles contribute nothing),
and classify every pixel into {0 black, 255 white, 127 skip}: skip where
the neighborhood contrast is below ``min_diff``, else white iff the pixel
is above ``min + (max - min) // 2``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

TILE = 4
MIN_WHITE_BLACK_DIFF = 5


def _neighborhood3(x: torch.Tensor, op: str) -> torch.Tensor:
    """3x3 min/max over the tile grid [B, th, tw]; the padding value (255
    for min, 0 for max) contributes nothing."""
    fill = 255 if op == "min" else 0
    fn = torch.minimum if op == "min" else torch.maximum
    th, tw = x.shape[1], x.shape[2]
    p = F.pad(x, (1, 1, 1, 1), value=fill)
    out = x
    for dy in range(3):
        for dx in range(3):
            out = fn(out, p[:, dy:dy + th, dx:dx + tw])
    return out


def adaptive_threshold(gray: torch.Tensor,
                       min_diff: int = MIN_WHITE_BLACK_DIFF) -> torch.Tensor:
    """gray [B, H, W] uint8 (H, W multiples of 4) -> tern [B, H, W] uint8
    in {0, 127, 255}."""
    if gray.dim() != 3 or gray.dtype != torch.uint8:
        raise ValueError("expected gray [B, H, W] uint8")
    b, h, w = gray.shape
    if h % TILE or w % TILE:
        raise ValueError("pad frames to 4-pixel multiples")
    g = gray.to(torch.int32)
    t = g.reshape(b, h // TILE, TILE, w // TILE, TILE)
    tmin = _neighborhood3(t.amin(dim=(2, 4)), "min")
    tmax = _neighborhood3(t.amax(dim=(2, 4)), "max")
    pmin = tmin.repeat_interleave(TILE, 1).repeat_interleave(TILE, 2)
    pmax = tmax.repeat_interleave(TILE, 1).repeat_interleave(TILE, 2)
    contrast = pmax - pmin
    thresh = pmin + contrast // 2
    tern = torch.where(g > thresh, 255, 0)
    tern = torch.where(contrast < min_diff, 127, tern)
    return tern.to(torch.uint8)
