"""Color -> grayscale conversion on the frames' device (port of
``chalkydri_tpu/detector/grayscale.py``).

Formats: GREY (no-op), RGB/BGR(A) interleaved, YUYV packed, NV12/I420
planar (the Y plane), with the integer BT.601 luma weights (x256).
"""

from __future__ import annotations

import torch

_R, _G, _B = 77, 150, 29


def to_gray_device(frames: torch.Tensor, fourcc: str = "GREY") -> torch.Tensor:
    """A batch of raw frames -> contiguous GRAY8 [B, H, W] uint8.

    Shapes by format:
      GREY: [B, H, W] u8 (returned as it is)
      RGB/BGR: [B, H, W, 3] u8 (RGBA/BGRA: [B, H, W, 4])
      YUYV: [B, H, 2*W] u8 packed (Y0 U Y1 V)
      NV12/I420: [B, 3*H/2, W] u8 planar (Y plane is the top H rows)
    """
    f = fourcc.upper()
    if f in ("GREY", "GRAY", "GRAY8", "Y800"):
        return frames
    if f in ("RGB", "RGB3", "RGBA", "BGR", "BGR3", "BGRA"):
        c = frames.to(torch.int32)
        if f.startswith("RGB"):
            r, g, b = c[..., 0], c[..., 1], c[..., 2]
        else:
            b, g, r = c[..., 0], c[..., 1], c[..., 2]
        return ((_R * r + _G * g + _B * b) >> 8).to(torch.uint8)
    if f in ("YUYV", "YUY2"):
        return frames[..., 0::2].contiguous()
    if f in ("NV12", "I420", "YU12"):
        h = (frames.shape[1] * 2) // 3
        return frames[:, :h, :].contiguous()
    raise ValueError(f"unsupported fourcc {fourcc!r}")
