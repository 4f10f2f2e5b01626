"""Kernel B1: fused adaptive threshold + CCL + boundary-candidate
extraction.

``threshold_ccl_extract`` launches the CUDA kernel (``csrc/ccl_extract.cu``)
on CUDA tensors and runs the plain twin ``threshold_ccl_extract_plain`` on
CPU tensors; it replaces ``chalkydri_tpu/ops/pallas/ccl_kernel.py::
threshold_ccl_extract_pallas``. Output, bit for bit the same on either
route: (black, white, payload), each [B, 2*H*W] int32 in the
direction-major order of ``detector.cluster.extract_boundary_points``.
"""

from __future__ import annotations

import torch

from chalkydri_tpu_torch.detector.cluster import extract_boundary_points
from chalkydri_tpu_torch.detector.segment import label_components
from chalkydri_tpu_torch.detector.threshold import (
    MIN_WHITE_BLACK_DIFF,
    adaptive_threshold,
)
from chalkydri_tpu_torch.ops import build

# A row is one CUDA block of up to 1024 threads x 4 pixels; a strip of 8
# columns x 4096 rows of labels and connectivity bytes (160 KB) fits a
# block's shared memory.
MAX_SIDE = 4096


def check_frames(x: torch.Tensor, name: str, tiles: bool = True) -> None:
    """Raise unless ``x`` is a contiguous [B, H, W] uint8 CUDA tensor that
    the CCL kernels take: sides at most ``MAX_SIDE`` (multiples of the
    4-pixel tile when ``tiles``) and fewer than 2^31 pixels in all."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype != torch.uint8 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{name}: expected contiguous [B, H, W] uint8")
    b, h, w = x.shape
    if (tiles and (h % 4 or w % 4)) or not (0 < h <= MAX_SIDE
                                            and 0 < w <= MAX_SIDE):
        raise ValueError(f"{name}: {h}x{w} frames must be "
                         f"{'multiples of 4 and ' if tiles else ''}"
                         f"at most {MAX_SIDE} a side")
    if b * h * w >= 2 ** 31:
        raise ValueError(f"{name}: batch too large")


def threshold_ccl_extract_plain(gray: torch.Tensor, iters: int = 12,
                                min_diff: int = MIN_WHITE_BLACK_DIFF):
    """Plain PyTorch version: threshold -> ``iters`` CCL rounds -> dense
    boundary candidates."""
    tern = adaptive_threshold(gray, min_diff=min_diff)
    labels = label_components(tern, iters=iters)
    return extract_boundary_points(tern, labels)


def threshold_ccl_extract(gray: torch.Tensor, iters: int = 12,
                          min_diff: int = MIN_WHITE_BLACK_DIFF):
    """gray [B, H, W] uint8 (H, W multiples of 4) -> (black, white,
    payload), each [B, 2*H*W] int32. CUDA tensors launch the kernel; CPU
    tensors take the plain twin."""
    if gray.device.type == "cpu":
        return threshold_ccl_extract_plain(gray, iters, min_diff)
    check_frames(gray, "threshold_ccl_extract")
    if iters < 0:
        raise ValueError("threshold_ccl_extract: iters < 0")
    b, h, w = gray.shape
    dev = gray.device

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    tile_min = empty((b, h // 4, w // 4), torch.uint8)
    tile_max = empty((b, h // 4, w // 4), torch.uint8)
    tern = empty((b, h, w), torch.uint8)
    bits = empty((b, h, w), torch.uint8)
    lab_a = empty((b, h, w), torch.int32)
    lab_b = empty((b, h, w), torch.int32)
    flags = empty(((iters + 1) * b,), torch.int32)
    black = empty((b, 2 * h * w), torch.int32)
    white = empty((b, 2 * h * w), torch.int32)
    payload = empty((b, 2 * h * w), torch.int32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = build.kernel_library().chalkydri_ccl_extract(
            gray.data_ptr(), b, h, w, iters, min_diff,
            tile_min.data_ptr(), tile_max.data_ptr(), tern.data_ptr(),
            bits.data_ptr(), lab_a.data_ptr(), lab_b.data_ptr(),
            flags.data_ptr(), black.data_ptr(), white.data_ptr(),
            payload.data_ptr(), stream)
    build.check(rc, "threshold_ccl_extract")
    threshold_ccl_extract.launches += 1
    return black, white, payload


threshold_ccl_extract.launches = 0
