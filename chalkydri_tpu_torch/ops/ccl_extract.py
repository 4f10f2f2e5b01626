"""Kernel B1: fused adaptive threshold + CCL + boundary-candidate
extraction.

``threshold_ccl_extract`` launches the CUDA kernel (``csrc/ccl_extract.cu``)
on CUDA tensors and runs the plain twin ``threshold_ccl_extract_plain`` on
CPU tensors; it replaces ``chalkydri_tpu/ops/pallas/ccl_kernel.py::
threshold_ccl_extract_pallas``. Output, bit for bit the same on every
route: (black, white, payload), each [B, 2*H*W] int32 in the
direction-major order of ``detector.cluster.extract_boundary_points``.

On the card the route is a function of the frame's shape alone
(``cluster_size``): every frame the detector sends (up to
``CLUSTER_MAX_PIXELS``) takes ONE launch of a thread-block cluster per
frame, its bands in shared memory; larger frames, which only direct callers
send, take the chain of launches over device memory that B3 shares.
``threshold_ccl_extract_rounds`` also returns the rounds each frame ran.
"""

from __future__ import annotations

import functools

import torch

from chalkydri_tpu_torch.detector.cluster import extract_boundary_points
from chalkydri_tpu_torch.detector.segment import label_components, rounds_needed
from chalkydri_tpu_torch.detector.threshold import (
    MIN_WHITE_BLACK_DIFF,
    adaptive_threshold,
)
from chalkydri_tpu_torch.ops import build

# A row is one CUDA block of up to 1024 threads x 4 pixels; a strip of 8
# columns x 4096 rows of labels and connectivity bytes (160 KB) fits a
# block's shared memory.
MAX_SIDE = 4096

# The cluster route: frames up to the detector's EXTRACT_BLOCK_MAX_PIXELS,
# one cluster of CLUSTER_SIZES[i] CTAs a frame, each CTA a band of whole
# 4-row tile rows in at most SHARED_BYTES of shared memory: 4 B a pixel
# (label, code and link bits in one word), 8 B a column of run summaries
# and FIXED_BYTES of exchange space (csrc/ccl_extract.cu::cluster_bytes).
CLUSTER_MAX_PIXELS = 540_000
CLUSTER_SIZES = (1, 2, 4, 8, 16)
SHARED_BYTES = 232_448
FIXED_BYTES = 1024


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


def cluster_bytes(h: int, w: int, c: int) -> int:
    """Shared memory of a CTA that holds a band of an h x w frame cut into
    c bands of whole tile rows: the tallest band's words, the column
    summaries and the fixed exchange space."""
    rows_max = 4 * -(-(h // 4) // c)
    return 4 * rows_max * w + 8 * w + FIXED_BYTES


@functools.lru_cache(maxsize=64)
def cluster_size(b: int, h: int, w: int) -> int | None:
    """The route of [b, h, w] frames: the CTAs a frame's cluster takes (the
    most of ``CLUSTER_SIZES`` that its tile rows allow, whose bands then
    fit ``SHARED_BYTES``), or None for the chain of launches (frames over
    ``CLUSTER_MAX_PIXELS``)."""
    if b < 1 or h % 4 or w % 4 or not 0 < h * w <= CLUSTER_MAX_PIXELS:
        return None
    for c in reversed(CLUSTER_SIZES):
        if c <= h // 4 and cluster_bytes(h, w, c) <= SHARED_BYTES:
            return c
    return None


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
    return threshold_ccl_extract_rounds(gray, iters, min_diff)[0]


def threshold_ccl_extract_rounds(gray: torch.Tensor, iters: int = 12,
                                 min_diff: int = MIN_WHITE_BLACK_DIFF):
    """``threshold_ccl_extract`` together with rounds [B] int32, the CCL
    rounds each frame ran: the kernel stops a frame after the round that
    changed none of its labels (the rounds it needs and the confirming
    one, at most ``iters``); the plain twin runs ``iters`` rounds, which
    gives the same pages, and counts what the kernel would run."""
    if gray.device.type == "cpu":
        tern = adaptive_threshold(gray, min_diff=min_diff)
        rounds = (rounds_needed(tern, iters) + 1).clamp(max=iters)
        return (threshold_ccl_extract_plain(gray, iters, min_diff),
                rounds.to(torch.int32))
    check_frames(gray, "threshold_ccl_extract")
    if iters < 0:
        raise ValueError("threshold_ccl_extract: iters < 0")
    if gray.data_ptr() % 16:
        gray = gray.clone()  # the kernels read 4 pixels at a time
    b, h, w = gray.shape
    pages = build.empty((3, b, 2 * h * w), torch.int32, gray)
    black, white, payload = pages.unbind(0)
    c = cluster_size(b, h, w)
    if c is not None:
        rounds = build.empty((b,), torch.int32, gray)
        rc = build.call("chalkydri_ccl_extract_cluster", gray,
                        gray.data_ptr(), b, h, w, c, iters, min_diff,
                        black.data_ptr(), white.data_ptr(),
                        payload.data_ptr(), rounds.data_ptr())
        build.check_cluster(rc, "threshold_ccl_extract", c,
                            cluster_bytes(h, w, c))
    else:
        tile_min = build.empty((b, h // 4, w // 4), torch.uint8, gray)
        tile_max = build.empty((b, h // 4, w // 4), torch.uint8, gray)
        tern = build.empty((b, h, w), torch.uint8, gray)
        bits = build.empty((b, h, w), torch.uint8, gray)
        lab_a = build.empty((b, h, w), torch.int32, gray)
        lab_b = build.empty((b, h, w), torch.int32, gray)
        flags = build.empty(((iters + 1) * b,), torch.int32, gray)
        build.launch("chalkydri_ccl_extract", gray, gray.data_ptr(), b, h, w,
                     iters, min_diff, tile_min.data_ptr(), tile_max.data_ptr(),
                     tern.data_ptr(), bits.data_ptr(), lab_a.data_ptr(),
                     lab_b.data_ptr(), flags.data_ptr(), black.data_ptr(),
                     white.data_ptr(), payload.data_ptr())
        rounds = flags[:b]
        threshold_ccl_extract.chain_launches += 1
    threshold_ccl_extract.launches += 1
    return (black, white, payload), rounds


threshold_ccl_extract.launches = 0
threshold_ccl_extract.chain_launches = 0  # of them, the chain route's
