"""Kernels B3, B4 and B5: adaptive threshold and connected-component
labeling for the full-resolution quad search (``quad_decimate=1``).

- ``threshold_ccl`` (B3) replaces ``chalkydri_tpu/ops/pallas/ccl_kernel.py::
  threshold_ccl_pallas``: gray -> (tern, labels after ``iters`` propagation
  rounds). It launches the threshold stage, then B4.
- ``label_components_ccl`` (B4) replaces ``label_components_pallas``: the
  same rounds from a given tern. Like the Pallas kernel it stops each
  frame at its fixed point, on the card and with no host read;
  ``label_components_ccl_rounds`` also returns the rounds each frame ran.
- ``threshold_ccl_exact`` (B5) replaces ``threshold_ccl_blocked``: gray ->
  (tern, labels at the global fixed point), each component labelled with
  its raster-first pixel's index in the frame padded to a multiple of 128
  columns (``detector.segment.padded_width``). The TPU kernel blocks rows
  to fit VMEM and merges the seams; on this card a union-find computes
  the fixed point those merges certify, in three launches: the threshold
  fused with a union-find in shared memory over each rectangle of
  ``RECT_ROWS`` x ``RECT_COLS`` pixels, the unions across the
  rectangles' borders, and a pass that resolves the labels of the
  components that cross them. It has no ``block_rows``, ``merge`` or
  ``merge_rounds``: here they would change nothing it returns.

Each wrapper launches its kernel (``csrc/threshold_ccl.cu``) on CUDA
tensors and runs its plain twin on CPU tensors; tern, labels and their
twins agree bit for bit.
"""

from __future__ import annotations

import torch

from chalkydri_tpu_torch.detector.segment import (
    label_components,
    label_components_exact,
    padded_width,
    rounds_needed,
)
from chalkydri_tpu_torch.detector.threshold import (
    MIN_WHITE_BLACK_DIFF,
    adaptive_threshold,
)
from chalkydri_tpu_torch.ops import build
from chalkydri_tpu_torch.ops.ccl_extract import check_frames

# B5's rectangle (``csrc/threshold_ccl.cu``: kRows, kCols), whole 4x4
# threshold tiles; the last rectangles of a frame are cut to its edges.
RECT_ROWS, RECT_COLS = 32, 128


def threshold_ccl_plain(gray: torch.Tensor, iters: int = 12,
                        min_diff: int = MIN_WHITE_BLACK_DIFF):
    """Plain PyTorch version of B3: threshold -> ``iters`` CCL rounds."""
    tern = adaptive_threshold(gray, min_diff=min_diff)
    return tern, label_components(tern, iters=iters)


def threshold_ccl(gray: torch.Tensor, iters: int = 12,
                  min_diff: int = MIN_WHITE_BLACK_DIFF):
    """gray [B, H, W] uint8 (H, W multiples of 4) -> (tern uint8, labels
    int32), each [B, H, W]. CUDA tensors launch the kernels; CPU tensors
    take the plain twin."""
    if gray.device.type == "cpu":
        return threshold_ccl_plain(gray, iters, min_diff)
    check_frames(gray, "threshold_ccl")
    if iters < 0:
        raise ValueError("threshold_ccl: iters < 0")
    b, h, w = gray.shape
    tile_min = build.empty((b, h // 4, w // 4), torch.uint8, gray)
    tile_max = build.empty((b, h // 4, w // 4), torch.uint8, gray)
    tern = build.empty((b, h, w), torch.uint8, gray)
    build.launch("chalkydri_threshold", gray, gray.data_ptr(), b, h, w,
                 min_diff, tile_min.data_ptr(), tile_max.data_ptr(),
                 tern.data_ptr())
    threshold_ccl.launches += 1
    return tern, label_components_ccl(tern, iters)


threshold_ccl.launches = 0


def label_components_ccl(tern: torch.Tensor, iters: int = 12) -> torch.Tensor:
    """tern [B, H, W] uint8 -> labels [B, H, W] int32 after ``iters``
    rounds (``INVALID`` on skip pixels). CUDA tensors launch the kernel;
    CPU tensors take the plain twin ``segment.label_components``."""
    if tern.device.type == "cpu":
        return label_components(tern, iters=iters)
    return label_components_ccl_rounds(tern, iters)[0]


def label_components_ccl_rounds(tern: torch.Tensor, iters: int = 12):
    """``label_components_ccl`` together with rounds [B] int32, the rounds
    each frame ran: the kernel stops a frame after the round that changed
    none of its labels (the rounds it needs and the confirming one, at
    most ``iters``); the plain twin runs ``iters`` rounds, which gives the
    same labels, and counts what the kernel would run."""
    if tern.device.type == "cpu":
        rounds = (rounds_needed(tern, iters) + 1).clamp(max=iters)
        return label_components(tern, iters=iters), rounds.to(torch.int32)
    check_frames(tern, "label_components_ccl", tiles=False)
    if iters < 0:
        raise ValueError("label_components_ccl: iters < 0")
    b, h, w = tern.shape
    bits = build.empty((b, h, w), torch.uint8, tern)
    labels = build.empty((b, h, w), torch.int32, tern)
    scratch = build.empty((b, h, w), torch.int32, tern)
    flags = build.empty(((iters + 1) * b,), torch.int32, tern)
    build.launch("chalkydri_label_components", tern, tern.data_ptr(), b, h,
                 w, iters, bits.data_ptr(), labels.data_ptr(),
                 scratch.data_ptr(), flags.data_ptr())
    label_components_ccl.launches += 1
    return labels, flags[:b]


label_components_ccl.launches = 0


def threshold_ccl_exact_plain(gray: torch.Tensor,
                              min_diff: int = MIN_WHITE_BLACK_DIFF):
    """Plain PyTorch version of B5: threshold -> CCL to the fixed point."""
    tern = adaptive_threshold(gray, min_diff=min_diff)
    return tern, label_components_exact(tern)


def threshold_ccl_exact(gray: torch.Tensor,
                        min_diff: int = MIN_WHITE_BLACK_DIFF):
    """gray [B, H, W] uint8 (H, W multiples of 4) -> (tern uint8, labels
    int32), each [B, H, W], the labels at the global fixed point in
    padded-flat indices. CUDA tensors launch the kernel; CPU tensors take
    the plain twin."""
    if gray.device.type == "cpu":
        return threshold_ccl_exact_plain(gray, min_diff)
    check_frames(gray, "threshold_ccl_exact")
    b, h, w = gray.shape
    tern = build.empty((b, h, w), torch.uint8, gray)
    parent = build.empty((b, h, w), torch.int32, gray)
    labels = build.empty((b, h, w), torch.int32, gray)
    build.launch("chalkydri_threshold_ccl_exact", gray, gray.data_ptr(), b,
                 h, w, padded_width(w), min_diff, tern.data_ptr(),
                 parent.data_ptr(), labels.data_ptr())
    threshold_ccl_exact.launches += 1
    return tern, labels


threshold_ccl_exact.launches = 0
