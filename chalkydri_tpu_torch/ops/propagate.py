"""Kernel B6: a row band's component labels at its frame-local fixed point.

Both wrappers replace ``chalkydri_tpu/ops/pallas/ccl_kernel.py::
_blocked_propagate`` as the JAX package reaches it:

- ``label_components_blocked`` (``label_components_blocked_pallas``): tern
  -> labels from flat indices, each component labelled with its
  raster-first pixel's index in the frame padded to a multiple of 128
  columns (``detector.segment.padded_width``);
- ``propagate_components_blocked`` (``propagate_components_blocked``): tern
  + labels the caller provides -> every pixel gets the minimum caller
  label of its component. The row-banded detector calls it between seam
  exchanges with globally offset labels.

The TPU kernels block rows to fit VMEM, run ``iters`` rounds per block and
merge block seams for up to ``merge_rounds`` rounds; on this card a
union-find computes the fixed point those merges certify
(``csrc/propagate.cu``), so the wrappers take no ``iters``, ``block_rows``
or ``merge_rounds``: here they would change nothing that is returned.
``want_converged=True`` also returns the certificate the caller's outer
loop reads. The union-find is exact, so it is a constant true tensor on
the pixels' device.

Each wrapper launches its kernel on CUDA tensors and runs its plain twin
(``segment.label_components_exact``) on CPU tensors; the two agree bit for
bit, and with the JAX package wherever its own certificate holds.
"""

from __future__ import annotations

import torch

from chalkydri_tpu_torch.detector.segment import (
    label_components_exact,
    padded_width,
)
from chalkydri_tpu_torch.ops import build
from chalkydri_tpu_torch.ops.ccl_extract import check_frames


def _with_certificate(labels: torch.Tensor, want_converged: bool):
    if not want_converged:
        return labels
    return labels, torch.ones((), dtype=torch.bool, device=labels.device)


def label_components_blocked_plain(tern: torch.Tensor,
                                   want_converged: bool = False):
    """Plain PyTorch version of ``label_components_blocked``."""
    return _with_certificate(label_components_exact(tern), want_converged)


def label_components_blocked(tern: torch.Tensor, want_converged: bool = False):
    """tern [B, H, W] uint8 -> labels [B, H, W] int32 at the frame-local
    fixed point, padded-flat (``INVALID`` on skip pixels); with
    ``want_converged`` also the certificate, constant true. CUDA tensors
    launch the kernel; CPU tensors take the plain twin."""
    if tern.device.type == "cpu":
        return label_components_blocked_plain(tern, want_converged)
    check_frames(tern, "label_components_blocked", tiles=False)
    b, h, w = tern.shape
    parent = build.empty((b, h, w), torch.int32, tern)
    labels = build.empty((b, h, w), torch.int32, tern)
    build.launch("chalkydri_label_components_exact", tern, tern.data_ptr(), b,
                 h, w, padded_width(w), parent.data_ptr(), labels.data_ptr())
    label_components_blocked.launches += 1
    return _with_certificate(labels, want_converged)


label_components_blocked.launches = 0


def propagate_components_blocked_plain(tern: torch.Tensor,
                                       labels: torch.Tensor,
                                       want_converged: bool = False):
    """Plain PyTorch version of ``propagate_components_blocked``."""
    return _with_certificate(label_components_exact(tern, labels0=labels),
                             want_converged)


def propagate_components_blocked(tern: torch.Tensor, labels: torch.Tensor,
                                 want_converged: bool = False):
    """tern [B, H, W] uint8 and labels [B, H, W] int32 (non-negative,
    ``INVALID`` on skip pixels) -> [B, H, W] int32, every pixel with the
    minimum label of its component; with ``want_converged`` also the
    certificate, constant true. CUDA tensors launch the kernel; CPU tensors
    take the plain twin."""
    if tern.device.type == "cpu":
        return propagate_components_blocked_plain(tern, labels, want_converged)
    check_frames(tern, "propagate_components_blocked", tiles=False)
    if (labels.device != tern.device or labels.dtype != torch.int32
            or labels.shape != tern.shape or not labels.is_contiguous()):
        raise ValueError("propagate_components_blocked: labels must be "
                         "contiguous int32 of tern's shape, on its device")
    b, h, w = tern.shape
    parent = build.empty((b, h, w), torch.int32, tern)
    rootval = build.empty((b, h, w), torch.int32, tern)
    out = build.empty((b, h, w), torch.int32, tern)
    build.launch("chalkydri_propagate_components", tern, tern.data_ptr(),
                 labels.data_ptr(), b, h, w, parent.data_ptr(),
                 rootval.data_ptr(), out.data_ptr())
    propagate_components_blocked.launches += 1
    return _with_certificate(out, want_converged)


propagate_components_blocked.launches = 0
