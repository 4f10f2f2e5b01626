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

On the card the route is a function of the band's shape alone
(``band_cluster_size``): every band the row-banded step sends takes ONE
launch an entry, a thread-block cluster a frame with the frame's parent
entries in the CTAs' shared memory; larger frames, which only direct
callers send, take the global-memory union-find that B5 shares (3 and 5
launches). ``.launches`` counts the calls that launched, and
``.global_launches`` the large-frame route's share of them.

Each wrapper launches its kernel on CUDA tensors and runs its plain twin
(``segment.label_components_exact``) on CPU tensors; the two agree bit for
bit, and with the JAX package wherever its own certificate holds.
"""

from __future__ import annotations

import functools

import torch

from chalkydri_tpu_torch.detector.segment import (
    label_components_exact,
    padded_width,
)
from chalkydri_tpu_torch.ops import build
from chalkydri_tpu_torch.ops.ccl_extract import (
    CLUSTER_SIZES,
    SHARED_BYTES,
    check_frames,
)

# The cluster route: one frame per cluster of CLUSTER_SIZES[i] CTAs (as
# B1's), CTA k holding rows [k * R, (k + 1) * R), R = ceil(H / C), in at
# most SHARED_BYTES of shared memory: their parent entries (4 B a pixel),
# three words a 32-pixel chunk and FIXED_BYTES of scan space and union
# queues (a word and 64 pairs a warp of 32), then their tern bytes and the
# row above's (csrc/propagate.cu::cluster_bytes).
FIXED_BYTES = 32 * 4 * (1 + 2 * 64)


def band_cluster_bytes(h: int, w: int, c: int) -> int:
    """Shared memory of a CTA that holds ceil(h / c) rows of an h x w
    frame."""
    rows = -(-h // c)
    n = rows * w
    words = 4 * n + 12 * -(-n // 32) + FIXED_BYTES
    return -(-words // 16) * 16 + (rows + 1) * w


@functools.lru_cache(maxsize=64)
def band_cluster_size(b: int, h: int, w: int) -> int | None:
    """The route of [b, h, w] frames: the CTAs a frame's cluster takes (the
    most of ``CLUSTER_SIZES``, at most one a row, whose rows then fit
    ``SHARED_BYTES``), or None for the global-memory union-find."""
    if b < 1 or h < 1 or w < 1:
        return None
    for c in reversed(CLUSTER_SIZES):
        if c <= h and band_cluster_bytes(h, w, c) <= SHARED_BYTES:
            return c
    return None


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
    labels = build.empty((b, h, w), torch.int32, tern)
    c = band_cluster_size(b, h, w)
    if c is not None:
        build.check_cluster(build.call(
            "chalkydri_label_components_cluster", tern, tern.data_ptr(), b, h,
            w, padded_width(w), c, labels.data_ptr()),
            "label_components_blocked", c, band_cluster_bytes(h, w, c))
    else:
        parent = build.empty((b, h, w), torch.int32, tern)
        build.launch("chalkydri_label_components_exact", tern,
                     tern.data_ptr(), b, h, w, padded_width(w),
                     parent.data_ptr(), labels.data_ptr())
        label_components_blocked.global_launches += 1
    label_components_blocked.launches += 1
    return _with_certificate(labels, want_converged)


label_components_blocked.launches = 0
label_components_blocked.global_launches = 0  # of them, the large frames'


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
    out = build.empty((b, h, w), torch.int32, tern)
    c = band_cluster_size(b, h, w)
    if c is not None:
        build.check_cluster(build.call(
            "chalkydri_propagate_components_cluster", tern, tern.data_ptr(),
            labels.data_ptr(), b, h, w, c, out.data_ptr()),
            "propagate_components_blocked", c, band_cluster_bytes(h, w, c))
    else:
        parent = build.empty((b, h, w), torch.int32, tern)
        rootval = build.empty((b, h, w), torch.int32, tern)
        build.launch("chalkydri_propagate_components", tern, tern.data_ptr(),
                     labels.data_ptr(), b, h, w, parent.data_ptr(),
                     rootval.data_ptr(), out.data_ptr())
        propagate_components_blocked.global_launches += 1
    propagate_components_blocked.launches += 1
    return _with_certificate(out, want_converged)


propagate_components_blocked.launches = 0
propagate_components_blocked.global_launches = 0  # of them, the large frames'
