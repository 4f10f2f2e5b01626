"""Kernel B7: boundary-candidate extraction from ternary + label images,
whole frames or row bands with halo rows.

``extract_candidates_band`` launches the CUDA kernel
(``csrc/extract_blocked.cu``) on CUDA tensors and runs the plain twin
``extract_candidates_band_plain`` on CPU tensors; it replaces
``chalkydri_tpu/ops/pallas/ccl_kernel.py::extract_candidates_blocked_pallas``,
whose body extracts one row block with one halo row above and two below
and the block's frame row in the payload. Here that block is the caller's
band: the row-banded detector extracts each band with its neighbours' halo
rows. ``extract_candidates_blocked`` is the whole-frame entry, the band
entry with no halo. It has no ``block_rows``: the TPU blocks rows to fit
VMEM, and here they would change nothing that is returned. On the card a
CTA takes a tile of core rows and stages its stencils' rows in shared
memory; the three pages are views of one allocation.

Output, bit for bit the same on either route: (black, white, payload),
each [B, 2*Hc*W] int32 for the Hc core rows, in the direction-major order
of ``detector.cluster.extract_boundary_points``.
"""

from __future__ import annotations

import torch

from chalkydri_tpu_torch.detector.cluster import extract_boundary_points
from chalkydri_tpu_torch.ops import build
from chalkydri_tpu_torch.ops.ccl_extract import check_frames


def _core_rows(hext: int, halo_top: int, halo_bottom: int) -> int:
    hc = hext - halo_top - halo_bottom
    if halo_top < 0 or halo_bottom < 0 or hc <= 0:
        raise ValueError(f"extract_candidates_band: {hext} rows leave no core "
                         f"between halos {halo_top} and {halo_bottom}")
    return hc


def extract_candidates_band_plain(tern_ext: torch.Tensor,
                                  labels_ext: torch.Tensor, halo_top: int = 1,
                                  halo_bottom: int = 2, y_offset: int = 0):
    """Plain PyTorch version: ``extract_boundary_points`` over the extended
    band, then the core rows' slots."""
    b, hext, w = tern_ext.shape
    hc = _core_rows(hext, halo_top, halo_bottom)
    pages = extract_boundary_points(tern_ext, labels_ext, halo_top=halo_top,
                                    halo_bottom=halo_bottom, y_offset=y_offset)
    return tuple(p.reshape(b, 2, hext, w)[:, :, halo_top:halo_top + hc]
                 .reshape(b, 2 * hc * w) for p in pages)


def extract_candidates_band(tern_ext: torch.Tensor, labels_ext: torch.Tensor,
                            halo_top: int = 1, halo_bottom: int = 2,
                            y_offset: int = 0):
    """tern_ext [B, Hext, W] uint8 and labels_ext [B, Hext, W] int32, the
    band's Hc core rows between ``halo_top`` rows above and ``halo_bottom``
    below -> (black, white, payload), each [B, 2*Hc*W] int32, with frame
    row ``y_offset`` + core row in the payload. CUDA tensors launch the
    kernel; CPU tensors take the plain twin."""
    if tern_ext.device.type == "cpu":
        return extract_candidates_band_plain(tern_ext, labels_ext, halo_top,
                                             halo_bottom, y_offset)
    check_frames(tern_ext, "extract_candidates_band", tiles=False)
    if (labels_ext.device != tern_ext.device
            or labels_ext.dtype != torch.int32
            or labels_ext.shape != tern_ext.shape
            or not labels_ext.is_contiguous()):
        raise ValueError("extract_candidates_band: labels must be contiguous "
                         "int32 of tern's shape, on its device")
    b, hext, w = tern_ext.shape
    hc = _core_rows(hext, halo_top, halo_bottom)
    if not 0 <= y_offset <= 4096 - hc:  # y2 = 2 * row + dy has 13 bits
        raise ValueError(f"extract_candidates_band: y_offset {y_offset}")
    pages = build.empty((3, b, 2 * hc * w), torch.int32, tern_ext)
    black, white, payload = pages.unbind(0)
    build.launch("chalkydri_extract_band", tern_ext, tern_ext.data_ptr(),
                 labels_ext.data_ptr(), b, hext, w, halo_top, halo_bottom,
                 y_offset, black.data_ptr(), white.data_ptr(),
                 payload.data_ptr())
    extract_candidates_band.launches += 1
    return black, white, payload


extract_candidates_band.launches = 0


def extract_candidates_blocked(tern: torch.Tensor, labels: torch.Tensor):
    """Whole frames: tern [B, H, W] uint8 and labels [B, H, W] int32 ->
    (black, white, payload), each [B, 2*H*W] int32, bit-identical to
    ``cluster.extract_boundary_points``. The band entry with no halo; its
    launches count there."""
    return extract_candidates_band(tern, labels, halo_top=0, halo_bottom=0,
                                   y_offset=0)
