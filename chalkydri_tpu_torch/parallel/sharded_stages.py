"""Detector stages over the row bands of a frame, with explicit halo and
seam exchange (port of ``chalkydri_tpu/parallel/sharded_stages.py``).

Frame rows are cut into bands over the ``space`` axis of the device grid.
Every stage takes the bands of ONE data group as a list (band ``j`` is a
[B, hl, W] tensor on its own device) and returns the same. A local-stencil
stage (the adaptive threshold) computes on its band plus a halo of the
neighbours' rows; the labeling exchanges its seam rows. The exchanges are
the functions of ``collectives``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from chalkydri_tpu_torch.detector.segment import (
    INVALID,
    _connectivity_masks,
    _round,
    padded_width,
)
from chalkydri_tpu_torch.detector.threshold import (
    MIN_WHITE_BLACK_DIFF,
    TILE,
    adaptive_threshold,
)
from chalkydri_tpu_torch.ops.propagate import (
    label_components_blocked,
    propagate_components_blocked,
)
from chalkydri_tpu_torch.parallel.collectives import fetch_rows

# Halo of the threshold stage: the 3x3 tile neighborhood reaches one
# 4-pixel tile into each neighbour's rows.
HALO_ROWS = TILE


def _fetch_facing(tops: Sequence[torch.Tensor], bottoms: Sequence[torch.Tensor],
                  fill):
    """For every band, the rows facing its top edge (the band above's
    ``bottoms``) and its bottom edge (the band below's ``tops``). The
    frame's own top and bottom face nothing: ``fill(rows)`` of the ring's
    wrap-around rows stands there."""
    above = fetch_rows(bottoms, +1)
    below = fetch_rows(tops, -1)
    above[0] = fill(above[0])
    below[-1] = fill(below[-1])
    return above, below


def _exchange_halo(blocks: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Each band [B, hl, W] with its neighbours' ``HALO_ROWS`` boundary
    rows around it: [B, hl + 2 * HALO_ROWS, W]. The frame's top and bottom
    are clamped (the edge row repeated), which adds nothing to any tile
    neighborhood, as the unsharded stage's edge handling does."""
    above = fetch_rows([b[:, -HALO_ROWS:] for b in blocks], +1)
    below = fetch_rows([b[:, :HALO_ROWS] for b in blocks], -1)
    above[0] = blocks[0][:, :1].expand(-1, HALO_ROWS, -1)
    below[-1] = blocks[-1][:, -1:].expand(-1, HALO_ROWS, -1)
    return [torch.cat([a, b, c], dim=1)
            for a, b, c in zip(above, blocks, below)]


def _threshold_block(gray_ext: torch.Tensor, min_diff: int) -> torch.Tensor:
    """Threshold the extended band, returning only the core rows."""
    return adaptive_threshold(gray_ext, min_diff=min_diff)[
        :, HALO_ROWS:-HALO_ROWS].contiguous()


def _seam_row_min(row_lab, row_val, n_lab, n_val):
    """Neighbor-min of one boundary label row against the FACING neighbour
    row: 4-connectivity for any equal ternary value, diagonals between
    whites only. THE seam connectivity rule, shared by the per-round path
    (``label_components_block``) and the kernel path (``_ici_seam_min``).
    Rows are [B, 1, W]; skip (127) pixels never merge."""
    m = row_lab
    valid = row_val != 127
    white = row_val == 255
    for dx in (0, 1, -1):
        nl, nv = n_lab, n_val
        if dx == 1:  # the neighbour at x - 1
            nl = F.pad(n_lab[..., :-1], (1, 0), value=INVALID)
            nv = F.pad(n_val[..., :-1], (1, 0), value=127)
        elif dx == -1:  # the neighbour at x + 1
            nl = F.pad(n_lab[..., 1:], (0, 1), value=INVALID)
            nv = F.pad(n_val[..., 1:], (0, 1), value=127)
        same = (nv == row_val) & valid
        if dx != 0:
            same = same & white
        m = torch.minimum(m, torch.where(same, nl, INVALID))
    return m


def _facing_values(blocks: Sequence[torch.Tensor]):
    """Per band, the ternary rows facing its top and bottom edge (skip
    where the frame ends, so nothing merges there). Round-invariant."""
    return _fetch_facing([b[:, :1] for b in blocks],
                         [b[:, -1:] for b in blocks],
                         lambda rows: torch.full_like(rows, 127))


def _ici_seam_min(labels: Sequence[torch.Tensor],
                  blocks: Sequence[torch.Tensor], facing=None):
    """One neighbor-min across the band seams: per band, its new top and
    bottom label rows ``(top, bottom)``, each [B, 1, W], after the facing
    rows of the neighbours (``_seam_row_min``). ``facing``: the result of
    ``_facing_values(blocks)`` when the caller already has it."""
    val_above, val_below = _facing_values(blocks) if facing is None else facing
    lab_above, lab_below = _fetch_facing(
        [lab[:, :1] for lab in labels], [lab[:, -1:] for lab in labels],
        lambda rows: torch.full_like(rows, INVALID))
    return [(_seam_row_min(lab[:, :1], blk[:, :1], la, va),
             _seam_row_min(lab[:, -1:], blk[:, -1:], lb, vb))
            for lab, blk, la, va, lb, vb in zip(
                labels, blocks, lab_above, val_above, lab_below, val_below)]


def _with_seam_rows(lab: torch.Tensor, top: torch.Tensor,
                    bottom: torch.Tensor) -> torch.Tensor:
    return torch.cat([top, lab[:, 1:-1], bottom], dim=1)


def label_components_block(blocks: Sequence[torch.Tensor],
                           iters: int) -> list[torch.Tensor]:
    """CCL over the bands [B, hl, W] of one data group with a seam
    exchange every round, in plain PyTorch (the JAX package's
    ``ccl_impl="jnp"``): labels start as flat indices of the whole frame
    (``row * W + col``), and each of the ``iters`` rounds takes the seam
    neighbor-min and then one propagation round within the band. Returns
    int32 labels per band, ``INVALID`` on skip pixels."""
    hl, w = blocks[0].shape[1:]
    state, labels = [], []
    for j, blk in enumerate(blocks):
        dev = blk.device
        val = blk.to(torch.int32)
        valid = blk != 127
        flat = ((torch.arange(hl, dtype=torch.int64, device=dev)[:, None]
                 + j * hl) * w
                + torch.arange(w, dtype=torch.int64, device=dev)[None, :])
        state.append((val, valid, _connectivity_masks(val, valid)))
        labels.append(torch.where(valid, flat, INVALID))
    facing = _facing_values(blocks)
    for _ in range(iters):
        seams = _ici_seam_min(labels, blocks, facing)
        labels = [_round(_with_seam_rows(lab, top, bottom), val, valid, masks)
                  for lab, (top, bottom), (val, valid, masks)
                  in zip(labels, seams, state)]
    return [lab.to(torch.int32) for lab in labels]


def label_components_block_kernel(blocks: Sequence[torch.Tensor],
                                  outer_rounds: int | None = None
                                  ) -> list[torch.Tensor]:
    """Kernel-backed CCL over the bands [B, hl, W] of one data group (the
    JAX package's ``label_components_block_pallas``): every band runs
    kernel B6 to its own fixed point (``label_components_blocked``), its
    labels move onto the frame's id space (local padded-flat index +
    ``j * hl * padded_width(W)``, monotone in (row, col), so
    order-isomorphic to ``label_components_block``'s), and then seam
    neighbor-mins alternate with ``propagate_components_blocked`` until a
    seam exchange changes no band, or ``outer_rounds`` (default
    ``2 * bands + 2``) propagations have run, which only a component
    serpentining between bands reaches.

    B6 is exact within a band, so "no seam row changed" IS the frame's
    fixed point; the JAX package's per-band convergence certificates are
    constant true here and drop out of the test.

    Host reads: the exit test reads ONE flag per round (every band's
    changed-flag gathered on the first band's device), as the JAX
    ``while_loop`` reads its ``psum``. The alternative, always running
    ``outer_rounds`` rounds without reading, is as correct (at the fixed
    point a round changes nothing) but costs ``2 * bands + 2`` propagations
    per band and their seam exchanges where a scene needs one to three,
    and the step's time goes to launches, not to the device. The read
    comes at the head of the step, where the device queue is short.
    ``label_components_block_kernel.host_reads`` counts them.

    B6's wrappers route by device (kernel on CUDA bands, plain twin on CPU
    bands), so this one loop is also the JAX package's interpret mode.
    """
    n = len(blocks)
    if outer_rounds is None:
        outer_rounds = 2 * n + 2
    hl, w = blocks[0].shape[1:]
    stride = hl * padded_width(w)
    labels = []
    for j, blk in enumerate(blocks):
        lab = label_components_blocked(blk)
        labels.append(torch.where(lab == INVALID, lab, lab + j * stride))
    if n == 1:
        return labels
    facing = _facing_values(blocks)
    lead = blocks[0].device
    for _ in range(outer_rounds):
        seams = _ici_seam_min(labels, blocks, facing)
        changed = torch.stack([
            ((top != lab[:, :1]).any() | (bottom != lab[:, -1:]).any()).to(lead)
            for lab, (top, bottom) in zip(labels, seams)]).any()
        label_components_block_kernel.host_reads += 1
        if not bool(changed):
            break
        labels = [propagate_components_blocked(
                      blk, _with_seam_rows(lab, top, bottom))
                  for blk, lab, (top, bottom) in zip(blocks, labels, seams)]
    return labels


label_components_block_kernel.host_reads = 0


def sharded_label_components(tern_bands, iters: int = 16):
    """Connected-component labeling with frame rows banded over 'space':
    ``tern_bands[i][j]`` (``mesh.place_frames(..., spatial=True)``) ->
    labels in the same layout, by the per-round path
    (``label_components_block``). With enough rounds the result equals the
    single-device ``label_components`` bit for bit."""
    return [label_components_block(group, iters) for group in tern_bands]


def sharded_adaptive_threshold(gray_bands,
                               min_diff: int = MIN_WHITE_BLACK_DIFF):
    """Adaptive threshold with rows banded over 'space' and the batch over
    'data': ``gray_bands[i][j]`` -> tern in the same layout, identical to
    ``detector.threshold.adaptive_threshold`` of the whole frames. Band
    rows must be a multiple of the 4-pixel tile."""
    out = []
    for group in gray_bands:
        if group[0].shape[1] % TILE:
            raise ValueError("rows must split into tiles")
        out.append([_threshold_block(ext, min_diff)
                    for ext in _exchange_halo(group)])
    return out
