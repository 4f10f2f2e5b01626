# Frozen copy of chalkydri_tpu_torch/detector/segment.py for the benchmark's plain
# reference; imports rewritten to this package. Do not edit to follow
# the program: the reference is held still while the program changes.
"""Stage 2: connected-component labeling by label propagation, the plain
twin of the CCL of kernels B1, B3 and B4, and with
``label_components_exact`` of B5 and B6 (port of
``chalkydri_tpu/detector/segment.py``).

Every non-skip pixel starts with its flat index ``y * W + x`` as label
(skip pixels: ``INVALID``). Each round is

1. a neighbor-min over connected neighbors: same ternary value, all 8
   offsets, the diagonals only between two white pixels (libapriltag's
   merge rule),
2. a segmented min along rows, then along columns: every run of equal
   ternary value takes its minimum label,
3. a remask of skip pixels to ``INVALID``.

Exactly ``iters`` rounds run. The JAX package's Pallas kernel and the CUDA
kernels stop early at a fixed point; the extra rounds here change nothing
there, so the labels are the same. ``rounds_needed`` counts the rounds a
frame takes to get there.

torch has no associative scan, so the segmented min is the packed form of
the Pallas kernel's ``_segmented_scan_axis_packed`` in int64: the run id (a
cumsum of run starts) sits above the bit-inverted label, one ``cummax``
gives the running minimum inside each run, and the same on the flipped
axis gives the backward pass. The minimum of the two is the run minimum,
exact at any frame size.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Label of skip (127) pixels: larger than any flat index.
INVALID = 2 ** 31 - 1

DEFAULT_ITERS = 8

_OFFSETS_ALL = ((0, 1), (0, -1), (1, 0), (-1, 0))
_OFFSETS_WHITE = ((1, 1), (1, -1), (-1, 1), (-1, -1))


def neighbor(x: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """The value at (y + dy, x + dx) for every pixel of [B, H, W] ``x``;
    ``fill`` outside the frame."""
    h, w = x.shape[-2], x.shape[-1]
    p = F.pad(x, (1, 1, 1, 1), value=fill)
    return p[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def _connectivity_masks(val: torch.Tensor, valid: torch.Tensor):
    """Per-offset connectivity masks, invariant across rounds."""
    masks = []
    is_white = val == 255
    for dy, dx in _OFFSETS_ALL:
        masks.append(((dy, dx), (neighbor(val, dy, dx, 127) == val) & valid))
    for dy, dx in _OFFSETS_WHITE:
        same = (neighbor(val, dy, dx, 127) == val) & valid & is_white
        masks.append(((dy, dx), same))
    return masks


def _neighbor_min(labels: torch.Tensor, masks) -> torch.Tensor:
    m = labels
    for (dy, dx), same in masks:
        nl = neighbor(labels, dy, dx, INVALID)
        m = torch.minimum(m, torch.where(same, nl, INVALID))
    return m


def _run_starts(val: torch.Tensor, dim: int) -> torch.Tensor:
    """int64 flags: 1 where a run of equal value starts along ``dim``."""
    starts = torch.ones_like(val, dtype=torch.int64)
    n = val.shape[dim]
    cur = val.narrow(dim, 1, n - 1)
    prev = val.narrow(dim, 0, n - 1)
    starts.narrow(dim, 1, n - 1).copy_((cur != prev).to(torch.int64))
    return starts


def _prefix_run_min(labels: torch.Tensor, val: torch.Tensor,
                    dim: int) -> torch.Tensor:
    """Running minimum of int64 ``labels`` inside each run of ``val`` along
    ``dim``, from the run start up to each element."""
    seg = torch.cumsum(_run_starts(val, dim), dim=dim)
    packed = (seg << 31) | (INVALID - labels)
    return INVALID - (torch.cummax(packed, dim=dim).values & INVALID)


def _segmented_min(labels: torch.Tensor, val: torch.Tensor,
                   dim: int) -> torch.Tensor:
    """Minimum label of each run of equal ``val`` along ``dim``."""
    fwd = _prefix_run_min(labels, val, dim)
    bwd = _prefix_run_min(labels.flip(dim), val.flip(dim), dim).flip(dim)
    return torch.minimum(fwd, bwd)


def _round(labels, val, valid, masks):
    lab = _neighbor_min(labels, masks)
    lab = _segmented_min(lab, val, dim=2)
    lab = _segmented_min(lab, val, dim=1)
    return torch.where(valid, lab, INVALID)


def _initial_labels(tern: torch.Tensor) -> torch.Tensor:
    _, h, w = tern.shape
    flat = torch.arange(h * w, dtype=torch.int64,
                        device=tern.device).reshape(1, h, w)
    return torch.where(tern != 127, flat, INVALID)


def label_components(tern: torch.Tensor, iters: int = DEFAULT_ITERS,
                     labels0: torch.Tensor | None = None) -> torch.Tensor:
    """Label connected components of a ternary image.

    tern: [B, H, W] uint8 in {0, 127, 255}; iters: propagation rounds;
    labels0: optional starting labels (default: flat indices).
    Returns labels [B, H, W] int32, ``INVALID`` on skip pixels.
    """
    val = tern.to(torch.int32)
    valid = tern != 127
    masks = _connectivity_masks(val, valid)
    labels = (_initial_labels(tern) if labels0 is None
              else torch.where(valid, labels0.to(torch.int64), INVALID))
    for _ in range(iters):
        labels = _round(labels, val, valid, masks)
    return labels.to(torch.int32)


def padded_width(w: int) -> int:
    """Row pitch of the exact labels: ``w`` rounded up to 128."""
    return -(-w // 128) * 128


def label_components_exact(tern: torch.Tensor,
                           labels0: torch.Tensor | None = None) -> torch.Tensor:
    """Labels at the global fixed point, the plain twin of kernels B5 and
    B6 (``chalkydri_tpu/ops/pallas/ccl_kernel.py::threshold_ccl_blocked``'s
    labeling, ``label_components_blocked_pallas`` and
    ``propagate_components_blocked``). Rounds repeat until one changes
    nothing, so every pixel ends with the minimum starting label of its
    component. The starting labels are ``labels0`` or, by default, flat
    indices in the lane-padded frame, ``y * padded_width(W) + x``: every
    component then carries its raster-first pixel's padded index. One
    host check per round: this version never runs on the card's path.

    tern: [B, H, W] uint8 in {0, 127, 255}; labels0: optional [B, H, W]
    integer labels. Returns [B, H, W] int32, ``INVALID`` on skip pixels.
    """
    val = tern.to(torch.int32)
    valid = tern != 127
    masks = _connectivity_masks(val, valid)
    if labels0 is None:
        _, h, w = tern.shape
        dev = tern.device
        labels0 = (torch.arange(h, dtype=torch.int64, device=dev)[:, None]
                   * padded_width(w)
                   + torch.arange(w, dtype=torch.int64, device=dev)[None, :])
    labels = torch.where(valid, labels0.to(torch.int64), INVALID)
    while True:
        nxt = _round(labels, val, valid, masks)
        if torch.equal(nxt, labels):
            return labels.to(torch.int32)
        labels = nxt


def rounds_needed(tern: torch.Tensor, iters: int) -> torch.Tensor:
    """Rounds each frame of ``tern`` needs to reach its fixed point, at
    most ``iters``: [B] int64, counted with the plain rounds. Frame b needs
    r rounds when round r + 1 is the first that changes none of its labels
    (the round at which the JAX package's Pallas kernels leave their loop).
    One host read a round."""
    labels = label_components(tern, iters=0)
    needed = torch.full((tern.shape[0],), iters, dtype=torch.int64,
                        device=tern.device)
    for r in range(iters):
        nxt = label_components(tern, iters=1, labels0=labels)
        same = (nxt == labels).flatten(1).all(dim=1)
        needed = torch.where(same, needed.clamp(max=r), needed)
        if bool(same.all()):
            break
        labels = nxt
    return needed
