"""Kernels X1-X3: boundary extraction and block compaction of
full-resolution ternary + label images (``csrc/front.cu``), without the
dense candidate pages.

``extract_compact`` launches the three kernels where ``build.on_card``
says so and returns its plain twin ``detector/cluster.py::
extract_and_compact``'s result elsewhere, bit for bit the same:

- X1 (count): a CTA a 128 x 128 pixel tile; the speckle gate and both
  edge tests on the staged ternary bytes, then the tile's 128 direction-1
  and 128 direction-0 block counts and each row's and column's edge
  flags;
- X2 (select): a CTA a (direction, frame); the flags ORed and dilated
  into ``direction_boosts``, each block scored as ``rank_blocks`` scores
  it, the top ``k`` kept in its order (score descending, the lower index
  first) and the counts left out summed into ``dropped``;
- X3 (emit): a warp a kept block; its 128 slots recomputed from the
  ternary and label pages and written in kept order.

Frames with no more than ``max_points`` candidates (``2 * H * W``) are not
compacted: on the card they take B7's dense pages
(``ops/extract_blocked.py``), which are the twin's there, with ``dropped``
0, and X1-X3 do not launch. The kernels replace no TPU
kernel; they exist because the plain chain moves ~200 MB at [2, 1304,
1600] to keep 3.1 MB. One call counts one launch in
``extract_compact.launches`` (``ops/build.py::count``); it makes three.
"""

from __future__ import annotations

import torch

from chalkydri_tpu_torch.detector import cluster
from chalkydri_tpu_torch.ops import build
from chalkydri_tpu_torch.ops.ccl_extract import check_frames
from chalkydri_tpu_torch.ops.extract_blocked import extract_candidates_blocked

BLOCK = 128  # slots a block, pixels a side of X1's tile
MAX_KEEP = 4096  # blocks X2 keeps of a direction (csrc/front.cu)
FLAG_PARTS = 32  # flag bytes a line (csrc/front.cu: kFlagParts)


def _pitch(blocks: int) -> int:
    """A frame's bytes of block counts (csrc/front.cu: count_pitch)."""
    return -(-blocks // 16) * 16


def scratch_bytes(b: int, h: int, w: int) -> tuple[int, int, int, int]:
    """Bytes of X1's outputs for [b, h, w]: the block counts of direction
    0 and 1, and the flags of each column and row."""
    r, c = -(-h // BLOCK), -(-w // BLOCK)
    return (b * _pitch(w * r), b * _pitch(h * c), b * w * FLAG_PARTS,
            b * h * FLAG_PARTS)


def kept_blocks(h: int, w: int, max_points: int) -> tuple[int, int]:
    """(k0, k1): the blocks ``_compact_blocks`` keeps of direction 0
    (``w * ceil(h / 128)`` of them) and of direction 1
    (``h * ceil(w / 128)``) at ``max_points``."""
    per_dir = int(cluster.COMPACT_SLACK * max_points) // BLOCK // 2
    r, c = -(-h // BLOCK), -(-w // BLOCK)
    return max(1, min(per_dir, w * r)), max(1, min(per_dir, h * c))


def extract_compact(tern: torch.Tensor, labels: torch.Tensor,
                    max_points: int = cluster.MAX_EDGE_POINTS):
    """tern [B, H, W] uint8 and labels [B, H, W] int32 -> (black, white,
    payload, dropped [B]), ``extract_and_compact``'s outputs: the kernels
    on the card (B7 where the frames need no compaction), else the plain
    twin.
    The labels of 0 and 255 pixels must not be INT_MAX (true of every CCL
    labelling here): X1 counts edges, where the twin counts labels."""
    if not build.on_card(tern, labels):
        return cluster.extract_and_compact(tern, labels, max_points)
    b, h, w = tern.shape
    if 2 * h * w <= max_points:
        dropped = torch.zeros(b, dtype=torch.int32, device=tern.device)
        return (*extract_candidates_blocked(tern, labels), dropped)
    if (labels.device != tern.device or labels.dtype != torch.int32
            or labels.shape != tern.shape or not labels.is_contiguous()):
        raise ValueError("extract_compact: labels must be contiguous int32 "
                         "of tern's shape, on its device")
    k0, k1 = kept_blocks(h, w, max_points)
    if max(k0, k1) > MAX_KEEP:
        raise ValueError(f"extract_compact: {max(k0, k1)} blocks kept a "
                         f"direction at max_points {max_points}, the "
                         f"kernels keep at most {MAX_KEEP}")
    check_frames(tern, "extract_compact", tiles=False)
    sizes = scratch_bytes(b, h, w)  # each a multiple of 16
    tiles = build.empty((sum(sizes),), torch.uint8, tern)
    counts0, counts1, flags0, flags1 = tiles.split(sizes)
    sel = build.empty((b, k0 + k1), torch.int32, tern)
    part = build.empty((b, 2), torch.int32, tern)
    pages = build.empty((3, b, (k0 + k1) * BLOCK), torch.int32, tern)
    black, white, payload = pages.unbind(0)
    dropped = build.empty((b,), torch.int32, tern)
    build.launch("chalkydri_front_extract", tern, tern.data_ptr(),
                 labels.data_ptr(), b, h, w, k0, k1,
                 *(x.data_ptr() for x in (counts0, counts1, flags0, flags1,
                                          sel, part, black, white, payload,
                                          dropped)))
    build.count(extract_compact)
    return black, white, payload, dropped


extract_compact.launches = 0
