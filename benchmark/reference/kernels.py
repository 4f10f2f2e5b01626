"""The plain versions of the program's hand-written kernels (frozen copies
of the plain twins in ``chalkydri_tpu_torch/ops/``): B1
``threshold_ccl_extract``, B3 ``threshold_ccl``, B5 ``threshold_ccl_exact``
and B2 ``segment_stats``, on whatever device their inputs are. Plain
PyTorch only: no kernel library, no graph."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .segment import label_components, label_components_exact
from .threshold import MIN_WHITE_BLACK_DIFF, adaptive_threshold

CHUNK = 128
_INT_MAX = 2 ** 31 - 1


def threshold_ccl_extract(gray: torch.Tensor, iters: int = 12,
                          min_diff: int = MIN_WHITE_BLACK_DIFF):
    """B1: threshold -> ``iters`` CCL rounds -> dense boundary
    candidates."""
    from .cluster import extract_boundary_points  # cluster imports this module

    tern = adaptive_threshold(gray, min_diff=min_diff)
    labels = label_components(tern, iters=iters)
    return extract_boundary_points(tern, labels)


def threshold_ccl(gray: torch.Tensor, iters: int = 12,
                  min_diff: int = MIN_WHITE_BLACK_DIFF):
    """B3: threshold -> ``iters`` CCL rounds."""
    tern = adaptive_threshold(gray, min_diff=min_diff)
    return tern, label_components(tern, iters=iters)


def threshold_ccl_exact(gray: torch.Tensor,
                        min_diff: int = MIN_WHITE_BLACK_DIFF):
    """B5: threshold -> CCL to the fixed point."""
    tern = adaptive_threshold(gray, min_diff=min_diff)
    return tern, label_components_exact(tern)


def _chunk_top(grid: torch.Tensor):
    """Max of each row of [B, nc, 128] and the lowest lane holding it."""
    m = grid.amax(dim=-1)
    lanes = torch.arange(CHUNK, dtype=torch.int32, device=grid.device)
    a = torch.where(grid == m[..., None], lanes, CHUNK).amin(dim=-1)
    return m, a


def segment_stats(s_key: torch.Tensor, s_payload: torch.Tensor):
    """B2: (t, cand_len, cand_pos), all int32, of [B, n] sorted keys."""
    b, n = s_key.shape
    dev = s_key.device
    s_valid = s_key != _INT_MAX
    prev = torch.cat([torch.full((b, 1), -1, dtype=s_key.dtype, device=dev),
                      s_key[:, :-1]], dim=1)
    new_seg = s_key != prev
    idx = torch.arange(n, dtype=torch.int32, device=dev).expand(b, n)
    start_pos = torch.cummax(torch.where(new_seg, idx, -1), dim=1).values
    nxt = torch.where(new_seg, idx, _INT_MAX)
    next_start = torch.cummin(nxt.flip(1), dim=1).values.flip(1)
    next_start = torch.cat([next_start[:, 1:],
                            torch.full((b, 1), n, dtype=torch.int32, device=dev)],
                           dim=1)
    next_start = torch.clamp(next_start, max=n)
    score = torch.where(new_seg & s_valid, next_start - start_pos, 0)
    d0 = ((((s_payload >> 26) & 0x3) == 0) & s_valid).to(torch.int32)
    t = torch.cumsum(d0, dim=1, dtype=torch.int32)

    grid = F.pad(score, (0, (-n) % CHUNK)).reshape(b, -1, CHUNK)
    m1, a1 = _chunk_top(grid)
    lanes = torch.arange(CHUNK, dtype=torch.int32, device=dev)
    m2, a2 = _chunk_top(torch.where(lanes == a1[..., None], 0, grid))
    base = torch.arange(grid.shape[1], dtype=torch.int32, device=dev) * CHUNK
    cand_len = torch.cat([m1, m2], dim=1).to(torch.int32)
    cand_pos = torch.cat([base + a1, base + a2], dim=1).to(torch.int32)
    return t, cand_len, cand_pos
