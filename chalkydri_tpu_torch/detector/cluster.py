"""Stage 3: gradient clustering, boundary points grouped by (black blob,
white blob) pair (port of ``chalkydri_tpu/detector/cluster.py``).

- ``extract_boundary_points`` enumerates every right and down neighbor
  pair densely and packs position + direction into one int32 payload (the
  plain twin of kernel B1's epilogue and, with its halo arguments, of
  kernel B7),
- ``compact_candidates`` keeps only the highest-ranked 128-candidate
  blocks per direction, orientation-aligned (``extract_and_compact`` runs
  both on ternary + label images, as the full-resolution path does),
- ``cluster_candidates_batched`` sorts by a 26-bit hash of the label pair,
  segments the sorted runs (kernel B2, ``ops/segment_stats.py``), ranks
  the runs by direction diversity and gathers fixed-size point windows.

Every ranking keeps the JAX package's tie order: ``lax.top_k`` puts the
lower index first, which is a stable descending sort's order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from chalkydri_tpu_torch.detector.segment import neighbor
from chalkydri_tpu_torch.ops.segment_stats import segment_stats

MAX_EDGE_POINTS = 1 << 16  # per frame, after sorting/compaction
MAX_CLUSTERS = 64  # candidate quads per frame
MAX_CLUSTER_POINTS = 128  # boundary points kept per cluster
MIN_CLUSTER_POINTS = 24  # smaller clusters can't be a tag border
MIN_SAME_NEIGHBORS = 2  # speckle gate
COMPACT_SLACK = 2  # blocks kept: COMPACT_SLACK * max_points / 128
BOOST_DILATE = 2  # rows/cols of both-direction adjacency tolerance
BOOST_SCORE = 256  # > max per-block count (128)
HASH_BITS = 26
_HASH_MASK = (1 << HASH_BITS) - 1  # doubles as the per-frame sentinel
_PAYLOAD_BITS = 29  # payloads are below 2^29 (x2, y2, dir, side)

_INT_MAX = 2 ** 31 - 1

# Edge directions (dy, dx): right and down pairs.
_DIRS = ((0, 1), (1, 0))


class Clusters(NamedTuple):
    points: torch.Tensor  # [B, 4, K, P] float32 (x, y, gx, gy)
    mask: torch.Tensor  # [B, K, P] bool
    count: torch.Tensor  # [B, K] int32 (true population, may exceed P)
    valid: torch.Tensor  # [B, K] bool (count >= MIN_CLUSTER_POINTS)
    dropped: torch.Tensor  # [B] int32, candidates lost to compaction


def top_indices(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries along the last dim, the lower
    index first on ties (``lax.top_k``'s order)."""
    return torch.sort(score, dim=-1, descending=True, stable=True).indices[..., :k]


def _same_neighbor_count(tern: torch.Tensor) -> torch.Tensor:
    """How many of each pixel's 8 neighbors share its value (127 outside
    the frame)."""
    count = torch.zeros(tern.shape, dtype=torch.int32, device=tern.device)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                count += (neighbor(tern, dy, dx, 127) == tern).to(torch.int32)
    return count


def unpack_payload(p: torch.Tensor):
    return p & 0x1FFF, (p >> 13) & 0x1FFF, (p >> 26) & 0x3, (p >> 28) & 0x1


def extract_boundary_points(tern: torch.Tensor, labels: torch.Tensor,
                            halo_top: int = 0, halo_bottom: int = 0,
                            y_offset: int = 0):
    """Dense boundary candidates of [B, H, W] ternary + label images.

    Returns (black_lab, white_lab, payload), each [B, 2*H*W] int32 in
    direction-major order; non-edges carry ``black == white == INT_MAX``.
    An edge is a black/white neighbor pair whose pixels both have at least
    ``MIN_SAME_NEIGHBORS`` same-valued 8-neighbors (the speckle gate).

    For a row band of a frame, ``tern``/``labels`` are the band's core
    rows extended with ``halo_top`` rows of the band above and
    ``halo_bottom`` rows of the band below (the gate reaches one row, and
    a down-edge of the last core row needs the gate of the row below, two
    rows down in all). Only core pixels emit candidates, and ``y_offset``,
    the frame row of the first core row, goes into the payload, so the
    core rows' slots equal a whole-frame run's.
    """
    b, h, w = tern.shape
    dev = tern.device
    rows = torch.arange(h, dtype=torch.int32, device=dev)[:, None]
    core = (rows >= halo_top) & (rows < h - halo_bottom)  # [h, 1]
    ys_frame = (rows - halo_top + y_offset).expand(h, w)
    xs = torch.arange(w, dtype=torch.int32, device=dev)[None, :].expand(h, w)
    val = tern.to(torch.int32)
    labels = labels.to(torch.int32)
    solid = _same_neighbor_count(tern) >= MIN_SAME_NEIGHBORS
    p_white = tern == 255
    blacks, whites, payloads = [], [], []
    for di, (dy, dx) in enumerate(_DIRS):
        nv = neighbor(val, dy, dx, 127)
        nl = neighbor(labels, dy, dx, 0)
        nsolid = neighbor(solid, dy, dx, False)
        is_edge = (val + nv == 255) & solid & nsolid & core
        black = torch.where(is_edge, torch.where(p_white, nl, labels), _INT_MAX)
        white = torch.where(is_edge, torch.where(p_white, labels, nl), _INT_MAX)
        payload = (((2 * xs + dx) & 0x1FFF)
                   | (((2 * ys_frame + dy) & 0x1FFF) << 13)
                   | (di << 26) | (p_white.to(torch.int32) << 28))
        blacks.append(black.reshape(b, -1))
        whites.append(white.reshape(b, -1))
        payloads.append(payload.expand(b, h, w).reshape(b, -1))
    return (torch.cat(blacks, 1).to(torch.int32),
            torch.cat(whites, 1).to(torch.int32),
            torch.cat(payloads, 1).to(torch.int32))


def _dilate_vec(v: torch.Tensor, d: int = BOOST_DILATE) -> torch.Tensor:
    """OR a bool [..., n] vector with its +-d shifts (edge fill False)."""
    out = v
    for k in range(1, d + 1):
        out = out | F.pad(v[..., k:], (0, k)) | F.pad(v[..., :-k], (k, 0))
    return out


def direction_boosts(has0: torch.Tensor, has1: torch.Tensor):
    """(both_col [..., W], both_row [..., H]): the column/row is within
    BOOST_DILATE of candidates in both directions (tag borders are;
    straight texture stripes are not)."""
    row0, row1 = has0.any(dim=-1), has1.any(dim=-1)
    col0, col1 = has0.any(dim=-2), has1.any(dim=-2)
    both_row = _dilate_vec(row0) & _dilate_vec(row1)
    both_col = _dilate_vec(col0) & _dilate_vec(col1)
    return both_col, both_row


def rank_blocks(counts: torch.Tensor, boost: torch.Tensor, cap: int):
    """Top (cap/128/n_dirs) block indices of one direction by count +
    boost (the boost only for occupied blocks), lower index first on ties."""
    k = max(1, min(cap // 128 // len(_DIRS), counts.shape[-1]))
    score = counts + torch.where(boost & (counts > 0), BOOST_SCORE, 0)
    return top_indices(score, k)


def _ceil128(n: int) -> int:
    return -(-n // 128) * 128


def _compact_blocks(black, white, payload, cap: int, width: int):
    """Block-sparse compaction of [B, 2*H*W] candidates: keep the top-ranked
    128-candidate blocks per direction. Dir 0 (right pairs, on vertical
    edges) blocks the transposed page [W, ceil128(H)], dir 1 the row-major
    page [H, ceil128(W)]; pad slots carry INT_MAX labels and payload 0.
    Returns (black, white, payload, dropped [B])."""
    b, n = black.shape
    seg = n // len(_DIRS)
    w = width
    h = seg // w
    if h * w != seg:
        raise ValueError("candidate segment must factor as height x width")
    hp, wp = _ceil128(h), _ceil128(w)

    def pages(x, fill):
        p0 = x[:, :seg].reshape(b, h, w).transpose(1, 2)
        p1 = x[:, seg:].reshape(b, h, w)
        p0 = F.pad(p0, (0, hp - h), value=fill)
        p1 = F.pad(p1, (0, wp - w), value=fill)
        return p0.reshape(b, -1, 128), p1.reshape(b, -1, 128)

    b0, b1 = pages(black, _INT_MAX)
    w0, w1 = pages(white, _INT_MAX)
    p0, p1 = pages(payload, 0)

    has0 = black[:, :seg].reshape(b, h, w) != _INT_MAX
    has1 = black[:, seg:].reshape(b, h, w) != _INT_MAX
    both_col, both_row = direction_boosts(has0, has1)
    boost0 = both_col[:, :, None].expand(b, w, hp // 128).reshape(b, -1)
    boost1 = both_row[:, :, None].expand(b, h, wp // 128).reshape(b, -1)

    counts0 = (b0 != _INT_MAX).sum(dim=2)
    counts1 = (b1 != _INT_MAX).sum(dim=2)
    idx0 = rank_blocks(counts0, boost0, cap)
    idx1 = rank_blocks(counts1, boost1, cap)
    dropped = (counts0.sum(1) + counts1.sum(1)
               - counts0.gather(1, idx0).sum(1) - counts1.gather(1, idx1).sum(1))

    def keep(x0, x1):
        r0 = x0.gather(1, idx0[:, :, None].expand(-1, -1, 128))
        r1 = x1.gather(1, idx1[:, :, None].expand(-1, -1, 128))
        return torch.cat([r0, r1], dim=1).reshape(b, -1)

    return keep(b0, b1), keep(w0, w1), keep(p0, p1), dropped.to(torch.int32)


def compact_candidates(black, white, payload, width: int,
                       max_points: int = MAX_EDGE_POINTS):
    """Block-sparse compaction of dense [B, n] candidates (untouched when n
    is within ``max_points``): ``(black, white, payload, dropped [B])``."""
    if black.shape[1] > max_points:
        return _compact_blocks(black, white, payload,
                               int(COMPACT_SLACK * max_points), width)
    dropped = torch.zeros(black.shape[0], dtype=torch.int32, device=black.device)
    return black, white, payload, dropped


def extract_and_compact(tern: torch.Tensor, labels: torch.Tensor,
                        max_points: int = MAX_EDGE_POINTS):
    """Boundary extraction + block-sparse compaction of [B, H, W] ternary
    + label images: ``(black, white, payload, dropped [B])``."""
    black, white, payload = extract_boundary_points(tern, labels)
    return compact_candidates(black, white, payload, tern.shape[2],
                              max_points=max_points)


def pair_hash(black: torch.Tensor, white: torch.Tensor) -> torch.Tensor:
    """The 26-bit (black, white) pair hash as int64: the low 26 bits of the
    int32 wrapping multiply-xor, exact in int64 because the low bits of a
    product are the same at any width. ``_HASH_MASK`` is reserved for
    invalid candidates, so a valid pair hashing to it moves down one."""
    b64, w64 = black.to(torch.int64), white.to(torch.int64)
    key = ((b64 * -1640531527) ^ (w64 * -2048144789)) & _HASH_MASK
    key = torch.where(key == _HASH_MASK, _HASH_MASK - 1, key)
    return torch.where(black == _INT_MAX, _HASH_MASK, key)


def sort_candidates(black, white, payload, max_points: int = MAX_EDGE_POINTS):
    """Canonical per-frame sort of [B, n] candidates, lexicographic on
    (pair hash, payload): one sort of the int64 ``hash << 29 | payload``
    per row (payloads are below 2^29), the order of the JAX package's
    two-key frame-fused sort. Invalid candidates carry the sentinel hash
    and sink to each frame's tail; the head ``max_points`` rows keep every
    valid candidate whenever that many or fewer exist. Returns (s_key,
    s_payload), int32 [B, min(n, max_points)], s_key INT_MAX if invalid."""
    combined = (pair_hash(black, white) << _PAYLOAD_BITS) | payload.to(torch.int64)
    s = torch.sort(combined, dim=1).values[:, :max_points]
    s_key = (s >> _PAYLOAD_BITS).to(torch.int32)
    s_key = torch.where(s_key == _HASH_MASK, _INT_MAX, s_key)
    return s_key, (s & ((1 << _PAYLOAD_BITS) - 1)).to(torch.int32)


def cluster_candidates_batched(
    black: torch.Tensor,
    white: torch.Tensor,
    payload: torch.Tensor,
    max_points: int = MAX_EDGE_POINTS,
    max_clusters: int = MAX_CLUSTERS,
    cluster_points: int = MAX_CLUSTER_POINTS,
    min_points: int = MIN_CLUSTER_POINTS,
    dropped: torch.Tensor | None = None,
) -> Clusters:
    """Group [B, n] boundary candidates into clusters: canonical sort,
    run-length segmentation, direction-diversity rank, top-K runs, strided
    point windows."""
    b = black.shape[0]
    s_key, s_payload = sort_candidates(black, white, payload, max_points)
    n = s_key.shape[1]

    # Run-length segmentation + per-128-chunk top-2 runs (kernel B2).
    t, cand_len, cand_pos = segment_stats(s_key, s_payload)

    # Rank the chunk winners by direction diversity, then length.
    p0 = torch.clamp(cand_pos, 0, n - 1).to(torch.int64)
    p1 = torch.clamp(cand_pos + cand_len - 1, 0, n - 1).to(torch.int64)
    pay_p0 = s_payload.gather(1, p0)
    key_p0 = s_key.gather(1, p0)
    d0_p0 = ((((pay_p0 >> 26) & 0x3) == 0) & (key_p0 != _INT_MAX)).to(torch.int32)
    d0_run = t.gather(1, p1) - t.gather(1, p0) + d0_p0
    min_dir = torch.minimum(d0_run, cand_len - d0_run)
    rank = torch.where(
        cand_len > 0,
        torch.clamp(min_dir, 0, (1 << 14) - 1) * (1 << 15)
        + torch.clamp(cand_len, 0, (1 << 15) - 1),
        0,
    )
    if max_clusters > rank.shape[1]:  # lax.top_k refuses this in JAX
        raise ValueError(f"max_clusters={max_clusters} exceeds the "
                         f"{rank.shape[1]} chunk winners of {n} sorted rows")
    top_sel = top_indices(rank, max_clusters)  # [B, K]
    top_rank = rank.gather(1, top_sel)
    top_start = cand_pos.gather(1, top_sel)
    top_count = torch.where(top_rank > 0, cand_len.gather(1, top_sel), 0)

    # Fixed-size point windows; larger runs are stride-subsampled over
    # their whole extent.
    offs = torch.arange(cluster_points, dtype=torch.int32,
                        device=black.device)[None, None, :]
    cnt = top_count[:, :, None]
    strided = top_start[:, :, None] + (offs * cnt) // cluster_points
    direct = top_start[:, :, None] + offs
    widx = torch.where(cnt > cluster_points, strided, direct)  # [B, K, P]
    idx_c = torch.clamp(widx, 0, n - 1).to(torch.int64)
    in_seg = (offs < cnt) & (widx < n)

    k = top_sel.shape[1]
    pay = s_payload.gather(1, idx_c.reshape(b, -1)).reshape(b, k, cluster_points)
    x2, y2, dir_idx, side = unpack_payload(pay)
    dx = (dir_idx == 0).to(torch.int32)
    dy = 1 - dx
    sign = torch.where(side == 1, -1, 1)  # gradient black -> white
    points = torch.stack([x2.float() * 0.5, y2.float() * 0.5,
                          (sign * dx).float(), (sign * dy).float()], dim=1)
    points = torch.where(in_seg[:, None], points, 0.0)

    if dropped is None:
        dropped = torch.zeros(b, dtype=torch.int32, device=black.device)
    return Clusters(points=points, mask=in_seg, count=top_count.to(torch.int32),
                    valid=top_count >= min_points,
                    dropped=dropped.to(torch.int32))


def cluster_candidates(
    black: torch.Tensor,
    white: torch.Tensor,
    payload: torch.Tensor,
    max_points: int = MAX_EDGE_POINTS,
    max_clusters: int = MAX_CLUSTERS,
    cluster_points: int = MAX_CLUSTER_POINTS,
    min_points: int = MIN_CLUSTER_POINTS,
    dropped=None,
) -> Clusters:
    """One frame's [n] candidates: ``cluster_candidates_batched`` on a
    batch of one (kernel B2 on a CUDA tensor), its outputs indexed [0]."""
    out = cluster_candidates_batched(
        black[None], white[None], payload[None], max_points=max_points,
        max_clusters=max_clusters, cluster_points=cluster_points,
        min_points=min_points,
        dropped=None if dropped is None
        else torch.as_tensor(dropped, device=black.device)[None])
    return Clusters(*(x[0] for x in out))


def gradient_clusters_batched(
    tern: torch.Tensor,
    labels: torch.Tensor,
    max_points: int = MAX_EDGE_POINTS,
    max_clusters: int = MAX_CLUSTERS,
    cluster_points: int = MAX_CLUSTER_POINTS,
    min_points: int = MIN_CLUSTER_POINTS,
) -> Clusters:
    """Clusters of [B, H, W] ternary + label images: extraction and
    compaction, then ``cluster_candidates_batched``."""
    black, white, payload, dropped = extract_and_compact(tern, labels,
                                                         max_points)
    return cluster_candidates_batched(
        black, white, payload, max_points=max_points,
        max_clusters=max_clusters, cluster_points=cluster_points,
        min_points=min_points, dropped=dropped)


def gradient_clusters(
    tern: torch.Tensor,
    labels: torch.Tensor,
    max_points: int = MAX_EDGE_POINTS,
    max_clusters: int = MAX_CLUSTERS,
    cluster_points: int = MAX_CLUSTER_POINTS,
    min_points: int = MIN_CLUSTER_POINTS,
) -> Clusters:
    """Clusters of ONE [H, W] frame: ``gradient_clusters_batched`` on a
    batch of one, indexed [0]."""
    out = gradient_clusters_batched(
        tern[None], labels[None], max_points=max_points,
        max_clusters=max_clusters, cluster_points=cluster_points,
        min_points=min_points)
    return Clusters(*(x[0] for x in out))
