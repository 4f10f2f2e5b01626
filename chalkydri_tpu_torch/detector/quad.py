"""Stage 4: quad fitting, one candidate quad per boundary cluster (port of
``chalkydri_tpu/detector/quad.py``).

A fixed-iteration EM-style fit vectorized over frames, clusters and
edges: init corners at the extreme points along the four diagonals, then
``fit_iters`` times assign every point to its nearest edge, refit the four
lines by weighted PCA and intersect neighbors. Corners come out CCW in
image coordinates (y down) from the upright tag's bottom-left; a quad is
valid when every edge has enough points, a minimum length and a bounded
residual, and the quad is convex and finite.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from chalkydri_tpu_torch.detector.cluster import top_indices

FIT_ITERS = 4
MIN_EDGE_POINTS = 5
MIN_EDGE_LEN = 6.0  # pixels
MAX_LINE_RMS = 1.2  # pixels


class Quads(NamedTuple):
    corners: torch.Tensor  # [..., K, 4, 2] float32, CCW (y down)
    valid: torch.Tensor  # [..., K] bool


def line_fits(px: torch.Tensor, py: torch.Tensor, w: torch.Tensor):
    """Weighted PCA line fits. px, py [..., P]; w [..., E, P] per-line
    weights. Returns (cx, cy, nx, ny, rms), each [..., E], point-normal."""
    wsum = torch.clamp(w.sum(dim=-1), min=1e-6)
    cx = (w * px[..., None, :]).sum(dim=-1) / wsum
    cy = (w * py[..., None, :]).sum(dim=-1) / wsum
    dx = px[..., None, :] - cx[..., None]
    dy = py[..., None, :] - cy[..., None]
    sxx = (w * dx * dx).sum(dim=-1) / wsum
    syy = (w * dy * dy).sum(dim=-1) / wsum
    sxy = (w * dx * dy).sum(dim=-1) / wsum
    tr = sxx + syy
    det = sxx * syy - sxy * sxy
    disc = torch.sqrt(torch.clamp(tr * tr / 4.0 - det, min=0.0))
    lam_small = tr / 2.0 - disc
    n1x, n1y = sxy, lam_small - sxx
    n2x, n2y = lam_small - syy, sxy
    use1 = n1x * n1x + n1y * n1y > n2x * n2x + n2y * n2y
    nx = torch.where(use1, n1x, n2x)
    ny = torch.where(use1, n1y, n2y)
    norm = torch.sqrt(torch.clamp(nx * nx + ny * ny, min=1e-12))
    rms = torch.sqrt(torch.clamp(lam_small, min=0.0))
    return cx, cy, nx / norm, ny / norm, rms


def intersect(c1x, c1y, n1x, n1y, c2x, c2y, n2x, n2y):
    """Intersections of point-normal line pairs."""
    det = n1x * n2y - n1y * n2x
    safe = torch.where(torch.abs(det) < 1e-9, torch.full_like(det, 1e-9), det)
    b1 = n1x * c1x + n1y * c1y
    b2 = n2x * c2x + n2y * c2y
    return (b1 * n2y - b2 * n1y) / safe, (n1x * b2 - n2x * b1) / safe


def corners_from_lines(cx, cy, nx, ny) -> torch.Tensor:
    """Corner e = intersection of line e-1 and line e; lines [..., 4]."""
    def prev(v):
        return torch.roll(v, 1, dims=-1)

    x, y = intersect(prev(cx), prev(cy), prev(nx), prev(ny), cx, cy, nx, ny)
    return torch.stack([x, y], dim=-1)


def fit_quad(points: torch.Tensor, mask: torch.Tensor,
             fit_iters: int = FIT_ITERS) -> tuple[torch.Tensor, torch.Tensor]:
    """Fit one quad to one cluster (points [4, P] channel-first, mask [P]):
    ``fit_quads`` on one cluster. Returns (corners [4, 2], valid)."""
    q = fit_quads(points[:, None], mask[None],
                  torch.ones(1, dtype=torch.bool, device=mask.device),
                  fit_iters)
    return q.corners[0], q.valid[0]


def fit_quads(points: torch.Tensor, mask: torch.Tensor,
              cluster_valid: torch.Tensor, fit_iters: int = FIT_ITERS) -> Quads:
    """points [..., 4, K, P] channel-first (x, y, gx, gy), mask [..., K, P],
    cluster_valid [..., K] -> Quads."""
    px = points[..., 0, :, :]  # [..., K, P]
    py = points[..., 1, :, :]
    w = mask.to(torch.float32)
    wsum = torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-6)
    ccx = (px * w).sum(dim=-1, keepdim=True) / wsum
    ccy = (py * w).sum(dim=-1, keepdim=True) / wsum

    rx, ry = px - ccx, py - ccy
    scores = torch.stack([rx + ry, rx - ry, -rx - ry, -rx + ry], dim=-2)
    scores = torch.where(mask[..., None, :], scores, -1e9)  # [..., K, 4, P]
    # argmax with the first index on ties, written out
    pos = torch.arange(px.shape[-1], device=px.device)
    best = scores.amax(dim=-1, keepdim=True)
    arg = torch.where(scores == best, pos, px.shape[-1]).amin(dim=-1)  # [..., K, 4]
    corners = torch.stack([px.gather(-1, arg), py.gather(-1, arg)], dim=-1)

    counts = torch.zeros(corners.shape[:-1], device=px.device)
    rmss = torch.zeros(corners.shape[:-1], device=px.device)
    pxe, pye = px[..., None, :], py[..., None, :]  # [..., K, 1, P]
    for _ in range(fit_iters):
        c0 = corners  # edge e runs corner e -> corner e+1
        c1 = torch.roll(corners, -1, dims=-2)
        ex = c1[..., 0] - c0[..., 0]  # [..., K, 4]
        ey = c1[..., 1] - c0[..., 1]
        el2 = torch.clamp(ex * ex + ey * ey, min=1e-12)
        rx = pxe - c0[..., 0:1]  # [..., K, 4, P]
        ry = pye - c0[..., 1:2]
        t = torch.clamp((rx * ex[..., None] + ry * ey[..., None])
                        / el2[..., None], 0.0, 1.0)
        qx = c0[..., 0:1] + t * ex[..., None]
        qy = c0[..., 1:2] + t * ey[..., None]
        d2 = (pxe - qx) ** 2 + (pye - qy) ** 2
        edge = torch.arange(4, device=px.device)[:, None]
        dmin = d2.amin(dim=-2, keepdim=True)
        assign = torch.where(d2 == dmin, edge, 4).amin(dim=-2, keepdim=True)
        we = (assign == edge).to(torch.float32) * w[..., None, :]
        counts = we.sum(dim=-1)
        fcx, fcy, fnx, fny, rmss = line_fits(px, py, we)
        corners = corners_from_lines(fcx, fcy, fnx, fny)

    # orientation: CCW in image coords (negative shoelace)
    c_next = torch.roll(corners, -1, dims=-2)
    area2 = (corners[..., 0] * c_next[..., 1]
             - c_next[..., 0] * corners[..., 1]).sum(dim=-1)
    corners = torch.where((area2 > 0)[..., None, None],
                          corners.flip(-2), corners)

    c_next = torch.roll(corners, -1, dims=-2)
    d = c_next - corners
    elen = torch.sqrt((d * d).sum(dim=-1))
    c_next2 = torch.roll(c_next, -1, dims=-2)
    cross = (d[..., 0] * (c_next2[..., 1] - c_next[..., 1])
             - d[..., 1] * (c_next2[..., 0] - c_next[..., 0]))
    convex = (cross < 0).all(dim=-1) | (cross > 0).all(dim=-1)
    finite = torch.isfinite(corners).all(dim=-1).all(dim=-1)
    valid = (finite & convex
             & (counts >= MIN_EDGE_POINTS).all(dim=-1)
             & (elen >= MIN_EDGE_LEN).all(dim=-1)
             & (rmss <= MAX_LINE_RMS).all(dim=-1))
    return Quads(corners=corners, valid=valid & cluster_valid)


def fit_select_plain(points: torch.Tensor, mask: torch.Tensor,
                     cluster_valid: torch.Tensor, count: torch.Tensor,
                     kq: int, quad_decimate: int):
    """The quad stage in plain PyTorch (kernel T1's twin, ``ops/tail.py``):
    ``fit_quads``, then the ``kq`` best quads by cluster size
    (``top_indices``, the lower index first on ties), back to
    full-resolution coordinates at ``quad_decimate=2``. Returns (``Quads``
    of every cluster, corners [B, kq, 4, 2], valid [B, kq])."""
    quads = fit_quads(points, mask, cluster_valid)
    kq = min(kq, quads.valid.shape[1])
    score = torch.where(quads.valid, count, -1)
    sel = top_indices(score, kq)  # [B, kq]
    corners = quads.corners.gather(
        1, sel[..., None, None].expand(*sel.shape, 4, 2))
    q_valid = quads.valid.gather(1, sel)
    if quad_decimate == 2:
        # decimated pixel c sits at full-resolution coordinate 2c + 0.5
        corners = corners * 2.0 + 0.5
    return quads, corners, q_valid
