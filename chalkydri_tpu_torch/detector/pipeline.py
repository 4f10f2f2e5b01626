"""The batched AprilTag detector: frames in, detections out (port of
``chalkydri_tpu/detector/pipeline.py``).

One call runs decimate -> threshold + CCL + extraction (kernel B1) ->
block compaction -> clustering (kernel B2) -> quad fit -> refine ->
decode -> margin rank and per-id dedup for a whole batch of frames.
Output is fixed-shape: MAX_DETECTIONS slots per frame, sorted by decision
margin.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from chalkydri_tpu_torch.detector.cluster import (
    MAX_CLUSTER_POINTS,
    MAX_CLUSTERS,
    MAX_EDGE_POINTS,
    cluster_candidates_batched,
    compact_candidates,
    top_indices,
)
from chalkydri_tpu_torch.detector.decode import Decoder
from chalkydri_tpu_torch.detector.families import (
    DEFAULT_BITS_CORRECTED,
    DEFAULT_FAMILY,
    TagFamily,
    load_family,
)
from chalkydri_tpu_torch.detector.quad import fit_quads
from chalkydri_tpu_torch.detector.refine import refine_quads
from chalkydri_tpu_torch.ops.ccl_extract import threshold_ccl_extract
from chalkydri_tpu_torch.utils.precision import full_fp32

MAX_DETECTIONS = 16


class Detections(NamedTuple):
    """Fixed-capacity detections per frame."""

    ids: torch.Tensor  # [B, MAX_DETECTIONS] int32, -1 for empty slots
    corners: torch.Tensor  # [B, MAX_DETECTIONS, 4, 2] float32
    decision_margins: torch.Tensor  # [B, MAX_DETECTIONS] float32
    hammings: torch.Tensor  # [B, MAX_DETECTIONS] int32
    valid: torch.Tensor  # [B, MAX_DETECTIONS] bool
    dropped_points: torch.Tensor  # [B] int32, candidates lost to compaction


def make_post_cluster(decode, refine: bool = True,
                      max_detections: int = MAX_DETECTIONS,
                      max_quad_candidates: int = 32):
    """``finish(gray [B, H, W], clusters) -> Detections``: quad fit -> keep
    the best ``max_quad_candidates`` quads -> refine -> decode -> rank by
    decision margin -> per-id dedup -> compaction to ``max_detections``."""

    def finish(gray, clusters):
        quads = fit_quads(clusters.points, clusters.mask, clusters.valid)
        kq = min(max_quad_candidates, quads.valid.shape[1])
        score = torch.where(quads.valid, clusters.count, -1)
        sel = top_indices(score, kq)  # [B, kq]
        corners = quads.corners.gather(
            1, sel[..., None, None].expand(*sel.shape, 4, 2))
        q_valid = quads.valid.gather(1, sel)
        # decimated pixel c sits at full-resolution coordinate 2c + 0.5
        corners = corners * 2.0 + 0.5
        if refine:
            corners = refine_quads(gray, corners, q_valid)
        dec = decode(gray, corners, q_valid)

        margin = torch.where(dec.valid, dec.decision_margin, -1.0)
        order = torch.argsort(-margin, dim=1, stable=True)  # best first

        def by_order(x):
            idx = order.reshape(*order.shape, *([1] * (x.dim() - 2)))
            return x.gather(1, idx.expand_as(x))

        ids_s, margins_s = by_order(dec.tag_id), by_order(margin)
        corners_s, ham_s = by_order(dec.corners), by_order(dec.hamming)
        valid_s = by_order(dec.valid)

        # keep a detection only if no better slot has the same id
        k = ids_s.shape[1]
        same = ids_s[:, None, :] == ids_s[:, :, None]  # [B, k, k]
        earlier = torch.tril(torch.ones(k, k, dtype=torch.bool,
                                        device=ids_s.device), diagonal=-1)
        dup = (same & earlier & valid_s[:, None, :]).any(dim=2)
        keep = valid_s & ~dup

        pos = torch.cumsum(keep.to(torch.int32), dim=1) - 1
        slot = torch.where(keep & (pos < max_detections), pos, max_detections)

        def compact(v, fill):
            b = v.shape[0]
            buf = torch.full((b, max_detections + 1, *v.shape[2:]), fill,
                             dtype=v.dtype, device=v.device)
            idx = slot.reshape(*slot.shape, *([1] * (v.dim() - 2)))
            buf.scatter_(1, idx.expand_as(v), v)
            return buf[:, :max_detections]

        return Detections(
            ids=compact(ids_s, -1),
            corners=compact(corners_s, 0.0),
            decision_margins=compact(margins_s, 0.0),
            hammings=compact(ham_s, 0),
            valid=compact(keep, False),
            dropped_points=clusters.dropped,
        )

    return finish


def decimate2(gray: torch.Tensor) -> torch.Tensor:
    """2x2 mean (floor) of [B, H, W] uint8 frames cropped to multiples of 8."""
    b = gray.shape[0]
    h2 = (gray.shape[1] // 8) * 8
    w2 = (gray.shape[2] // 8) * 8
    g = gray[:, :h2, :w2].to(torch.int32).reshape(b, h2 // 2, 2, w2 // 2, 2)
    return (g.sum(dim=(2, 4)) // 4).to(torch.uint8)


class Detector(nn.Module):
    """``detector(gray_batch [B, H, W] uint8) -> Detections``. Quad search
    runs at half resolution (``quad_decimate=2``); refine and decode
    sample the full-resolution frames. The family tables live in the
    ``decode`` submodule's buffers."""

    def __init__(self, family: str | TagFamily = DEFAULT_FAMILY,
                 bits_corrected: int = DEFAULT_BITS_CORRECTED,
                 max_detections: int = MAX_DETECTIONS, ccl_iters: int = 12,
                 refine: bool = True, max_edge_points: int | None = None,
                 max_clusters: int = MAX_CLUSTERS,
                 cluster_points: int = MAX_CLUSTER_POINTS,
                 max_quad_candidates: int = 32):
        super().__init__()
        fam = load_family(family) if isinstance(family, str) else family
        self.decode = Decoder(fam, bits_corrected=bits_corrected)
        self.ccl_iters = ccl_iters
        self.edge_cap = (MAX_EDGE_POINTS if max_edge_points is None
                         else max_edge_points)
        self.max_clusters = max_clusters
        self.cluster_points = cluster_points
        self.finish = make_post_cluster(
            self.decode, refine=refine, max_detections=max_detections,
            max_quad_candidates=max_quad_candidates)

    @torch.no_grad()
    def forward(self, gray_batch: torch.Tensor) -> Detections:
        small = decimate2(gray_batch)
        black, white, payload = threshold_ccl_extract(small, iters=self.ccl_iters)
        black, white, payload, dropped = compact_candidates(
            black, white, payload, width=small.shape[2],
            max_points=self.edge_cap)
        clusters = cluster_candidates_batched(
            black, white, payload, max_points=self.edge_cap,
            max_clusters=self.max_clusters, cluster_points=self.cluster_points,
            dropped=dropped)
        return self.finish(gray_batch, clusters)


def make_detector(
    family: str | TagFamily = DEFAULT_FAMILY,
    bits_corrected: int = DEFAULT_BITS_CORRECTED,
    max_detections: int = MAX_DETECTIONS,
    ccl_iters: int = 12,
    refine: bool = True,
    quad_decimate: int = 2,
    max_edge_points: int | None = None,
    max_clusters: int = MAX_CLUSTERS,
    cluster_points: int = MAX_CLUSTER_POINTS,
    max_quad_candidates: int = 32,
    device: str | torch.device = "cpu",
) -> Detector:
    """Build the ``Detector`` on ``device``. ``quad_decimate=2`` is the only
    setting this version supports."""
    if quad_decimate != 2:
        raise ValueError("only quad_decimate=2 is supported")
    full_fp32()
    return Detector(
        family=family, bits_corrected=bits_corrected,
        max_detections=max_detections, ccl_iters=ccl_iters, refine=refine,
        max_edge_points=max_edge_points, max_clusters=max_clusters,
        cluster_points=cluster_points,
        max_quad_candidates=max_quad_candidates).to(device)
