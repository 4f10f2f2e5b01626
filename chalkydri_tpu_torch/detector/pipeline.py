"""The batched AprilTag detector: frames in, detections out (port of
``chalkydri_tpu/detector/pipeline.py``).

One call runs decimate (``quad_decimate=2``) -> threshold + CCL +
extraction -> block compaction -> clustering (kernel B2) -> quad fit ->
refine -> decode -> margin rank and per-id dedup for a whole batch of
frames. Threshold + CCL + extraction go by the quad-search frame's pixel
count, as the JAX package's dispatch does:

- at most ``EXTRACT_BLOCK_MAX_PIXELS``: the fused kernel B1;
- at most ``SINGLE_BLOCK_MAX_PIXELS``: kernel B3 (threshold + ``ccl_iters``
  CCL rounds, through B4), then ``extract_and_compact``;
- larger: kernel B5 (threshold + CCL to the global fixed point, padded-flat
  labels), then ``extract_and_compact``.

The two constants are the JAX package's TPU budgets, kept here as
semantics: B3 and B5 label differently, and label values feed the cluster
hash. Output is fixed-shape: MAX_DETECTIONS slots per frame, sorted by
decision margin.
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
    extract_and_compact,
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
from chalkydri_tpu_torch.ops.threshold_ccl import (
    threshold_ccl,
    threshold_ccl_exact,
)
from chalkydri_tpu_torch.utils.precision import full_fp32

MAX_DETECTIONS = 16
EXTRACT_BLOCK_MAX_PIXELS = 540_000  # B1 up to here
SINGLE_BLOCK_MAX_PIXELS = 1_030_000  # B3 up to here, B5 beyond


class Detections(NamedTuple):
    """Fixed-capacity detections per frame."""

    ids: torch.Tensor  # [B, MAX_DETECTIONS] int32, -1 for empty slots
    corners: torch.Tensor  # [B, MAX_DETECTIONS, 4, 2] float32
    decision_margins: torch.Tensor  # [B, MAX_DETECTIONS] float32
    hammings: torch.Tensor  # [B, MAX_DETECTIONS] int32
    valid: torch.Tensor  # [B, MAX_DETECTIONS] bool
    dropped_points: torch.Tensor  # [B] int32, candidates lost to compaction

    def count(self) -> torch.Tensor:  # shadows tuple.count on purpose
        """Valid detections per frame, [B]."""
        return self.valid.sum(-1)

    def filtered_by_decision_margin(self, threshold: float):
        """Yield (frame, id, corners [4, 2], margin) for each valid
        detection whose decision margin is above ``threshold``, frame by
        frame and slot by slot. Pulls the fields to the host once."""
        ids, corners, margins, valid = (
            x.cpu().numpy() for x in (self.ids, self.corners,
                                      self.decision_margins, self.valid))
        for b in range(ids.shape[0]):
            for i in range(ids.shape[1]):
                if valid[b, i] and margins[b, i] > threshold:
                    yield b, int(ids[b, i]), corners[b, i], float(margins[b, i])


def make_post_cluster(decode, refine: bool = True, quad_decimate: int = 2,
                      max_detections: int = MAX_DETECTIONS,
                      max_quad_candidates: int = 32):
    """``finish(gray [B, H, W], clusters) -> Detections``: quad fit -> keep
    the best ``max_quad_candidates`` quads -> back to full-resolution
    coordinates (``quad_decimate=2``) -> refine -> decode -> rank by
    decision margin -> per-id dedup -> compaction to ``max_detections``."""

    def finish(gray, clusters):
        quads = fit_quads(clusters.points, clusters.mask, clusters.valid)
        kq = min(max_quad_candidates, quads.valid.shape[1])
        score = torch.where(quads.valid, clusters.count, -1)
        sel = top_indices(score, kq)  # [B, kq]
        corners = quads.corners.gather(
            1, sel[..., None, None].expand(*sel.shape, 4, 2))
        q_valid = quads.valid.gather(1, sel)
        if quad_decimate == 2:
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
    runs at half resolution (``quad_decimate=2``) or at full resolution
    (``quad_decimate=1``, no crop: H and W must be multiples of 4); refine
    and decode sample the full-resolution frames. The family tables live
    in the ``decode`` submodule's buffers.

    ``capacity_fallback``: when a frame of the batch drops candidates to
    the compaction budget (``dropped_points > 0``, one host read per call),
    the batch runs again on a detector with twice ``max_edge_points``,
    built on the first such call (``self.wide``). Clean frames never build
    it and return the standard detections."""

    def __init__(self, family: str | TagFamily = DEFAULT_FAMILY,
                 bits_corrected: int = DEFAULT_BITS_CORRECTED,
                 max_detections: int = MAX_DETECTIONS, ccl_iters: int = 12,
                 refine: bool = True, quad_decimate: int = 2,
                 max_edge_points: int | None = None,
                 max_clusters: int = MAX_CLUSTERS,
                 cluster_points: int = MAX_CLUSTER_POINTS,
                 max_quad_candidates: int = 32,
                 capacity_fallback: bool = False):
        super().__init__()
        if quad_decimate not in (1, 2):
            raise ValueError("quad_decimate must be 1 or 2")
        fam = load_family(family) if isinstance(family, str) else family
        self.decode = Decoder(fam, bits_corrected=bits_corrected)
        self.ccl_iters = ccl_iters
        self.quad_decimate = quad_decimate
        self.edge_cap = (MAX_EDGE_POINTS if max_edge_points is None
                         else max_edge_points)
        self.max_clusters = max_clusters
        self.cluster_points = cluster_points
        self.finish = make_post_cluster(
            self.decode, refine=refine, quad_decimate=quad_decimate,
            max_detections=max_detections,
            max_quad_candidates=max_quad_candidates)
        self.capacity_fallback = capacity_fallback
        self.wide = None
        self._wide_kwargs = dict(
            family=fam, bits_corrected=bits_corrected,
            max_detections=max_detections, ccl_iters=ccl_iters, refine=refine,
            quad_decimate=quad_decimate, max_edge_points=2 * self.edge_cap,
            max_clusters=max_clusters, cluster_points=cluster_points,
            max_quad_candidates=max_quad_candidates)

    def candidates(self, small: torch.Tensor):
        """Quad-search frames [B, h, w] -> compacted candidates (black,
        white, payload, dropped [B]), by the frame's pixel count."""
        h, w = small.shape[1], small.shape[2]
        if h * w <= EXTRACT_BLOCK_MAX_PIXELS:
            black, white, payload = threshold_ccl_extract(small,
                                                          iters=self.ccl_iters)
            return compact_candidates(black, white, payload, width=w,
                                      max_points=self.edge_cap)
        if h * w <= SINGLE_BLOCK_MAX_PIXELS:
            tern, labels = threshold_ccl(small, iters=self.ccl_iters)
        else:
            tern, labels = threshold_ccl_exact(small)
        return extract_and_compact(tern, labels, max_points=self.edge_cap)

    @torch.no_grad()
    def detect(self, gray_batch: torch.Tensor) -> Detections:
        """One run at this detector's candidate budget."""
        small = (decimate2(gray_batch) if self.quad_decimate == 2
                 else gray_batch.contiguous())
        black, white, payload, dropped = self.candidates(small)
        clusters = cluster_candidates_batched(
            black, white, payload, max_points=self.edge_cap,
            max_clusters=self.max_clusters, cluster_points=self.cluster_points,
            dropped=dropped)
        return self.finish(gray_batch, clusters)

    @torch.no_grad()
    def forward(self, gray_batch: torch.Tensor) -> Detections:
        out = self.detect(gray_batch)
        if self.capacity_fallback and int(out.dropped_points.max()) > 0:
            if self.wide is None:
                device = next(self.decode.buffers()).device
                self.wide = Detector(**self._wide_kwargs).to(device)
            return self.wide.detect(gray_batch)
        return out


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
    capacity_fallback: bool = False,
    device: str | torch.device = "cuda",
) -> Detector:
    """Build the ``Detector`` on ``device`` (the card unless the caller
    asks for the CPU)."""
    full_fp32()
    return Detector(
        family=family, bits_corrected=bits_corrected,
        max_detections=max_detections, ccl_iters=ccl_iters, refine=refine,
        quad_decimate=quad_decimate, max_edge_points=max_edge_points,
        max_clusters=max_clusters, cluster_points=cluster_points,
        max_quad_candidates=max_quad_candidates,
        capacity_fallback=capacity_fallback).to(device)
