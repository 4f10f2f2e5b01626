"""The detector's tail as three CUDA kernels (``csrc/tail.cu``), one
launch a stage:

- T1 ``fit_select``: ``detector/quad.py::fit_quads``, then the top-``kq``
  selection (scaled to full resolution at ``quad_decimate`` 2); its plain
  twin is ``detector/quad.py::fit_select_plain``;
- T2 ``refine_corners``: ``detector/refine.py::refine_quads``, its twin;
- T3 ``decode_rank``: ``detector/decode.py::Decoder.forward``, then
  ``rank_detections`` (rank by decision margin, per-id dedup,
  compaction); its twin is ``detector/decode.py::decode_rank_plain``.

Each wrapper launches its kernel where ``build.on_card`` says so and
returns its twin's result elsewhere, in the same structure. The kernel
route raises ``ValueError`` on a shape, type or device it cannot take.
The kernels replace no TPU kernel (the JAX package's tail is plain
``jnp`` under ``jit``); they repeat the plain chain's arithmetic in its
order, so that on the card the two agree bit for bit at the cells'
shapes ([2, 64, 128] and [4, 64, 128] into T1).
Each launch geometry and shared-memory size below is a pure function of
what the wrapper sees in its inputs. Launches are counted in
``<wrapper>.launches`` (``ops/build.py::count``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from chalkydri_tpu_torch.detector.decode import Decoded, decode_rank_plain
from chalkydri_tpu_torch.detector.quad import Quads, fit_select_plain
from chalkydri_tpu_torch.detector.refine import (
    N_SAMPLES,
    N_WALK,
    WALK_RANGE,
    refine_quads,
)
from chalkydri_tpu_torch.ops import build

MAX_POINTS = 128  # points a cluster (csrc/tail.cu::MAX_P)
QUAD_WARPS = 8  # warps of a T1 CTA, a cluster each
QUAD_CTAS = 8  # CTAs of a frame's thread block cluster (the portable most)
MAX_SAMPLES = 128  # a family's data + black + white samples
MAX_WORDS = 65535  # code words x rotations (a 16-bit index in the match)
MAX_CANDIDATES = 1024
MAX_SHARED_BYTES = 232_448  # a Hopper CTA's dynamic shared memory
DEC_WARP_BYTES = 4 * (2 * 72 + 2 * 2 * 12 + MAX_SAMPLES + 64)  # DecWarp
DEC_CAND_BYTES = 4 * (8 + 1 + 3)  # DecCand
ATB_TREE_FROM = 65  # matrices from which cuBLAS's a^T b sums a product tree


def quad_geometry(k: int, p: int) -> tuple[int, int, int]:
    """T1's (CTAs of a frame's cluster, threads a CTA, shared bytes a CTA)
    for ``k`` clusters of ``p`` points. Raises outside 1..``MAX_POINTS``
    points or without clusters."""
    if not 1 <= p <= MAX_POINTS:
        raise ValueError(f"fit_select: {p} points a cluster, the kernel "
                         f"takes 1 to {MAX_POINTS}")
    if k < 1:
        raise ValueError("fit_select: no clusters")
    ctas = min(QUAD_CTAS, -(-k // QUAD_WARPS))
    per = -(-k // ctas)
    return ctas, 32 * min(QUAD_WARPS, per), per * 40 + k * 4


def candidate_threads(kq: int) -> int:
    """Threads of T2's and T3's CTA (a frame) for ``kq`` candidates: a
    warp a candidate, at most 32 warps (they loop beyond)."""
    if not 1 <= kq <= MAX_CANDIDATES:
        raise ValueError(f"tail: {kq} quad candidates a frame, the kernels "
                         f"take 1 to {MAX_CANDIDATES}")
    return 32 * min(kq, 32)


def decode_shared_bytes(kq: int, nwords: int) -> int:
    """T3's shared bytes a CTA (``csrc/tail.cu::decode_layout``): the code
    words (two 32-bit halves each), a warp's workspace, the candidates and
    their order. Raises above the card's limit."""
    nwarps = candidate_threads(kq) // 32
    n = (nwords * 8 + 15) // 16 * 16
    n += DEC_WARP_BYTES * nwarps + DEC_CAND_BYTES * kq + 8 * kq
    if n > MAX_SHARED_BYTES:
        raise ValueError(f"decode_rank: {n} bytes of shared memory a CTA "
                         f"({nwords} code words, {kq} candidates), the card "
                         f"gives {MAX_SHARED_BYTES}")
    return n


def _expect(name: str, x: torch.Tensor, shape: tuple, dtype) -> torch.Tensor:
    if tuple(x.shape) != shape or x.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype} {list(shape)}, got "
                         f"{x.dtype} {list(x.shape)}")
    return x.contiguous()


def _ptrs(*tensors):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _args(*arrays):
    return tuple(ctypes.cast(a, ctypes.c_void_p) for a in arrays)


def fit_select(points: torch.Tensor, mask: torch.Tensor,
               cluster_valid: torch.Tensor, count: torch.Tensor, kq: int,
               quad_decimate: int):
    """T1: points [B, 4, K, P] float32, mask [B, K, P] bool, cluster_valid
    [B, K] bool, count [B, K] int32 -> (``Quads`` of every cluster, the
    ``min(kq, K)`` best quads' corners [B, kq, 4, 2] (times 2 plus 0.5 at
    ``quad_decimate`` 2) and valid [B, kq])."""
    if not build.on_card(points):
        return fit_select_plain(points, mask, cluster_valid, count, kq,
                                quad_decimate)
    if points.dim() != 4 or points.shape[1] != 4:
        raise ValueError("fit_select: expected points [B, 4, K, P]")
    if quad_decimate not in (1, 2):
        raise ValueError("fit_select: quad_decimate must be 1 or 2")
    b, _, k, p = points.shape
    ctas, threads, nbytes = quad_geometry(k, p)
    kq = min(kq, k)
    points = _expect("fit_select", points, (b, 4, k, p), torch.float32)
    mask = _expect("fit_select", mask, (b, k, p), torch.bool)
    cluster_valid = _expect("fit_select", cluster_valid, (b, k), torch.bool)
    count = _expect("fit_select", count, (b, k), torch.int32)
    build.same_device("fit_select", points, mask, cluster_valid, count)
    corners = build.empty((b, k, 4, 2), torch.float32, points)
    valid = build.empty((b, k), torch.bool, points)
    sel = build.empty((b, kq, 4, 2), torch.float32, points)
    sel_valid = build.empty((b, kq), torch.bool, points)
    if b > 0:
        ints = (ctypes.c_int * 8)(b, k, p, kq, quad_decimate, ctas, threads,
                                  nbytes)
        build.launch("chalkydri_tail_quads", points, *_args(
            _ptrs(points, mask, cluster_valid, count, corners, valid, sel,
                  sel_valid), ints))
        build.count(fit_select)
    return Quads(corners=corners, valid=valid), sel, sel_valid


fit_select.launches = 0

_T = np.linspace(0.15, 0.85, N_SAMPLES, dtype=np.float32)  # refine.py's t
_W = np.linspace(-WALK_RANGE, WALK_RANGE, N_WALK, dtype=np.float32)


def refine_corners(gray: torch.Tensor, corners: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """T2: gray [B, H, W] uint8, corners [B, kq, 4, 2], valid [B, kq] ->
    refined corners [B, kq, 4, 2] (``refine_quads`` at its defaults)."""
    if not build.on_card(corners):
        return refine_quads(gray, corners, valid)
    if gray.dim() != 3 or corners.dim() != 4:
        raise ValueError("refine_corners: expected gray [B, H, W] and "
                         "corners [B, kq, 4, 2]")
    b, h, w = gray.shape
    kq = corners.shape[1]
    threads = candidate_threads(kq)
    gray = _expect("refine_corners", gray, (b, h, w), torch.uint8)
    corners = _expect("refine_corners", corners, (b, kq, 4, 2), torch.float32)
    valid = _expect("refine_corners", valid, (b, kq), torch.bool)
    build.same_device("refine_corners", gray, corners, valid)
    out = build.empty((b, kq, 4, 2), torch.float32, corners)
    if b > 0:
        ints = (ctypes.c_int * 5)(b, h, w, kq, threads)
        reals = (ctypes.c_float * (N_SAMPLES + N_WALK + 1))(
            *_T.tolist(), *_W.tolist(), WALK_RANGE + 1.0)
        build.launch("chalkydri_tail_refine", corners, *_args(
            _ptrs(gray, corners, valid, out), ints, reals))
        build.count(refine_corners)
    return out


refine_corners.launches = 0


def _decoder_tables(decoder, device: torch.device):
    """(sample grid [nbits + nb + nw, 2], normal matrices [2, 3, 3]) of
    ``decoder`` on ``device``: the normal matrices computed there by the
    plain chain's own op, once."""
    cache = decoder.__dict__.setdefault("_tail_tables", {})
    if device not in cache:
        grid = torch.cat([decoder.data_xy, decoder.black_xy,
                          decoder.white_xy]).to(device).contiguous()
        ata = torch.stack([decoder.normal_matrix(decoder.black_design),
                           decoder.normal_matrix(decoder.white_design)])
        cache[device] = (grid, ata.to(device).contiguous())
    return cache[device]


def decode_rank(decoder, gray: torch.Tensor, corners: torch.Tensor,
                quad_valid: torch.Tensor, max_detections: int):
    """T3: ``decoder``'s decode of gray [B, H, W] uint8 at corners
    [B, kq, 4, 2] with quad_valid [B, kq], then the rank by margin, the
    per-id dedup and the compaction to ``max_detections`` slots. Returns
    (``Decoded`` of every candidate, (ids, corners, decision margins,
    hammings, valid) of the detections)."""
    if not build.on_card(corners):
        return decode_rank_plain(decoder, gray, corners, quad_valid,
                                 max_detections)
    if gray.dim() != 3 or corners.dim() != 4:
        raise ValueError("decode_rank: expected gray [B, H, W] and corners "
                         "[B, kq, 4, 2]")
    b, h, w = gray.shape
    kq = corners.shape[1]
    nbits, nb, nw = (len(decoder.data_xy), len(decoder.black_xy),
                     len(decoder.white_xy))
    nwords = decoder.codes.shape[0]
    if nbits > 64 or nbits + nb + nw > MAX_SAMPLES or nwords > MAX_WORDS:
        raise ValueError(f"decode_rank: a family of {nbits} bits and "
                         f"{nwords} code words; the kernel takes at most 64 "
                         f"bits, {MAX_SAMPLES} samples and {MAX_WORDS} words")
    if max_detections < 1:
        raise ValueError("decode_rank: max_detections must be at least 1")
    threads = candidate_threads(kq)
    nbytes = decode_shared_bytes(kq, nwords)
    gray = _expect("decode_rank", gray, (b, h, w), torch.uint8)
    corners = _expect("decode_rank", corners, (b, kq, 4, 2), torch.float32)
    quad_valid = _expect("decode_rank", quad_valid, (b, kq), torch.bool)
    build.same_device("decode_rank", gray, corners, quad_valid,
                      decoder.codes)
    grid, ata = _decoder_tables(decoder, gray.device)
    codes = decoder.codes.contiguous()
    f32, i32 = torch.float32, torch.int32
    dec = Decoded(tag_id=build.empty((b, kq), i32, gray),
                  hamming=build.empty((b, kq), i32, gray),
                  decision_margin=build.empty((b, kq), f32, gray),
                  corners=build.empty((b, kq, 4, 2), f32, gray),
                  valid=build.empty((b, kq), torch.bool, gray))
    d = max_detections
    dets = (build.empty((b, d), i32, gray),
            build.empty((b, d, 4, 2), f32, gray),
            build.empty((b, d), f32, gray),
            build.empty((b, d), i32, gray),
            build.empty((b, d), torch.bool, gray))
    if b > 0:
        ints = (ctypes.c_int * 13)(
            b, h, w, kq, nbits, nb, nw, nwords, decoder.bits_corrected, d,
            int(b * kq >= ATB_TREE_FROM), threads, nbytes)
        build.launch("chalkydri_tail_decode", gray, *_args(
            _ptrs(gray, corners, quad_valid, grid, codes, ata, dec.tag_id,
                  dec.hamming, dec.decision_margin, dec.corners, dec.valid,
                  *dets), ints))
        build.count(decode_rank)
    return dec, dets


decode_rank.launches = 0
