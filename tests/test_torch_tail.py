"""Host side of the tail kernels (``ops/tail.py``, ``csrc/tail.cu``).

The kernels run only on a card (``chip_smoke.py`` holds them to the plain
chain there, bit for bit). Here: on CPU tensors each wrapper returns its
plain twin's result and never reaches the kernel library, and the
detector's tail equals the benchmark's frozen copy of the port's plain
tail bit for bit on the parity corpus; the launch geometry and shared
memory are pure functions of the shapes, within the card's limits for
every family; the C entries are registered; the kernel route refuses
shapes it cannot take before any launch. On a card
(marked ``cuda``, skipped without one): T1-T3 equal the plain chain bit
for bit on the benchmark drives at [2, 64, 128] and [4, 64, 128], on the
edge cases, for every family with refine on and off, and a replayed step
launches each kernel once.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import chalkydri_tpu_torch.detector.pipeline as dp
from chalkydri_tpu_torch.detector.cluster import Clusters
from chalkydri_tpu_torch.detector.decode import decode_rank_plain
from chalkydri_tpu_torch.detector.families import load_family
from chalkydri_tpu_torch.detector.pipeline import Detector
from chalkydri_tpu_torch.detector.quad import fit_select_plain
from chalkydri_tpu_torch.detector.refine import refine_quads
from chalkydri_tpu_torch.ops import build
from chalkydri_tpu_torch.ops import tail

FAMILIES = ("tag16h5", "tag25h9", "tag36h10", "tag36h11")


def _corpus_batches():
    """The parity corpus's scenes as four batches of 4 frames (uint8
    [4, 480, 640])."""
    from tests.reference_impl.corpus import build_parity_corpus

    frames = np.stack([c for c, _ in build_parity_corpus(16)])
    return [frames[i:i + 4] for i in range(0, 16, 4)]


@pytest.fixture(scope="module")
def corpus():
    return _corpus_batches()


def _reference_finish(family, refine, quad_decimate):
    """The benchmark's frozen copy of the port's plain tail
    (``benchmark/reference/detector.py::make_post_cluster``)."""
    from benchmark.reference.decode import Decoder as RefDecoder
    from benchmark.reference.detector import make_post_cluster as ref_post
    from benchmark.reference.families import load_family as ref_family

    return ref_post(RefDecoder(ref_family(family), bits_corrected=3),
                    refine=refine, quad_decimate=quad_decimate)


def _clusters_of(det, gray):
    """The detector's clusters of frames ``gray`` (its stages up to B2)."""
    small = (dp.decimate2(gray) if det.quad_decimate == 2
             else gray.contiguous())
    black, white, payload, dropped = det.candidates(small)
    return dp.cluster_candidates_batched(
        black, white, payload, max_points=det.edge_cap,
        max_clusters=det.max_clusters, cluster_points=det.cluster_points,
        dropped=dropped)


def _refuse(*args, **kwargs):
    raise AssertionError("a CPU tensor reached a kernel's entry")


@pytest.mark.parametrize("batch", range(4))
@pytest.mark.parametrize("quad_decimate,refine", [(2, True), (1, True),
                                                  (2, False)])
def test_cpu_tail_is_the_plain_chain(corpus, batch, quad_decimate, refine,
                                     monkeypatch):
    """On CPU tensors ``make_post_cluster``'s finish runs the plain chain
    (no kernel entry is reached) and its detections equal the frozen
    plain tail's bit for bit on the parity corpus's scenes (their noise
    needs the capacity fallback's wider candidate budget, or more)."""
    monkeypatch.setattr(build, "launch", _refuse)
    det = Detector(family="tag36h11", bits_corrected=3, refine=refine,
                   quad_decimate=quad_decimate,
                   max_edge_points=4 * dp.MAX_EDGE_POINTS)
    gray = torch.from_numpy(corpus[batch])
    with torch.no_grad():
        clusters = _clusters_of(det, gray)
        got = det.finish(gray, clusters)
        want = _reference_finish("tag36h11", refine, quad_decimate)(
            gray, clusters)
    for name, g, w in zip(got._fields, got, want):
        assert torch.equal(g, w), name
    assert int(got.valid.sum()) > 0


def test_cpu_stage_functions_take_the_plain_chain(corpus, monkeypatch):
    """``tail.fit_select``, ``tail.refine_corners`` and ``tail.decode_rank``
    on CPU tensors return their plain twins' results, in the kernels'
    structure, and never reach the kernel library."""
    monkeypatch.setattr(build, "kernel_library", _refuse)
    det = Detector()
    gray = torch.from_numpy(corpus[0])
    with torch.no_grad():
        cl = _clusters_of(det, gray)
        got = tail.fit_select(cl.points, cl.mask, cl.valid, cl.count, 32, 2)
        want = fit_select_plain(cl.points, cl.mask, cl.valid, cl.count, 32, 2)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        _, corners, valid = got
        refined = tail.refine_corners(gray, corners, valid)
        assert torch.equal(refined, refine_quads(gray, corners, valid))
        got = tail.decode_rank(det.decode, gray, refined, valid, 16)
        want = decode_rank_plain(det.decode, gray, refined, valid, 16)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert int(got[1][4].sum()) > 0


@pytest.mark.parametrize("k,p", [(1, 1), (1, 128), (7, 32), (16, 128),
                                 (64, 128), (64, 100), (65, 128), (256, 128),
                                 (1000, 128)])
def test_quad_geometry(k, p):
    """T1's cluster of CTAs, threads and shared bytes: pure in (K, P), at
    most 8 CTAs of 8 warps, every cluster a warp's, within the card."""
    ctas, threads, nbytes = tail.quad_geometry(k, p)
    assert (ctas, threads, nbytes) == tail.quad_geometry(k, p)
    assert 1 <= ctas <= tail.QUAD_CTAS
    assert threads % 32 == 0 and 32 <= threads <= 32 * tail.QUAD_WARPS
    per = -(-k // ctas)
    assert ctas * per >= k and (ctas - 1) * per < k  # no CTA left empty
    assert nbytes == per * 40 + k * 4 <= tail.MAX_SHARED_BYTES
    if k == 64:
        assert (ctas, threads) == (8, 256)  # the cells: 8 SMs a frame


@pytest.mark.parametrize("k,p", [(64, 0), (64, 129), (0, 128), (64, 256)])
def test_quad_geometry_refuses(k, p):
    with pytest.raises(ValueError):
        tail.quad_geometry(k, p)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("kq", [1, 16, 32, 64])
@pytest.mark.parametrize("refine,quad_decimate", [(True, 2), (False, 2),
                                                  (True, 1), (False, 1)])
def test_decode_geometry_within_the_card(family, kq, refine, quad_decimate):
    """T2's and T3's threads and T3's shared bytes are pure functions of
    the candidates and the family's tables, within the card's limits for
    every family, refine on and off, at quad_decimate 1 and 2 (neither
    changes them)."""
    det = Detector(family=family, refine=refine, quad_decimate=quad_decimate)
    dec = det.decode
    nbits, nb, nw = len(dec.data_xy), len(dec.black_xy), len(dec.white_xy)
    nwords = dec.codes.shape[0]
    assert nwords == 4 * load_family(family).ncodes <= tail.MAX_WORDS
    assert nbits <= 64 and nbits + nb + nw <= tail.MAX_SAMPLES
    threads = tail.candidate_threads(kq)
    assert threads == 32 * min(kq, 32) and threads <= 1024
    nbytes = tail.decode_shared_bytes(kq, nwords)
    assert nbytes == tail.decode_shared_bytes(kq, nwords)
    assert nbytes <= tail.MAX_SHARED_BYTES
    assert nbytes >= nwords * 8 + tail.DEC_WARP_BYTES * (threads // 32)


@pytest.mark.parametrize("kq", [0, -1, tail.MAX_CANDIDATES + 1])
def test_candidate_threads_refuses(kq):
    with pytest.raises(ValueError):
        tail.candidate_threads(kq)


def test_decode_shared_bytes_refuses_too_many_words():
    with pytest.raises(ValueError):
        tail.decode_shared_bytes(32, 40_000)


@pytest.mark.parametrize("entry,arity", [("chalkydri_tail_quads", 3),
                                         ("chalkydri_tail_refine", 4),
                                         ("chalkydri_tail_decode", 3)])
def test_entries_registered(entry, arity):
    """The three C entries are in ``_SIGNATURES`` (pointers: the
    argument arrays and the stream), and their source and the shared
    header are built and hashed."""
    assert build._SIGNATURES[entry] == [build._P] * arity
    assert "tail.cu" in build.SOURCES and "ordered.cuh" in build.HEADERS


def _clusters(b=2, k=64, p=128):
    return Clusters(points=torch.zeros(b, 4, k, p),
                    mask=torch.zeros(b, k, p, dtype=torch.bool),
                    count=torch.zeros(b, k, dtype=torch.int32),
                    valid=torch.zeros(b, k, dtype=torch.bool),
                    dropped=torch.zeros(b, dtype=torch.int32))


def test_wrappers_refuse_cpu_tensors(monkeypatch):
    """A CPU tensor never reaches a kernel: with the kernel library made
    to raise, each wrapper returns its plain twin's result bit for bit,
    in the kernel's structure (T1 (``Quads``, corners, valid), T3
    (``Decoded``, detections))."""
    monkeypatch.setattr(build, "kernel_library", _refuse)
    cl = _clusters()
    gray = torch.zeros(2, 64, 80, dtype=torch.uint8)
    corners = torch.zeros(2, 32, 4, 2)
    valid = torch.zeros(2, 32, dtype=torch.bool)
    dec = Detector().decode
    with torch.no_grad():
        torch.testing.assert_close(
            tail.fit_select(cl.points, cl.mask, cl.valid, cl.count, 32, 2),
            fit_select_plain(cl.points, cl.mask, cl.valid, cl.count, 32, 2),
            rtol=0, atol=0)
        assert torch.equal(tail.refine_corners(gray, corners, valid),
                           refine_quads(gray, corners, valid))
        torch.testing.assert_close(
            tail.decode_rank(dec, gray, corners, valid, 16),
            decode_rank_plain(dec, gray, corners, valid, 16), rtol=0, atol=0)


def _bad_calls(dev):
    cl = _clusters()
    gray = torch.zeros(2, 64, 80, dtype=torch.uint8, device=dev)
    corners = torch.zeros(2, 32, 4, 2, device=dev)
    valid = torch.zeros(2, 32, dtype=torch.bool, device=dev)
    pts, mask = cl.points.to(dev), cl.mask.to(dev)
    cv, count = cl.valid.to(dev), cl.count.to(dev)
    dec = Detector().decode.to(dev)
    return {
        "points of 3 channels": lambda: tail.fit_select(
            pts[:, :3], mask, cv, count, 32, 2),
        "more than 128 points": lambda: tail.fit_select(
            torch.zeros(2, 4, 64, 129, device=dev),
            torch.zeros(2, 64, 129, dtype=torch.bool, device=dev), cv, count,
            32, 2),
        "float64 points": lambda: tail.fit_select(
            pts.double(), mask, cv, count, 32, 2),
        "int64 counts": lambda: tail.fit_select(pts, mask, cv, count.long(),
                                                32, 2),
        "quad_decimate 4": lambda: tail.fit_select(pts, mask, cv, count, 32,
                                                   4),
        "float gray": lambda: tail.refine_corners(gray.float(), corners,
                                                  valid),
        "3 corners": lambda: tail.refine_corners(gray, corners[:, :, :3],
                                                 valid),
        "valid of another batch": lambda: tail.refine_corners(
            gray, corners, valid[:1]),
        "no candidates": lambda: tail.refine_corners(
            gray, corners[:, :0], valid[:, :0]),
        "decode, corners [B, kq, 8]": lambda: tail.decode_rank(
            dec, gray, corners.reshape(2, 32, 8), valid, 16),
        "decode, no slots": lambda: tail.decode_rank(dec, gray, corners,
                                                     valid, 0),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls("cpu")))
def test_wrappers_refuse_shapes(case, monkeypatch):
    """Shapes and types the kernels cannot take raise ``ValueError`` on
    the kernel route before any launch: the route forced on CPU tensors
    (``build.on_card`` true), the kernel library made to raise."""
    monkeypatch.setattr(build, "on_card", lambda *tensors: True)
    monkeypatch.setattr(build, "kernel_library", _refuse)
    with pytest.raises(ValueError):
        _bad_calls("cpu")[case]()


# ---- on a card ----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_equal_the_plain_chain_on_the_drives(card):
    """T1-T3 are the plain chain bit for bit on every benchmark
    configuration's drive (one seed), at [2, 64, 128] and [4, 64, 128]:
    the benchmark's ``correct`` rests on it. ``chip_smoke.py`` holds three
    seeds."""
    import chip_smoke

    drives, _ = chip_smoke.tail_drives(card, seeds=chip_smoke.TAIL_SEEDS[:1])
    assert sorted(drives) == [(2, 64, 128), (4, 64, 128)]
    for shape, gaps in drives.items():
        gaps.check(f"tail drives at {list(shape)}")
        assert gaps.calls == 14 * (2 if shape[0] == 2 else 1)


@pytest.mark.cuda
def test_kernels_equal_the_plain_chain_on_edge_cases(card):
    """No valid cluster, all valid, degenerate clusters, squares across
    the frame's edges, duplicate ids and more detections than slots, at
    both cells' shapes; then each family, refine on and off."""
    import chip_smoke

    _, first = chip_smoke.tail_drives(
        card, seeds=chip_smoke.TAIL_SEEDS[:1],
        names=("comp2-1600x1304-qd2", "north-4x1280x800-qd2"))
    gaps = chip_smoke.TailGaps()
    for det, gray, cl in first.values():
        chip_smoke.tail_edge_cases(det, gray, cl, gaps)
    gaps.check("tail edge cases")
    assert len(chip_smoke.tail_families(card)) == 16


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_bad_calls("cpu")))
def test_kernels_refuse_shapes_on_a_card(card, case):
    with pytest.raises(ValueError):
        _bad_calls(card)[case]()


@pytest.mark.cuda
def test_one_launch_a_stage_a_replay(card):
    """A captured detector's replay launches each tail kernel once, with
    refine; T2 not at all without it."""
    from chalkydri_tpu_torch.detector.pipeline import make_detector

    gray = torch.from_numpy(
        np.stack(_corpus_frames_without_jax())).to(card)
    for refine in (True, False):
        step = make_detector(refine=refine, device=card)
        step(gray)  # warm-up and capture
        for fn in (tail.fit_select, tail.refine_corners, tail.decode_rank):
            fn.launches = 0
        for _ in range(3):
            step(gray)
        torch.cuda.synchronize()
        assert tail.fit_select.launches == 3
        assert tail.refine_corners.launches == (3 if refine else 0)
        assert tail.decode_rank.launches == 3


def _corpus_frames_without_jax():
    """Two 480 x 640 frames of tag36h11 tags (the card machine has no
    JAX, so not the parity corpus)."""
    import chip_smoke

    fam = load_family("tag36h11")
    return list(chip_smoke.family_frames(fam, 2, 480, 640, 11))
