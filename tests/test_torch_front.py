"""Kernels X1-X3 (``ops/front.py``, ``csrc/front.cu``): extraction and
block compaction of full-resolution ternary + label images.

The kernels run only on a card. Here: ``extract_compact`` on CPU tensors,
inside and outside ``build.plain_chain()``, returns its plain twin
``detector/cluster.py::extract_and_compact``'s result bit for bit and
never reaches the kernel library; frames that need no compaction take
B7's dense pages on the card, none of X1-X3; the kernel route refuses what the kernels cannot
take before any launch. Models of the kernels in numpy, as they cut the
work (X1's 128 x 128 tiles and their count and flag layout; X2's score
histogram, cut score, index-ordered kept list and counting sort by score;
X3's slots), equal ``rank_blocks`` and ``dropped`` and the twin's pages
on all-tie scores, all-zero counts, fewer occupied blocks than k, boosts
at frame edges, k = 1,024 and rendered frames. On a card (marked
``cuda``, skipped without one): X1-X3 equal the twin bit for bit on the
deployed qd1 frames (B5 labels), the 4 x 800 x 1280 qd1 bench frames (B3
labels), a blank frame, a frame whose candidates overflow the budget and
at the capacity fallback's wide budget, and nothing launches inside
``plain_chain()``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

from chalkydri_tpu_torch.detector.cluster import (
    _INT_MAX,
    BOOST_DILATE,
    BOOST_SCORE,
    COMPACT_SLACK,
    _compact_blocks,
    direction_boosts,
    extract_and_compact,
    extract_boundary_points,
    rank_blocks,
)
from chalkydri_tpu_torch.detector.segment import (
    label_components,
    label_components_exact,
)
from chalkydri_tpu_torch.ops import build, extract_blocked, front
from chalkydri_tpu_torch.ops.extract_blocked import (
    extract_candidates_band_plain,
)
from chalkydri_tpu_torch.tools.scenes import (
    blob_tern,
    render_tiny,
    tiny_rig,
)

BLOCK = front.BLOCK


def _refuse(*args, **kwargs):
    raise AssertionError("a plain route reached the kernel library")


# ---- models of the kernels ----

def count_model(has0: np.ndarray, has1: np.ndarray):
    """X1: edge masks [B, H, W] of direction 0 (right pairs) and 1 (down
    pairs) -> counts0 [B, W * R] (block x * R + r), counts1 [B, H * C]
    (block y * C + c), flags0 [B, R, W], flags1 [B, C, H] (bit d: an edge
    of direction d in the tile's column or row), R = ceil(H / 128), C =
    ceil(W / 128), tile by tile."""
    b, h, w = has0.shape
    r, c = -(-h // BLOCK), -(-w // BLOCK)
    counts0 = np.zeros((b, w, r), np.int64)
    counts1 = np.zeros((b, h, c), np.int64)
    flags0 = np.zeros((b, r, w), np.uint8)
    flags1 = np.zeros((b, c, h), np.uint8)
    for ti in range(r):
        ys = slice(ti * BLOCK, min(h, (ti + 1) * BLOCK))
        for tj in range(c):
            xs = slice(tj * BLOCK, min(w, (tj + 1) * BLOCK))
            e0, e1 = has0[:, ys, xs], has1[:, ys, xs]
            counts0[:, xs, ti] = e0.sum(1)
            counts1[:, ys, tj] = e1.sum(2)
            flags0[:, ti, xs] = e0.any(1) | (e1.any(1) << 1)
            flags1[:, tj, ys] = e0.any(2) | (e1.any(2) << 1)
    return counts0.reshape(b, -1), counts1.reshape(b, -1), flags0, flags1


def boost_model(flags: np.ndarray) -> np.ndarray:
    """X2's boost of each line from its parts' flags [parts, lines]."""
    raw = np.bitwise_or.reduce(flags, axis=0)
    lines = raw.shape[0]
    window = np.zeros(lines, np.uint8)
    for o in range(-BOOST_DILATE, BOOST_DILATE + 1):
        lo, hi = max(0, -o), min(lines, lines - o)
        window[lo:hi] |= raw[lo + o:hi + o]
    return window == 3


def select_model(counts: np.ndarray, flags: np.ndarray, per_line: int,
                 keep: int):
    """X2 on one (frame, direction): (kept block indices in kept order,
    counts left out)."""
    boost = boost_model(flags)
    j = np.arange(counts.shape[0])
    score = counts + BOOST_SCORE * (boost[j // per_line] & (counts > 0))
    hist = np.bincount(score, minlength=416)
    above = np.concatenate([np.cumsum(hist[::-1])[::-1][1:], [0]])
    cut = max(s for s in range(416) if above[s] + hist[s] >= keep)
    take = keep - above[cut]
    ties = np.cumsum(score == cut) - (score == cut)  # ties before, in order
    listed = j[(score > cut) | ((score == cut) & (ties < take))]
    assert listed.shape[0] == keep
    sel = np.empty(keep, np.int64)
    offset = above.copy()
    for i in listed:  # the warp's counting sort, one entry at a time
        sel[offset[score[i]]] = i
        offset[score[i]] += 1
    return sel, int(counts.sum() - counts[listed].sum())


def emit_model(pages, sel0, sel1, h, w):
    """X3: the kept blocks' slots of the dense pages (black, white,
    payload [B, 2 * H * W]), pad slots INT_MAX, INT_MAX, 0."""
    b = pages[0].shape[0]
    r, c = -(-h // BLOCK), -(-w // BLOCK)
    out = []
    for x, fill in zip(pages, (_INT_MAX, _INT_MAX, 0)):
        d0 = np.full((b, w, r * BLOCK), fill, np.int64)
        d0[:, :, :h] = x[:, :h * w].reshape(b, h, w).transpose(0, 2, 1)
        d1 = np.full((b, h, c * BLOCK), fill, np.int64)
        d1[:, :, :w] = x[:, h * w:].reshape(b, h, w)
        d0, d1 = d0.reshape(b, -1, BLOCK), d1.reshape(b, -1, BLOCK)
        out.append(np.concatenate(
            [np.stack([d0[i, sel0[i]] for i in range(b)]),
             np.stack([d1[i, sel1[i]] for i in range(b)])], 1).reshape(b, -1))
    return out


def model_compact(pages, h, w, max_points):
    """X1-X3 on dense pages: (black, white, payload, dropped) as numpy,
    and the kept blocks (sel0, sel1)."""
    black = pages[0]
    b = black.shape[0]
    has0 = black[:, :h * w].reshape(b, h, w) != _INT_MAX
    has1 = black[:, h * w:].reshape(b, h, w) != _INT_MAX
    counts0, counts1, flags0, flags1 = count_model(has0, has1)
    k0, k1 = front.kept_blocks(h, w, max_points)
    r, c = -(-h // BLOCK), -(-w // BLOCK)
    sel0, sel1, dropped = [], [], []
    for i in range(b):
        s0, d0 = select_model(counts0[i], flags0[i], r, k0)
        s1, d1 = select_model(counts1[i], flags1[i], c, k1)
        sel0.append(s0)
        sel1.append(s1)
        dropped.append(d0 + d1)
    out = emit_model(pages, sel0, sel1, h, w)
    return (*out, np.array(dropped)), (np.stack(sel0), np.stack(sel1)), (
        counts0, counts1, flags0, flags1)


def _dense(has0, has1, seed=0):
    """Dense pages whose edges are the masks: labels from ``seed``, a
    unique payload a slot (so any reordering shows)."""
    rng = np.random.default_rng(seed)
    b, h, w = has0.shape
    has = np.concatenate([has0.reshape(b, -1), has1.reshape(b, -1)], 1)
    black = np.where(has, rng.integers(0, 1 << 20, has.shape), _INT_MAX)
    white = np.where(has, rng.integers(0, 1 << 20, has.shape), _INT_MAX)
    payload = np.tile(np.arange(2 * h * w), (b, 1))
    return [black, white, payload]


def _edge_cases():
    """name -> (has0, has1 [B, H, W] bool, max_points)."""
    rng = np.random.default_rng(7)
    full = np.ones((1, 256, 384), bool)
    sparse0 = np.zeros((2, 300, 260), bool)
    sparse1 = np.zeros((2, 300, 260), bool)
    for i, (y, x) in enumerate(((5, 7), (140, 200), (299, 259), (0, 0))):
        sparse0[i % 2, y, x] = sparse1[i % 2, max(0, y - 3), x] = True
    edge0 = np.zeros((1, 260, 300), bool)
    edge1 = np.zeros((1, 260, 300), bool)
    edge0[0, [0, 1, 258, 259], :] = True  # rows at the top and bottom
    edge1[0, :, [0, 299]] = True  # columns at the sides
    edge0[0, 100:110, 150] = True
    edge1[0, 130, 150:160] = True
    dense0 = rng.random((1, 512, 512)) < 0.02
    dense1 = rng.random((1, 512, 512)) < 0.02
    return {
        "all-tie scores": (full, full.copy(), 8192),
        "all-zero counts": (np.zeros((2, 200, 300), bool),
                            np.zeros((2, 200, 300), bool), 2048),
        "fewer occupied blocks than k": (sparse0, sparse1, 4096),
        "boosts at frame edges": (edge0, edge1, 1024),
        "k = 1,024": (dense0, dense1, 131072),
    }


@pytest.mark.parametrize("case", sorted(_edge_cases()))
def test_select_model_is_rank_blocks(case):
    """X2's rule (histogram, cut score, index-ordered list, counting sort
    by score) gives ``rank_blocks``' indices and the twin's ``dropped``,
    and X1-X3's model the twin's compacted pages, on dense pages whose
    edges are the case's masks."""
    has0, has1, max_points = _edge_cases()[case]
    b, h, w = has0.shape
    pages = _dense(has0, has1)
    (black, white, payload, dropped), (sel0, sel1), (
        counts0, counts1, flags0, flags1) = model_compact(pages, h, w,
                                                          max_points)
    cap = int(COMPACT_SLACK * max_points)
    both_col, both_row = direction_boosts(torch.from_numpy(has0),
                                          torch.from_numpy(has1))
    r, c = -(-h // BLOCK), -(-w // BLOCK)
    boost0 = both_col[:, :, None].expand(b, w, r).reshape(b, -1)
    boost1 = both_row[:, :, None].expand(b, h, c).reshape(b, -1)
    want0 = rank_blocks(torch.from_numpy(counts0), boost0, cap)
    want1 = rank_blocks(torch.from_numpy(counts1), boost1, cap)
    assert np.array_equal(sel0, want0.numpy())
    assert np.array_equal(sel1, want1.numpy())
    got = _compact_blocks(*(torch.from_numpy(x) for x in pages), cap, w)
    for name, g, m in zip(("black", "white", "payload", "dropped"), got,
                          (black, white, payload, dropped)):
        assert np.array_equal(g.numpy(), m), name
    if case == "k = 1,024":
        assert sel0.shape == sel1.shape == (1, 1024)
    if case == "all-zero counts":
        assert np.array_equal(sel0[0], np.arange(sel0.shape[1]))
    if case == "fewer occupied blocks than k":
        assert int((counts0 > 0).sum(1).max()) < sel0.shape[1]


def _frames():
    """Rendered tiny frames, full resolution, and their B5 labels."""
    layout, cams = tiny_rig()
    from chalkydri_tpu_torch.pipeline import build_rig_from_config
    from chalkydri_tpu_torch.detector.threshold import adaptive_threshold

    _, rc = build_rig_from_config(cams * 2, layout, device="cpu")
    gray = torch.from_numpy(render_tiny(layout, rc, 2))
    tern = adaptive_threshold(gray)
    return tern, label_components_exact(tern)


@pytest.fixture(scope="module")
def frames():
    return _frames()


@pytest.fixture(scope="module")
def blobs():
    """Two 200 x 300 blob terns (every run length at every offset) and
    their labels after 2 rounds (any CCL labelling will do)."""
    tern = torch.from_numpy(blob_tern((2, 200, 300), 1))
    return tern, label_components(tern, iters=2)


@pytest.mark.parametrize("max_points", [512, 2048, 8192])
def test_models_equal_extract_and_compact(frames, blobs, max_points):
    """The models of X1-X3 over the twin's own edge test equal
    ``extract_and_compact`` on rendered frames and on blobs (a tern and
    its labels), at budgets that keep few, some and most blocks."""
    for t, lab in (frames, blobs):
        b, h, w = t.shape
        assert 2 * h * w > max_points
        pages = [x.numpy().astype(np.int64)
                 for x in extract_boundary_points(t, lab)]
        (black, white, payload, dropped), _, _ = model_compact(
            pages, h, w, max_points)
        want = extract_and_compact(t, lab, max_points)
        for name, g, m in zip(("black", "white", "payload", "dropped"),
                              want, (black, white, payload, dropped)):
            assert np.array_equal(g.numpy(), m), name


@pytest.mark.parametrize("inside", [False, True],
                         ids=["outside plain_chain", "inside plain_chain"])
def test_cpu_inputs_take_the_twin(frames, inside, monkeypatch):
    """On CPU tensors ``extract_compact`` is ``extract_and_compact`` bit
    for bit, in and out of ``plain_chain()``, without the library."""
    tern, labels = frames
    monkeypatch.setattr(build, "kernel_library", _refuse)
    want = extract_and_compact(tern, labels, 1024)
    if inside:
        with build.plain_chain():
            got = front.extract_compact(tern, labels, 1024)
    else:
        got = front.extract_compact(tern, labels, 1024)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert int(got[3].max()) > 0  # the budget bites


def test_frames_within_the_budget_keep_the_plain_path(frames, monkeypatch):
    """Frames of at most ``max_points`` candidates are not compacted: on
    the card they take B7's dense pages (one ``chalkydri_extract_band``
    launch, none of X1-X3) with ``dropped`` 0. The launch is played here
    by B7's plain twin, written through the pointers it is given, so the
    result is ``extract_and_compact``'s bit for bit."""
    tern, labels = frames
    b, h, w = tern.shape
    launched = []

    def b7_by_its_twin(entry, like, *args):
        launched.append(entry)
        assert entry == "chalkydri_extract_band"
        assert args[:8] == (tern.data_ptr(), labels.data_ptr(), b, h, w,
                            0, 0, 0)
        for page, ptr in zip(extract_candidates_band_plain(tern, labels, 0,
                                                           0, 0), args[8:]):
            page = page.contiguous()
            ctypes.memmove(ptr, page.data_ptr(),
                           page.numel() * page.element_size())

    monkeypatch.setattr(build, "on_card", lambda *tensors: True)
    monkeypatch.setattr(build, "kernel_library", _refuse)
    monkeypatch.setattr(build, "launch", b7_by_its_twin)
    monkeypatch.setattr(extract_blocked, "check_frames",
                        lambda *args, **kw: None)
    before = front.extract_compact.launches
    b7_before = extract_blocked.extract_candidates_band.launches
    got = front.extract_compact(tern, labels, 2 * tern[0].numel())
    want = extract_and_compact(tern, labels, 2 * tern[0].numel())
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert got[0].shape == (b, 2 * tern[0].numel())
    assert launched == ["chalkydri_extract_band"]
    assert extract_blocked.extract_candidates_band.launches == b7_before + 1
    assert front.extract_compact.launches == before


def test_kept_blocks_is_rank_blocks_k():
    for h, w, max_points in ((1304, 1600, 65536), (800, 1280, 131072),
                             (64, 128, 512), (3, 5, 1), (256, 256, 1 << 20)):
        r, c = -(-h // BLOCK), -(-w // BLOCK)
        cap = int(COMPACT_SLACK * max_points)
        k = [rank_blocks(torch.zeros(1, n, dtype=torch.int64),
                         torch.zeros(1, n, dtype=torch.bool), cap).shape[1]
             for n in (w * r, h * c)]
        assert front.kept_blocks(h, w, max_points) == tuple(k)
    assert front.kept_blocks(1304, 1600, 65536) == (512, 512)
    assert front.kept_blocks(800, 1280, 131072) == (1024, 1024)


def _bad_calls(device):
    """name -> a call the kernel route refuses; the first three before
    ``check_frames``, the last two in it."""
    tern = torch.zeros((1, 64, 128), dtype=torch.uint8, device=device)
    labels = torch.zeros((1, 64, 128), dtype=torch.int32, device=device)
    big = (1, 2048, 2048)
    return {
        "labels int64": lambda: front.extract_compact(tern, labels.long(),
                                                      512),
        "labels of another shape": lambda: front.extract_compact(
            tern, labels[:, :32].contiguous(), 512),
        "more than MAX_KEEP blocks": lambda: front.extract_compact(
            torch.zeros(big, dtype=torch.uint8, device=device),
            torch.zeros(big, dtype=torch.int32, device=device),
            (front.MAX_KEEP + 1) * BLOCK),
        "side over 4096": lambda: front.extract_compact(
            torch.zeros((1, 8, 4104), dtype=torch.uint8, device=device),
            torch.zeros((1, 8, 4104), dtype=torch.int32, device=device), 512),
        "tern int32": lambda: front.extract_compact(labels, labels, 512),
    }


@pytest.mark.parametrize("case", sorted(_bad_calls("cpu"))[:3])
def test_kernel_route_refuses_before_a_launch(case, monkeypatch):
    """The kernel route (``build.on_card`` true) raises ``ValueError`` on
    labels it cannot take and on more kept blocks than X2 holds, before
    it reaches the library (``check_frames``, which takes CUDA tensors
    only, is left out here)."""
    monkeypatch.setattr(build, "on_card", lambda *tensors: True)
    monkeypatch.setattr(build, "kernel_library", _refuse)
    monkeypatch.setattr(front, "check_frames", lambda *args, **kw: None)
    with pytest.raises(ValueError, match="extract_compact"):
        _bad_calls("cpu")[case]()


# ---- on a card ----

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_equal_the_twin_on_the_card(card):
    """X1-X3 equal ``extract_and_compact`` bit for bit on the deployed qd1
    frames (B5 labels), the qd1 bench frames (B3 labels), a blank frame, an
    overflowing frame and at the wide budget; inside ``plain_chain()``
    nothing launches."""
    import chip_smoke

    lines = chip_smoke.front_checks(card)
    assert {"deployed qd1", "qd1 bench", "blank", "overflow",
            "wide budget"} <= set(lines)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_bad_calls("cpu")))
def test_kernel_route_refuses_on_a_card(card, case):
    with pytest.raises(ValueError):
        _bad_calls(card)[case]()
