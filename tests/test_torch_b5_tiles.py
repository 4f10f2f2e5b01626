"""The decomposition behind kernel B5 on the card, as a plain model held
bit for bit to the plain twin; no card needed.

B5 (``csrc/threshold_ccl.cu``, ``chalkydri_threshold_ccl_exact``) cuts each
frame into rectangles of ``RECT_ROWS`` x ``RECT_COLS`` pixels (smaller at
the frame's right and bottom edges) and runs three launches. The model
follows them phase by phase:

1. the tile kernel, a rectangle at a time: its gray bytes staged with one
   threshold tile of halo, the tile min/max of the rectangle and of the
   ring around it (tiles outside the frame contribute nothing), their 3x3
   dilation and the classification, held equal to ``adaptive_threshold``
   on its own (a rectangle of skip pixels stores only ``INVALID`` labels,
   which the phases below also give it); then row runs, chunk by chunk
   with a carry, the unions with the row above inside the rectangle once
   a pair of runs (shuffled, as the warps' queues take them, and
   interleaved one shared-memory access at a time, with path halving),
   the flatten by path halving with the walks interleaved the same way
   (some held just before a halving store), the roots of the components
   on the sides that face another rectangle marked, and the labels: final
   inside, ``-1 - local root`` for the others, whose roots start the
   frame's parent page;
2. the border unions from each rectangle's top row and left column, once
   a pair of runs, shuffled across rectangles and interleaved access by
   access (path halving by atomicMin while unions run);
3. the resolve pass: each local root named on a rectangle's open sides
   walks to its root (walks of all rectangles interleaved, halving), and
   every provisional label takes its root's padded-flat index.

Run at the kernel's rectangle and at smaller ones, so that small frames
cross many borders. Exact equality throughout; no tolerance is involved."""

import os
import random

import numpy as np
import pytest
import torch

from chalkydri_tpu_torch.detector.segment import INVALID, padded_width
from chalkydri_tpu_torch.detector.threshold import (
    MIN_WHITE_BLACK_DIFF,
    adaptive_threshold,
)
from chalkydri_tpu_torch.ops.threshold_ccl import (
    RECT_COLS,
    RECT_ROWS,
    threshold_ccl_exact,
    threshold_ccl_exact_plain,
)
from chalkydri_tpu_torch.tools.scenes import blob_tern, mixed_terns, serpentine

torch.set_num_threads(1)

TILE = 4
# The kernel's rectangle, and smaller ones (columns a multiple of the
# 32-pixel chunk) that cut small frames into many.
RECTS = [(RECT_ROWS, RECT_COLS), (8, 32), (4, 32)]
RECT_IDS = [f"{r}x{c}" for r, c in RECTS]


def test_rectangle_matches_the_kernel():
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                       "chalkydri_tpu_torch", "csrc", "threshold_ccl.cu")
    with open(src) as f:
        text = f.read()
    assert f"constexpr int kRows = {RECT_ROWS};" in text
    assert f"constexpr int kColShift = {RECT_COLS.bit_length() - 1};" in text
    assert RECT_ROWS % TILE == 0 and RECT_COLS == 128


def rects_of(h: int, w: int, rows: int, cols: int):
    """(y0, x0, rh, rw) of every rectangle of an h x w frame, in the
    kernel's block order."""
    return [(y0, x0, min(rows, h - y0), min(cols, w - x0))
            for y0 in range(0, h, rows) for x0 in range(0, w, cols)]


def tile_tern(gray: np.ndarray, rect, min_diff=MIN_WHITE_BLACK_DIFF):
    """The tile kernel's phases 0-3 on one rectangle of one frame: the
    tern tile [rh, rw]."""
    h, w = gray.shape
    y0, x0, rh, rw = rect
    # staged gray: rows y0 - 4 .. y0 + rh + 4, columns x0 - 4 .. x0 + rw + 4
    st = np.zeros((rh + 2 * TILE, rw + 2 * TILE), np.int32)
    gy0, gy1 = max(y0 - TILE, 0), min(y0 + rh + TILE, h)
    gx0, gx1 = max(x0 - TILE, 0), min(x0 + rw + TILE, w)
    st[gy0 - y0 + TILE:gy1 - y0 + TILE, gx0 - x0 + TILE:gx1 - x0 + TILE] = \
        gray[gy0:gy1, gx0:gx1]
    th, tw = rh // TILE + 2, rw // TILE + 2
    blocks = st.reshape(th, TILE, tw, TILE)
    mn, mx = blocks.min(axis=(1, 3)), blocks.max(axis=(1, 3))
    ty = y0 // TILE - 1 + np.arange(th)
    tx = x0 // TILE - 1 + np.arange(tw)
    inside = (((ty >= 0) & (ty < h // TILE))[:, None]
              & ((tx >= 0) & (tx < w // TILE))[None, :])
    mn, mx = np.where(inside, mn, 255), np.where(inside, mx, 0)
    dmn = np.full((th - 2, tw - 2), 255)
    dmx = np.zeros((th - 2, tw - 2), np.int32)
    for dy in range(3):
        for dx in range(3):
            dmn = np.minimum(dmn, mn[dy:dy + th - 2, dx:dx + tw - 2])
            dmx = np.maximum(dmx, mx[dy:dy + th - 2, dx:dx + tw - 2])
    contrast = dmx - dmn
    thr = np.where(contrast < min_diff, -1, dmn + contrast // 2)
    thr = np.repeat(np.repeat(thr, TILE, axis=0), TILE, axis=1)
    g = st[TILE:TILE + rh, TILE:TILE + rw]
    return np.where(thr < 0, 127, np.where(g > thr, 255, 0)).astype(np.uint8)


def interleave(walks, rng, held=None):
    """Runs generator walks to their ends, one step of a random one at a
    time. With ``held``, a walk whose step says it is about to make a
    halving store waits there one time in two until the others have
    ended (the window in which the entry's own thread stores its root)."""
    pick = random.Random(int(rng.integers(1 << 31)))
    live, waiting, released = list(walks), [], False
    while live or waiting:
        if not live:
            pick.shuffle(waiting)
            live, waiting, released = waiting, [], True
        j = pick.randrange(len(live))
        try:
            store_next = next(live[j])
        except StopIteration:
            live[j] = live[-1]
            live.pop()
            continue
        if held and store_next and not released and pick.random() < 0.5:
            waiting.append(live[j])
            live[j] = live[-1]
            live.pop()


def find_halving(par, q):
    """ccl::find_halving over the CTA's shared entries (SharedPage) or the
    frame's parent page (GlobalPage), an access a step; returns the
    root."""
    while True:
        v = int(par[q])
        assert 0 <= v <= q, "an entry no phase wrote"
        yield
        if v == q:
            return q
        g = int(par[v])
        yield
        if g == v:
            return v
        par[q] = min(par[q], g)  # atomicMin
        yield
        q = g


def unite(par, a, b):
    """ccl::unite over either page, an access a step: the larger root
    under the smaller by atomicMin, retried with the value it returns."""
    while True:
        a = yield from find_halving(par, a)
        b = yield from find_halving(par, b)
        if a == b:
            return
        a, b = min(a, b), max(a, b)
        old = int(par[b])
        par[b] = min(old, a)  # atomicMin
        yield
        if old == b:
            return
        b = old


class B5Model:
    """One frame [H, W] through B5's three launches, rectangles of
    ``rows`` x ``cols``."""

    def __init__(self, gray: np.ndarray, rows: int, cols: int, rng):
        self.g = gray
        self.h, self.w = gray.shape
        self.rows, self.cols = rows, cols
        self.wp = padded_width(self.w)
        self.rng = rng
        self.rects = rects_of(self.h, self.w, rows, cols)
        self.tern = np.zeros((self.h, self.w), np.uint8)
        self.labels = np.zeros((self.h, self.w), np.int64)
        self.parent = np.full(self.h * self.w, -1, np.int64)  # never written

    def shuffled(self, xs):
        xs = list(xs)
        self.rng.shuffle(xs)
        return xs

    def open_sides(self, rect):
        """(ly, lx) of the rectangle's pixels on sides that face another
        rectangle."""
        y0, x0, rh, rw = rect
        out = []
        if y0 > 0:
            out += [(0, x) for x in range(rw)]
        if y0 + rh < self.h:
            out += [(rh - 1, x) for x in range(rw)]
        if x0 > 0:
            out += [(y, 0) for y in range(rh)]
        if x0 + rw < self.w:
            out += [(y, rw - 1) for y in range(rh)]
        return out

    # -- launch 1 --------------------------------------------------------

    def tile(self, rect):
        y0, x0, rh, rw = rect
        cols = self.cols
        t = np.full((rh, cols), 127, np.int64)  # 127 past the width
        t[:, :rw] = tile_tern(self.g, rect)
        self.tern[y0:y0 + rh, x0:x0 + rw] = t[:, :rw]
        tf = t.reshape(-1)
        par = np.full(rh * cols, -1, np.int64)
        # row runs, chunk by chunk with the last start carried
        for ly in range(rh):
            carry = 0
            for c in range(cols // 32):
                x = 32 * c + np.arange(32)
                v = t[ly, x]
                prev = t[ly, np.maximum(x - 1, 0)]
                start = (v == 127) | (x == 0) | (prev != v)
                upto = np.maximum.accumulate(np.where(start, x, -1))
                run = np.where(upto >= 0, upto, carry)
                keep = v != 127
                par[ly * cols + x[keep]] = ly * cols + run[keep]
                if start.any():
                    carry = int(x[start].max())
        # unions with the row above inside the rectangle, once a pair of
        # runs (local_links), in the order the warps' queues happen to take
        links = []
        for i in range(cols, rh * cols):
            v, lx = tf[i], i % cols
            if v == 127:
                continue
            left = lx > 0 and tf[i - 1] == v
            up_left = tf[i - cols - 1] if lx > 0 else 127
            up = tf[i - cols] == v
            if up and not (left and up_left == v):
                links.append((i, i - cols))
            if v == 255:
                if not left and up_left == 255:
                    links.append((i, i - cols - 1))
                if not up and lx < rw - 1 and tf[i - cols + 1] == 255:
                    links.append((i, i - cols + 1))
        interleave([unite(par, a, b) for a, b in self.shuffled(links)],
                   self.rng)
        # the flatten: every non-skip pixel's walk, interleaved
        interleave([self.halving_walk(par, i) for i in range(rh * cols)
                    if tf[i] != 127], self.rng, held=True)
        touched = {int(par[ly * cols + lx]) for ly, lx in self.open_sides(rect)
                   if tf[ly * cols + lx] != 127}
        for ly in range(rh):
            for lx in range(rw):
                i = ly * cols + lx
                if tf[i] == 127:
                    out = INVALID
                else:
                    root = int(par[i])
                    assert tf[root] == tf[i] and root <= i
                    if root in touched:
                        out = -1 - root
                        if root == i:
                            p = (y0 + ly) * self.w + x0 + lx
                            self.parent[p] = p
                    else:
                        out = ((y0 + root // cols) * self.wp + x0
                               + root % cols)
                self.labels[y0 + ly, x0 + lx] = out

    @staticmethod
    def halving_walk(par, p):
        """Pixel p's thread in the flatten, a shared-memory access a step
        (yields True when its next step is a halving store into another
        pixel's entry), then p's root stored in p's own entry."""
        q = p
        while True:
            v = par[q]
            yield False
            if v == q:
                break
            g = par[v]
            yield q != p and g != v
            if g == v:
                q = v
                break
            par[q] = min(par[q], g)  # atomicMin
            yield False
            q = g
        par[p] = q

    # -- launches 2 and 3: the frame's parent page -----------------------

    def local_root(self, q):
        """The frame-flat local root of frame-flat q, from its -1 - root
        label."""
        y, x = divmod(q, self.w)
        lab = int(self.labels[y, x])
        assert lab < 0, "a border pixel with a final label"
        ly, lx = divmod(-1 - lab, self.cols)
        return (y - y % self.rows + ly) * self.w + x - x % self.cols + lx

    def border_links(self, rect):
        """border_kernel's links of one rectangle: pairs of frame-flat
        indices."""
        y0, x0, rh, rw = rect
        f, w = self.tern.reshape(-1).astype(np.int64), self.w
        links = []
        if y0 > 0:
            for x in range(x0, x0 + rw):
                p = y0 * w + x
                v = f[p]
                if v == 127:
                    continue
                left = x > x0 and f[p - 1] == v
                up_left = f[p - w - 1] if x > 0 else 127
                up = f[p - w] == v
                if up and not (left and up_left == v):
                    links.append((p, p - w))
                if v == 255:
                    if not left and up_left == 255:
                        links.append((p, p - w - 1))
                    if (x + 1 < w and f[p - w + 1] == 255
                            and not (up and x + 1 < x0 + rw)):
                        links.append((p, p - w + 1))
        if x0 > 0:
            for y in range(y0, y0 + rh):
                p = y * w + x0
                v = f[p]
                if v == 127:
                    continue
                left = f[p - 1] == v
                up = y > y0 and f[p - w] == v
                if left and not (up and f[p - w - 1] == v):
                    links.append((p, p - 1))
                if v == 255:
                    if y > y0 and not left and f[p - w - 1] == 255:
                        links.append((p, p - w - 1))
                    if (y + 1 < y0 + rh and f[p + w - 1] == 255
                            and f[p - 1] != 255):
                        links.append((p + w - 1, p))
        return links

    def resolve_walks(self, rect, label_of):
        y0, x0, rh, rw = rect
        claimed = set()
        for ly, lx in self.open_sides(rect):
            v = int(self.labels[y0 + ly, x0 + lx])
            if v >= 0 or -1 - v in claimed:
                continue
            claimed.add(-1 - v)
            yield self.resolve_one(rect, -1 - v, label_of)

    def resolve_one(self, rect, l, label_of):
        y0, x0 = rect[:2]
        root = yield from find_halving(
            self.parent, (y0 + l // self.cols) * self.w + x0 + l % self.cols)
        label_of[rect, l] = root // self.w * self.wp + root % self.w

    def run(self):
        for rect in self.shuffled(self.rects):
            self.tile(rect)
        links = [link for rect in self.rects
                 for link in self.border_links(rect)]
        interleave([unite(self.parent, self.local_root(a), self.local_root(b))
                    for a, b in self.shuffled(links)], self.rng)
        label_of = {}
        interleave([walk for rect in self.shuffled(self.rects)
                    for walk in self.resolve_walks(rect, label_of)], self.rng)
        for rect in self.rects:
            y0, x0, rh, rw = rect
            tile = self.labels[y0:y0 + rh, x0:x0 + rw]
            for ly, lx in zip(*np.nonzero(tile < 0)):
                tile[ly, lx] = label_of[rect, -1 - int(tile[ly, lx])]
        return self.tern, self.labels


def assert_model_equals_twin(gray: np.ndarray, rects=RECTS, seed=0):
    """Every frame of ``gray`` [B, H, W] through the model at each
    rectangle size equals ``threshold_ccl_exact_plain``."""
    want_tern, want_labels = (
        x.numpy() for x in threshold_ccl_exact_plain(torch.from_numpy(gray)))
    rng = np.random.default_rng(seed)
    for rows, cols in rects:
        for j in range(gray.shape[0]):
            tern, labels = B5Model(gray[j], rows, cols, rng).run()
            assert np.array_equal(tern, want_tern[j]), (rows, cols, j)
            assert np.array_equal(labels, want_labels[j]), (rows, cols, j)
    return want_labels


# -- launch 1's threshold on its own --------------------------------------

@pytest.mark.parametrize("rect", RECTS, ids=RECT_IDS)
@pytest.mark.parametrize("shape", [(100, 200), (4, 260), (136, 4),
                                   (68, 36), (132, 264)])
def test_tile_threshold_equals_adaptive_threshold(shape, rect):
    """Each rectangle's tern from its own halo, put together, is the
    whole frame's: noise over a gradient, so some tiles lack contrast."""
    rng = np.random.default_rng(sum(shape))
    h, w = shape
    base = 60 + 0.15 * np.arange(w)[None, :] + 0.1 * np.arange(h)[:, None]
    noise = rng.normal(0, 12, shape) * (rng.random((h // 4, w // 4)) < 0.05
                                        ).repeat(4, 0).repeat(4, 1)
    gray = np.clip(base + noise, 0, 255).astype(np.uint8)
    want = adaptive_threshold(torch.from_numpy(gray[None]))[0].numpy()
    got = np.zeros_like(want)
    for r in rects_of(h, w, *rect):
        y0, x0, rh, rw = r
        got[y0:y0 + rh, x0:x0 + rw] = tile_tern(gray, r)
    assert np.array_equal(got, want)
    assert 0 < (want == 127).mean() < 1


# -- the three launches against the twin ---------------------------------

def _noise(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, shape, dtype=np.uint8)


def _diagonal_corner(rows, cols, anti: bool):
    """Two white squares of 8 px on black that meet only at one corner
    pixel, diagonally across the corner of four rectangles (rows x
    cols): one component under 8-connectivity for whites."""
    s = min(8, rows)
    g = np.zeros((2 * rows + 8, 2 * cols + 8), np.uint8)
    if anti:  # white at (rows - 1, cols) and (rows, cols - 1)
        g[rows - s:rows, cols:cols + s] = 255
        g[rows:rows + s, cols - s:cols] = 255
    else:  # white at (rows - 1, cols - 1) and (rows, cols)
        g[rows - s:rows, cols - s:cols] = 255
        g[rows:rows + s, cols:cols + s] = 255
    return g[None]


@pytest.mark.parametrize("rect", RECTS, ids=RECT_IDS)
@pytest.mark.parametrize("anti", [False, True], ids=["diagonal", "anti"])
def test_whites_meeting_only_at_a_rectangle_corner(rect, anti):
    labels = assert_model_equals_twin(_diagonal_corner(*rect, anti),
                                      rects=[rect])
    rows, cols = rect
    white = _diagonal_corner(rows, cols, anti)[0] == 255
    assert len(np.unique(labels[0][white])) == 1


PAGES = {"noise, H and W off the rectangle": _noise((1, 100, 200), 1),
         "4 rows": _noise((1, 4, 260), 2),
         "4 columns": _noise((1, 136, 4), 3),
         "W % 16 != 0": _noise((1, 68, 36), 4),
         "blobs, B = 2": blob_tern((2, 72, 136), 5),
         "mixed terns": mixed_terns(68, 160, 20, 6)}


@pytest.mark.parametrize("name", PAGES)
def test_model_equals_the_twin(name):
    assert_model_equals_twin(PAGES[name], seed=len(name))


def test_serpentine_crosses_every_border_as_one_component():
    """A snake whose stripes cross every horizontal border and whose
    joins cross the vertical ones: one label for the whole snake."""
    gray = serpentine(136, 264, 60)[None]
    labels = assert_model_equals_twin(gray, seed=7)
    assert len(np.unique(labels[0][gray[0] == 255])) == 1


def test_4096_row_strip():
    """[1, 4096, 8]: 128 rectangles of one 8-pixel column of tiles."""
    assert_model_equals_twin(_noise((1, 4096, 8), 8),
                             rects=[(RECT_ROWS, RECT_COLS)], seed=8)


def test_deployed_scene_stripe():
    """Rows 552-752 of the deployed scene (the tags' rows), at the
    kernel's rectangle: 7 rows x 13 columns of rectangles."""
    from chalkydri_tpu_torch.tools.scenes import load_scene

    frames = load_scene("deployed", "cpu")[3]
    gray = frames[:, 552:752].contiguous().numpy()
    labels = assert_model_equals_twin(gray, rects=[(RECT_ROWS, RECT_COLS)],
                                      seed=9)
    assert len(np.unique(labels[labels != INVALID])) > 20


def test_cpu_wrapper_takes_the_twin():
    gray = torch.from_numpy(_noise((3, 12, 20), 10))
    before = threshold_ccl_exact.launches
    got = threshold_ccl_exact(gray)
    want = threshold_ccl_exact_plain(gray)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert threshold_ccl_exact.launches == before
