"""The decompositions behind kernels B6 and B7 on the card, as plain models
held bit for bit to the plain twins; no card needed.

B6 (``csrc/propagate.cu``, the cluster route): one frame per cluster of C
CTAs, CTA k holding the parent entries of rows [k * R, (k + 1) * R). The
model follows the kernel's phases: row runs from per-chunk start bits and a
block-wide max-scan over the chunks (emulated as the kernel cuts it: a few
chunks a thread, warp scans, warp totals), unions with the row above once
a pair of runs inside each CTA (queued by the warps, so in any order),
each CTA's trees flattened with path halving and its non-skip local roots
marked, unions across the CTAs' top rows (started from the two pixels'
local roots), the local roots resolved
over the cluster, then the label entry's padded-flat root index or the
propagate entry's fold (lanes of one root reduced per 32-pixel chunk, one
atomicMin a group into the root's slot of ``out``) and write-back. The
unions and resolutions run in shuffled orders, CTA by CTA and across CTAs,
and the flatten's walks of a CTA run interleaved one shared-memory access
at a time, some held just before a halving store, so a result that
leaned on an order would show. Also the route
function over every band the row-banded step and the dry run send.

B7 (``csrc/extract_blocked.cu``): tiles of 8 core rows x 128 columns, each
staged with one row above, two below, one column left and two right (127
outside the extended page; labels with a row below and a column right, 0
outside), four adjacent pixels a thread, stored as groups of four where
W % 4 == 0 and pixel by pixel otherwise.

Exact equality throughout; no tolerance is involved."""

import random

import numpy as np
import pytest
import torch

from chalkydri_tpu_torch.detector.pipeline import decimate2
from chalkydri_tpu_torch.detector.segment import (
    INVALID,
    label_components_exact,
    padded_width,
)
from chalkydri_tpu_torch.ops.extract_blocked import (
    extract_candidates_band_plain,
)
from chalkydri_tpu_torch.ops.propagate import (
    CLUSTER_SIZES,
    SHARED_BYTES,
    band_cluster_bytes,
    band_cluster_size,
    label_components_blocked_plain,
    propagate_components_blocked_plain,
)
from chalkydri_tpu_torch.tools.dryrun import CASES
from chalkydri_tpu_torch.tools.scenes import SCENES, blob_tern, serpentine

torch.set_num_threads(1)

THREADS = 1024  # a CTA of B6's cluster kernel


# -- B6: the route ----------------------------------------------------------

def _band_shapes():
    """(B, H, W) of every band B6 gets from the row-banded step on the
    spatial scene (4 bands, qd 1 and 2) and from the dry run's two cases
    over 1, 2, 4 and 8 bands (the detector decimates each band when
    ``quad_decimate`` is 2, its default)."""
    shapes = set()
    h, w = SCENES["spatial"][0]["height"], SCENES["spatial"][0]["width"]
    for qd in (1, 2):
        shapes.add((2, h // 4 // qd, w // qd))
    for _, calib, _, kw in CASES:
        qd = kw.get("quad_decimate", 2)
        for bands in (1, 2, 4, 8):
            shapes.add((2, calib["height"] // bands // qd,
                        calib["width"] // qd))
    return sorted(shapes)


def test_route_takes_every_band_the_step_sends_to_one_cluster():
    """Every band the row-banded step and the dry run send takes the
    cluster route, within the shared-memory budget; the deployed bands
    take 16 CTAs; one row over the budget takes the global route."""
    shapes = _band_shapes()
    assert (2, 328, 1600) in shapes and (2, 164, 800) in shapes
    for b, h, w in shapes:
        c = band_cluster_size(b, h, w)
        assert c in CLUSTER_SIZES and c <= h, (b, h, w)
        assert band_cluster_bytes(h, w, c) <= SHARED_BYTES
    assert band_cluster_size(2, 328, 1600) == 16
    assert band_cluster_size(2, 164, 800) == 16
    # parents, three words a chunk, the scan's warp totals and the warps'
    # union queues, to 16 bytes; then the tern rows and the row above
    words = 4 * 21 * 1600 + 12 * 1050 + 32 * 4 * 129
    assert band_cluster_bytes(328, 1600, 16) == -(-words // 16) * 16 + 22 * 1600
    for w in (800, 1600, 4096):
        fit = max(h for h in range(1, 4097) if band_cluster_size(1, h, w))
        assert band_cluster_bytes(fit, w, 16) <= SHARED_BYTES
        assert band_cluster_size(1, fit + 1, w) is None
        assert all(band_cluster_size(1, h, w) for h in range(1, fit + 1))
    assert all(band_cluster_size(1, h, 37) for h in range(1, 4097))
    assert [band_cluster_size(1, h, 64) for h in (1, 2, 3, 7, 8, 17)] == [
        1, 2, 2, 4, 8, 16]


# -- B6: the cluster kernel, modelled ---------------------------------------

def _clz(x: int) -> int:
    return 32 - int(x).bit_length()


def chunk_scan(words: list[int]) -> list[int]:
    """last[c], the last run start up to the end of chunk c, as the kernel
    computes it: each thread a few consecutive chunks, an inclusive
    max-scan of the threads' last starts in each warp of 32, the warps'
    totals scanned, each chunk raised to what the threads before it saw."""
    chunks = len(words)
    per = -(-chunks // THREADS)
    last = [0] * chunks
    runs = []
    for t in range(THREADS):
        run = -1
        for c in range(t * per, min(chunks, (t + 1) * per)):
            if words[c]:
                run = 32 * c + 31 - _clz(words[c])
            last[c] = run
        runs.append(run)
    scan = []
    for w in range(THREADS // 32):
        scan += list(np.maximum.accumulate(runs[32 * w:32 * w + 32]))
    warp_max = np.maximum.accumulate(scan[31::32])
    for t in range(THREADS):
        before = scan[t - 1] if t % 32 else -1
        if t >= 32:
            before = max(before, warp_max[t // 32 - 1])
        for c in range(t * per, min(chunks, (t + 1) * per)):
            last[c] = max(last[c], before)
    return last


@pytest.mark.parametrize("chunks", [1, 40, 1050, 3300])
def test_chunk_scan_finds_the_last_run_start(chunks):
    """The scan at chunk counts of one thread each and of two and four
    (1050 chunks: a CTA of 21 rows x 1600 px), on sparse start bits."""
    rng = np.random.default_rng(chunks)
    words = [int(w) if rng.random() < 0.1 else 0
             for w in rng.integers(0, 1 << 32, chunks, dtype=np.uint64)]
    words[0] |= 1
    want, run = [], -1
    for c, w in enumerate(words):
        if w:
            run = 32 * c + 31 - _clz(w)
        want.append(run)
    assert chunk_scan(words) == want


class ClusterModel:
    """One frame [H, W] on a cluster of C CTAs of R = ceil(H / C) rows."""

    def __init__(self, tern: np.ndarray, c: int, rng):
        self.f = tern.reshape(-1).astype(np.int64)
        self.h, self.w = tern.shape
        self.r = -(-self.h // c)
        self.rng = rng
        self.par = np.zeros(self.h * self.w, np.int64)
        self.local_root = np.zeros(self.h * self.w, bool)
        self.ctas = [(min(k * self.r, self.h), min(k * self.r + self.r, self.h))
                     for k in range(c)]

    def shuffled(self, xs):
        xs = list(xs)
        self.rng.shuffle(xs)
        return xs

    def find(self, q):
        """ccl::find_halving, run alone: every entry it passes is pointed
        at its grandparent."""
        while True:
            v = self.par[q]
            if v == q:
                return q
            g = self.par[v]
            if g == v:
                return v
            self.par[q] = min(self.par[q], g)
            q = g

    def halving_walk(self, p, atomic=True):
        """Pixel p's thread in the flatten, one shared-memory access a step
        (a generator that yields between them, True when its next step is
        a halving store into another pixel's entry): find_halving,
        lowering each entry it passes to its grandparent (with atomicMin,
        or a plain store when ``atomic`` is false), then p's root stored in
        p's own entry."""
        q = p
        while True:
            v = self.par[q]
            yield False
            if v == q:
                break
            g = self.par[v]
            yield q != p and g != v
            if g == v:
                q = v
                break
            self.par[q] = min(self.par[q], g) if atomic else g
            yield False
            q = g
        self.par[p] = q
        self.local_root[p] = q == p

    def interleave(self, walks):
        """Runs the walks to their ends, one step of a random one at a
        time. A walk about to make its first halving store into another
        pixel's entry waits there one time in two, until the others have
        ended: the window in which that entry's own thread stores its
        root before the halving store lands."""
        pick = random.Random(int(self.rng.integers(1 << 31)))
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
            if store_next and not released and pick.random() < 0.5:
                waiting.append(live[j])
                live[j] = live[-1]
                live.pop()

    def unite(self, a, b):
        while True:
            a, b = self.find(a), self.find(b)
            if a == b:
                return
            a, b = min(a, b), max(a, b)
            old = self.par[b]
            self.par[b] = min(old, a)
            if old == b:
                return
            b = old

    def unite_up(self, p, from_local_roots=False):
        """Pixel p's unions with the row above, once a pair of runs
        (ccl::links_up); ``from_local_roots``: each union starts from the
        two pixels' entries, their local roots, as phase 3's do."""
        f, w = self.f, self.w
        v, x = f[p], p % w
        if v == 127:
            return
        left = x > 0 and f[p - 1] == v
        up_left = f[p - w - 1] if x > 0 else 127
        up = f[p - w] == v
        links = []
        if up and not (left and up_left == v):
            links.append(p - w)
        if v == 255:
            if not left and up_left == 255:
                links.append(p - w - 1)
            if not up and x < w - 1 and f[p - w + 1] == 255:
                links.append(p - w + 1)
        for q in links:
            if from_local_roots:
                self.unite(self.par[p], self.par[q])
            else:
                self.unite(p, q)

    def runs(self, y0, y1):
        """Every pixel of the CTA under its row run's start."""
        base, n = y0 * self.w, (y1 - y0) * self.w
        chunks = -(-n // 32)
        words = []
        for c in range(chunks):
            word = 0
            for lane in range(32):
                i, p = 32 * c + lane, base + 32 * c + lane
                start = (i >= n or self.f[p] == 127 or p % self.w == 0
                         or self.f[p - 1] != self.f[p])
                word |= int(start) << lane
            words.append(word)
        last = chunk_scan(words)
        for i in range(n):
            c = i >> 5
            m = words[c] & (0xFFFFFFFF >> (31 - (i & 31)))
            self.par[base + i] = base + (32 * c + 31 - _clz(m) if m
                                         else last[c - 1])

    def run(self):
        """The unions: phases 1-4 of the kernel. Returns the root of
        every pixel as step 5 reads it (a non-skip local root's entry, or
        its local root's; a skip pixel's entry is its own index)."""
        w = self.w
        for y0, y1 in self.shuffled(self.ctas):
            if y1 > y0:
                self.runs(y0, y1)
        for y0, y1 in self.shuffled(self.ctas):
            for p in self.shuffled(range((y0 + 1) * w, y1 * w)):
                self.unite_up(p)
            self.interleave(  # a skip pixel is its own root
                self.halving_walk(p) for p in range(y0 * w, y1 * w)
                if self.f[p] != 127)
        tops = [y0 * w + x for y0, y1 in self.ctas if y1 > y0 and y0 > 0
                for x in range(w)]
        for p in self.shuffled(tops):
            self.unite_up(p, from_local_roots=True)
        roots = np.flatnonzero(self.local_root)
        for p in self.shuffled(roots):
            self.par[p] = self.find(p)
        # step 5 reads a pixel's local root in its own CTA's shared memory
        leaf = np.flatnonzero((self.f != 127) & ~self.local_root)
        per_cta = self.r * w
        assert np.array_equal(self.par[leaf] // per_cta, leaf // per_cta)
        return np.where(self.local_root, self.par,
                        self.par[self.par])

    def label(self, wp: int) -> np.ndarray:
        root = self.run()
        out = (root // self.w) * wp + root % self.w
        return np.where(self.f == 127, INVALID, out).reshape(self.h, self.w)

    def propagate(self, labels: np.ndarray) -> np.ndarray:
        root = self.run()
        lab = labels.reshape(-1).astype(np.int64)
        out = np.full(self.h * self.w, -1, np.int64)  # never read unless set
        for p in np.flatnonzero(self.local_root & (root == np.arange(root.size))):
            out[p] = INVALID
        keys = np.where(self.f == 127, -1, root)
        for y0, y1 in self.shuffled(self.ctas):
            base, n = y0 * self.w, (y1 - y0) * self.w
            for c in self.shuffled(range(-(-n // 32))):
                i = np.arange(32 * c, min(32 * c + 32, n)) + base
                for key in np.unique(keys[i]):
                    if key >= 0:
                        out[key] = min(out[key], lab[i][keys[i] == key].min())
        return np.where(self.f == 127, INVALID, out[root]).reshape(self.h,
                                                                  self.w)


@pytest.mark.parametrize("atomic", [True, False], ids=["atomicMin", "plain"])
def test_flatten_never_lifts_an_entry_over_its_root(atomic):
    """A chain 5 -> 4 -> ... -> 0 in one CTA. Pixel 5's walk reads 3's
    parent 2 and grandparent 1; pixel 3's walk then stores root 0 into 3's
    entry; then 5's walk halves entry 3 to 1. The kernel's atomicMin
    leaves the root there; a plain store would leave 1, which the later
    phases, reading a local root in one hop, would take for the root."""
    model = ClusterModel(np.full((1, 6), 255, np.uint8), 1,
                         np.random.default_rng(0))
    model.par[:] = np.maximum(np.arange(6) - 1, 0)
    walk5, walk3 = model.halving_walk(5, atomic), model.halving_walk(3, atomic)
    for _ in range(5):  # 5's walk reads 3's parent and grandparent
        next(walk5)
    assert list(model.par) == [0, 0, 1, 2, 3, 3]
    for _ in walk3:
        pass
    assert model.par[3] == 0
    for _ in walk5:
        pass
    assert model.par[5] == 0
    assert model.par[3] == (0 if atomic else 1)


def _b6_inputs():
    """(name, tern [B, H, W]): blobs at the shapes the kernel's index math
    meets (bands of 1-3 rows, odd heights and widths, CTAs left without
    rows), a snake through every CTA, and a thresholded tag band."""
    cases = [(f"blobs {s}", blob_tern(s, i)) for i, s in enumerate(
        ((1, 1, 40), (2, 2, 33), (1, 3, 37), (1, 17, 64), (2, 50, 36),
         (1, 41, 96), (1, 64, 128)))]
    bars = np.zeros((64, 33), np.uint8)  # deep trees in one CTA
    bars[:, ::4] = 255
    bars[np.arange(64), np.arange(64) % 31 + 1] = 255
    bars[::7, 2] = 127
    cases.append(("one-pixel bars and a staircase", bars[None]))
    cases.append(("serpentine", serpentine(64, 128, 20)[None]))
    cases.append(("serpentine across 16 CTAs of 4 rows",
                  serpentine(61, 64, 12)[None]))
    return cases


@pytest.mark.parametrize("name,tern", _b6_inputs(),
                         ids=[n for n, _ in _b6_inputs()])
def test_cluster_model_equals_the_twins(name, tern):
    """Both entries of the cluster model, at the route's C, at a C that
    leaves CTAs without rows where the frame allows and at one CTA (the
    deepest trees), equal the twins; the propagate entry on random labels
    (``INVALID`` on skip pixels)."""
    rng = np.random.default_rng(len(name))
    t = torch.from_numpy(tern)
    b, h, w = tern.shape
    labels = np.where(tern == 127, INVALID,
                      rng.integers(0, 1 << 30, tern.shape)).astype(np.int32)
    want_label = label_components_blocked_plain(t).numpy()
    want_prop = propagate_components_blocked_plain(
        t, torch.from_numpy(labels)).numpy()
    assert np.array_equal(want_label, label_components_exact(t).numpy())
    for c in sorted({band_cluster_size(b, h, w), min(16, h + 2), 1}):
        for j in range(b):
            got = ClusterModel(tern[j], c, rng).label(padded_width(w))
            assert np.array_equal(got, want_label[j]), (c, j)
            got = ClusterModel(tern[j], c, rng).propagate(labels[j])
            assert np.array_equal(got, want_prop[j]), (c, j)


def test_cluster_model_on_a_decimated_tag_band():
    """The spatial scene's decimated tag rows, cut to 40 columns across a
    tag, through 16 CTAs."""
    from chalkydri_tpu_torch.detector.threshold import adaptive_threshold
    from chalkydri_tpu_torch.tools.scenes import load_scene

    frames = load_scene("spatial", "cpu")[3]
    tern = adaptive_threshold(decimate2(frames))[:1, 296:360, 100:140]
    tern = tern.contiguous()
    rng = np.random.default_rng(3)
    got = ClusterModel(tern[0].numpy(), 16, rng).label(padded_width(40))
    assert np.array_equal(got, label_components_exact(tern)[0].numpy())
    assert len(np.unique(got[got != INVALID])) > 3


# -- B7: tiles ---------------------------------------------------------------

TILE_ROWS, TILE_COLS = 8, 128


def _same_count(st: torch.Tensor) -> torch.Tensor:
    """Same-valued 8-neighbors of every interior position of a staged
    tile (rows and columns 1 .. -2)."""
    v = st[1:-1, 1:-1]
    n = torch.zeros_like(v, dtype=torch.int32)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                n += (st[1 + dy:st.shape[0] - 1 + dy,
                         1 + dx:st.shape[1] - 1 + dx] == v).to(torch.int32)
    return n


def b7_model(tern: torch.Tensor, labels: torch.Tensor, halo_top: int,
             halo_bottom: int, y_offset: int):
    """B7's output pages as its tiles write them."""
    b, hext, w = tern.shape
    hc = hext - halo_top - halo_bottom
    pages = torch.full((3, b, 2, hc, w), -7, dtype=torch.int32)
    t = tern.to(torch.int32)
    lab = labels.to(torch.int32)
    vec = w % 4 == 0
    for bi in range(b):
        for yc0 in range(0, hc, TILE_ROWS):
            for x0 in range(0, w, TILE_COLS):
                ys = halo_top + yc0
                # staged tern: rows ys - 1 .. ys + 9, columns x0 - 1 .. x0 + 129
                st = torch.full((TILE_ROWS + 3, TILE_COLS + 3), 127,
                                dtype=torch.int32)
                rows = [(r, ys - 1 + r) for r in range(TILE_ROWS + 3)
                        if 0 <= ys - 1 + r < hext]
                cols = [(c + 1, x0 + c) for c in range(-1, TILE_COLS + 2)
                        if 0 <= x0 + c < w]
                for r, y in rows:
                    st[r, cols[0][0]:cols[-1][0] + 1] = t[
                        bi, y, cols[0][1]:cols[-1][1] + 1]
                sl = torch.zeros((TILE_ROWS + 1, TILE_COLS + 1),
                                 dtype=torch.int32)
                for r in range(TILE_ROWS + 1):
                    if ys + r < hext:
                        xs = min(w, x0 + TILE_COLS + 1)
                        sl[r, :xs - x0] = lab[bi, ys + r, x0:xs]
                solid = _same_count(st) >= 2  # [rows 1.., cols 0..]
                for tr in range(TILE_ROWS):
                    yc = yc0 + tr
                    if yc >= hc:
                        break
                    down_in = ys + tr + 1 < hext
                    for c0 in range(0, TILE_COLS, 4):
                        x = x0 + c0
                        if x >= w:
                            break
                        for j in range(4):
                            if not vec and x + j >= w:
                                continue
                            c = c0 + j
                            v = int(st[tr + 1, c + 1])
                            lv = int(sl[tr, c])
                            white = v == 255
                            for di in range(2):
                                dy, dx = di, 1 - di
                                inside = down_in if di else x + j + 1 < w
                                nv = int(st[tr + 1 + dy, c + 1 + dx]) if inside else 127
                                nl = int(sl[tr + dy, c + dx]) if inside else 0
                                nsolid = inside and bool(solid[tr + dy, c + dx])
                                edge = v + nv == 255 and bool(solid[tr, c]) and nsolid
                                pages[0, bi, di, yc, x + j] = (nl if white else lv) if edge else INVALID
                                pages[1, bi, di, yc, x + j] = (lv if white else nl) if edge else INVALID
                                pages[2, bi, di, yc, x + j] = (
                                    ((2 * (x + j) + dx) & 0x1FFF)
                                    | (((2 * (yc + y_offset) + dy) & 0x1FFF) << 13)
                                    | (di << 26) | (int(white) << 28))
    return tuple(p.reshape(b, 2 * hc * w) for p in pages)


@pytest.mark.parametrize("shape,top,bottom,y_offset", [
    ((1, 19, 140), 1, 2, 984),     # a second tile of columns, ragged
    ((2, 13, 37), 1, 2, 5),        # W % 4 != 0: stores pixel by pixel
    ((1, 11, 36), 0, 0, 0),        # whole frame, W % 16 != 0
    ((1, 12, 130), 2, 1, 4096 - 9),  # y_offset at the 13-bit limit
    ((1, 4, 64), 1, 2, 1),         # one core row
])
def test_tile_model_equals_the_band_twin(shape, top, bottom, y_offset):
    rng = np.random.default_rng(sum(shape))
    tern = torch.from_numpy(blob_tern(shape, shape[2]))
    labels = torch.from_numpy(np.where(
        tern.numpy() == 127, INVALID,
        rng.integers(0, 1 << 30, shape)).astype(np.int32))
    want = extract_candidates_band_plain(tern, labels, top, bottom, y_offset)
    got = b7_model(tern, labels, top, bottom, y_offset)
    for g, wnt, name in zip(got, want, ("black", "white", "payload")):
        assert torch.equal(g, wnt), name


def test_tile_model_on_the_frame_edge_bands():
    """The first and last bands of a frame, padded as the row-banded step
    pads them (127 tern and ``INVALID`` labels outside the frame), equal
    the whole frame's rows."""
    from chalkydri_tpu_torch.detector.cluster import extract_boundary_points

    tern = torch.from_numpy(blob_tern((1, 32, 132), 9))
    labels = label_components_exact(tern)
    whole = extract_boundary_points(tern, labels)
    t_pad = torch.nn.functional.pad(tern, (0, 0, 1, 2), value=127)
    l_pad = torch.nn.functional.pad(labels, (0, 0, 1, 2), value=INVALID)
    for j in (0, 3):
        rows = slice(8 * j, 8 * j + 11)
        got = b7_model(t_pad[:, rows], l_pad[:, rows], 1, 2, 8 * j)
        for g, wh in zip(got, whole):
            assert torch.equal(g.reshape(1, 2, 8, 132),
                               wh.reshape(1, 2, 32, 132)[:, :, 8 * j:8 * j + 8])
