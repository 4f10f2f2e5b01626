"""The decompositions behind kernels B1 and B2 on the card, as plain-torch
models held bit for bit to the plain twins (and B2's to the JAX package's
Pallas kernel in interpret mode); no card needed.

B1 (``csrc/ccl_extract.cu``, the cluster route): one frame per cluster of
C CTAs, CTA k a band of whole tile rows. The model keeps each band's
words (label << 11 | speckle-gate bit | 2-bit code | 8 link bits) apart, thresholds each
band from its own and its neighbors' tile rows, runs the rounds in place
as the kernel does (waves of rows whose last row is stored one wave late,
band top and bottom rows stored only after every band's row pass, the
bands taken in a different order each round) and joins the column runs
across bands from per-column head and tail summaries. Also the route
function: every frame the detector sends B1 takes the cluster route.

B2 (``csrc/segment_stats.cu``): tiles of 1024 rows whose prefix counts
come from a decoupled look-back over status words (some tiles publish
their inclusive prefix late, words of an older call lie around), the next
run start after a tile's last run from a forward scan 128 rows a step,
and the chunk top-2 by packed maxima.

Exact equality throughout; no tolerance is involved."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chalkydri_tpu.ops.pallas.segment_kernel import segment_stats_pallas
from chalkydri_tpu_torch.detector.pipeline import EXTRACT_BLOCK_MAX_PIXELS
from chalkydri_tpu_torch.detector.segment import (
    INVALID,
    label_components,
    rounds_needed,
)
from chalkydri_tpu_torch.detector.threshold import adaptive_threshold
from chalkydri_tpu_torch.ops.ccl_extract import (
    CLUSTER_MAX_PIXELS,
    SHARED_BYTES,
    cluster_bytes,
    cluster_size,
    threshold_ccl_extract_plain,
    threshold_ccl_extract_rounds,
)
from chalkydri_tpu_torch.ops.segment_stats import segment_stats_plain
from chalkydri_tpu_torch.tools.scenes import (
    CCL_STRESS_SHAPES,
    blob_tern,
    mixed_terns,
    serpentine,
)

torch.set_num_threads(1)

CAP = 12
THREADS = 1024  # a CTA of the cluster kernel
SKIP = 1  # ternary codes: 0 black, 1 skip, 2 white
NONE = 2 ** 31 - 1


# -- B1: the route ----------------------------------------------------------

def test_cluster_route_covers_the_detectors_frames():
    """Every frame the detector sends B1 (h * w <= 540,000, sides multiples
    of 4 up to 4096) takes the cluster route, with bands that fit a CTA's
    shared memory and at least one tile row each; larger frames take the
    chain of launches."""
    assert CLUSTER_MAX_PIXELS == EXTRACT_BLOCK_MAX_PIXELS
    worst = 0
    for w in range(4, 4097, 4):
        for h in range(4, min(4096, CLUSTER_MAX_PIXELS // w) + 1, 4):
            c = cluster_size(2, h, w)
            assert c is not None and c <= h // 4, (h, w)
            worst = max(worst, cluster_bytes(h, w, c))
    assert worst <= SHARED_BYTES
    named = {(400, 640): 16, (652, 800): 16, (52, 200): 8, (8, 4096): 2,
             (4096, 8): 16}
    for (h, w), c in named.items():
        assert cluster_size(4, h, w) == c
        assert cluster_bytes(h, w, c) <= SHARED_BYTES
    for h, w in ((800, 1280), (1304, 1600), (4096, 4096), (656, 824)):
        assert cluster_size(1, h, w) is None


# -- B1: the banded model -----------------------------------------------------

def band_rows(h: int, c: int):
    """Frame rows [y0, y1) of each of c bands of whole tile rows."""
    th = h // 4
    return [(4 * (k * th // c), 4 * ((k + 1) * th // c)) for k in range(c)]


def band_threshold(gray: torch.Tensor, c: int) -> torch.Tensor:
    """[H, W] uint8 -> tern, each band from the tile rows it holds and the
    one above and below it (255 / 0 outside the frame), as the kernel."""
    h, w = gray.shape
    tw = w // 4
    g = gray.to(torch.int32)
    out = []
    for y0, y1 in band_rows(h, c):
        t0, t1 = y0 // 4 - 1, y1 // 4 + 1  # halo tile rows
        tmin = torch.full((t1 - t0, tw), 255, dtype=torch.int32)
        tmax = torch.zeros((t1 - t0, tw), dtype=torch.int32)
        for i, ty in enumerate(range(t0, t1)):
            if 0 <= ty < h // 4:
                tiles = g[4 * ty:4 * ty + 4].reshape(4, tw, 4)
                tmin[i] = tiles.amin(dim=(0, 2))
                tmax[i] = tiles.amax(dim=(0, 2))
        pmin = F.pad(tmin, (1, 1), value=255)
        pmax = F.pad(tmax, (1, 1), value=0)
        n = t1 - t0 - 2
        dmin = torch.stack([pmin[dy:dy + n, dx:dx + tw] for dy in range(3)
                            for dx in range(3)]).amin(0)
        dmax = torch.stack([pmax[dy:dy + n, dx:dx + tw] for dy in range(3)
                            for dx in range(3)]).amax(0)
        dmin = dmin.repeat_interleave(4, 0).repeat_interleave(4, 1)
        dmax = dmax.repeat_interleave(4, 0).repeat_interleave(4, 1)
        contrast = dmax - dmin
        v = torch.where(g[y0:y1] > dmin + contrast // 2, 255, 0)
        out.append(torch.where(contrast < 5, 127, v))
    return torch.cat(out).to(torch.uint8)


LOW = (1 << 11) - 1  # solid, code and link bits below the label
OUTSIDE = (0xFFFFF << 11) | (SKIP << 8)  # past the frame: links nothing
UP, DOWN, LEFT, RIGHT = 8, 4, 2, 1


def words_of(tern: torch.Tensor) -> torch.Tensor:
    """[H, W] tern -> int64 words as the kernel packs them: label << 11 |
    solid << 10 | code << 8 | links (the flat label, 0xFFFFF on skip
    pixels; links: ccl_common's connectivity bits; solid: at least 2
    same-valued 8-neighbors)."""
    h, w = tern.shape
    code = torch.where(tern == 255, 2, torch.where(tern == 127, SKIP, 0))
    code = code.long()
    p = F.pad(code, (1, 1, 1, 1), value=SKIP)

    def nb(dy, dx):
        return p[1 + dy:h + 1 + dy, 1 + dx:w + 1 + dx]

    offsets = ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1),
               (-1, -1))
    links = torch.zeros_like(code)
    same = torch.zeros_like(code)
    for bit, (dy, dx) in enumerate(offsets):
        eq = nb(dy, dx) == code
        same += eq
        if bit >= 4:
            eq &= code == 2
        links |= eq.long() << bit
    links = torch.where(code == SKIP, 0, links)
    flat = torch.arange(h * w, dtype=torch.int64).reshape(h, w)
    label = torch.where(code == SKIP, 0xFFFFF, flat)
    return (label << 11) | ((same >= 2).long() << 10) | (code << 8) | links


def _label(x):
    return x & ~LOW


def _prefix_min(x, starts, dim):
    """Running minimum of x since the last start along ``dim``."""
    seg = torch.cumsum(starts.long(), dim)
    return NONE - (torch.cummax((seg << 31) | (NONE - x), dim).values & NONE)


def _wave(ext):
    """Rows a - 1 .. e of a band (the old words) -> the new words of rows
    a .. e - 1 after the neighbor-min and the row-run min by the link bits,
    each keeping its own low bits. As in the kernel, the neighbor-min
    leaves out the left and right neighbors: a pixel links to them only
    inside its row run, whose minimum is taken next."""
    n2, w = ext.shape
    p = F.pad(ext, (1, 1), value=OUTSIDE)
    c = p[1:-1, 1:-1]
    m = c
    offsets = ((0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (1, -1), (-1, 1),
               (-1, -1))
    for bit, (dy, dx) in enumerate(offsets):
        if dy == 0:  # left and right: in the row run, whose minimum follows
            continue
        nb = p[1 + dy:n2 - 1 + dy, 1 + dx:w + 1 + dx]
        m = torch.where((c >> bit) & 1 == 1, torch.minimum(m, nb), m)
    fwd = _prefix_min(m, c & LEFT == 0, 1)
    bwd = _prefix_min(m.flip(1), (c & RIGHT == 0).flip(1), 1).flip(1)
    return _label(torch.minimum(fwd, bwd)) | (c & LOW)


def _fold(carry, tail, has_start):
    return torch.where(has_start, tail, torch.minimum(carry, tail))


def model_round(bands, order):
    """One round over the bands (each CTA's words, changed in place), the
    bands taken in ``order`` in every phase between two cluster barriers."""
    c, w = len(bands), bands[0].shape[1]
    skip_row = torch.full((w,), OUTSIDE, dtype=torch.int64)
    rt = -(-(w // 4) // 32) * 32
    g_rows = THREADS // rt  # rows a wave
    held = {}
    for k in order:  # neighbor-min + row-run min, in waves
        arr, r_k = bands[k], bands[k].shape[0]
        above = bands[k - 1][-1] if k > 0 else skip_row
        below = bands[k + 1][0] if k < c - 1 else skip_row
        deferred = None
        for a in range(0, r_k, g_rows):
            e = min(a + g_rows, r_k)
            ext = torch.cat([(arr[a - 1] if a else above)[None], arr[a:e],
                             (arr[e] if e < r_k else below)[None]])
            new = _wave(ext)
            if deferred is not None:  # the wave before's last row
                arr[deferred[0]] = deferred[1]
                deferred = None
            for i in range(a, e):
                if i == 0:
                    held[k, 0] = new[0]
                if i == r_k - 1:
                    held[k, 1] = new[i - a]
                if i not in (0, r_k - 1):
                    if i == a + g_rows - 1:
                        deferred = (i, new[i - a])
                    else:
                        arr[i] = new[i - a]
        assert deferred is None
    for k in range(c):  # after the barrier: the band's top and bottom rows
        bands[k][0], bands[k][-1] = held[k, 0], held[k, 1]

    summary = {}
    for k in order:  # in-band column scan and summaries
        arr, r_k = bands[k], bands[k].shape[0]
        starts = arr & UP == 0
        ends = torch.zeros_like(starts)
        ends[:-1] = starts[1:]
        ends[-1] = arr[-1] & DOWN == 0
        prefix = _prefix_min(arr, starts, 0)
        has_start = starts.any(0)
        first_start = torch.where(has_start, starts.int().argmax(0), r_k)
        head = _label(prefix.gather(0, ends.int().argmax(0)[None])[0])
        summary[k] = dict(tail=_label(prefix[-1]), has_start=has_start,
                          top_starts=first_start == 0, head=head,
                          has_end=ends.any(0), first_start=first_start,
                          ends=ends)
        arr[:] = _label(prefix) | (arr & LOW)
    for k in order:  # carries from the other bands' summaries
        arr, r_k, s = bands[k], bands[k].shape[0], summary[k]
        carry = torch.full((w,), NONE, dtype=torch.int64)
        for j in range(k):
            carry = _fold(carry, summary[j]["tail"], summary[j]["has_start"])
        carry_in = carry
        carry = _fold(carry, s["tail"], s["has_start"])
        out = torch.full((w,), NONE, dtype=torch.int64)
        done = torch.zeros(w, dtype=torch.bool)
        for j in range(k + 1, c):
            sj = summary[j]
            v = torch.where(sj["top_starts"], sj["head"],
                            torch.minimum(sj["head"], carry))
            out = torch.where(sj["has_end"] & ~done, v, out)
            done |= sj["has_end"]
            carry = _fold(carry, sj["tail"], sj["has_start"])
        out = torch.where(arr[-1] & DOWN != 0, out, NONE)
        rows = torch.arange(r_k)[:, None]
        f = torch.where(rows < s["first_start"],
                        torch.minimum(_label(arr), carry_in), _label(arr))
        end_at = torch.where(s["ends"], rows, r_k).flip(0).cummin(0).values
        end_at = end_at.flip(0)  # each row's run end in the band, or r_k
        bands[k] = torch.where(end_at < r_k,
                               f.gather(0, end_at.clamp(max=r_k - 1)),
                               out) | (arr & LOW)


def model_labels(tern: torch.Tensor, iters: int, c: int):
    """[B, H, W] tern -> (labels [B, H, W] int32, rounds run [B]) by the
    banded rounds of C bands, each frame stopped after the round that
    changed none of its words."""
    labels, ran = [], []
    for t in tern:
        words = words_of(t)
        bands = [words[y0:y1].clone() for y0, y1 in band_rows(t.shape[0], c)]
        r = 0
        while r < iters:
            before = torch.cat(bands)
            order = range(c) if r % 2 == 0 else range(c - 1, -1, -1)
            model_round(bands, list(order))
            r += 1
            if torch.equal(torch.cat(bands), before):
                break
        out = torch.cat(bands)
        skip = (out >> 8) & 3 == SKIP
        labels.append(torch.where(skip, INVALID, out >> 11))
        ran.append(r)
    return torch.stack(labels).to(torch.int32), ran


def _check_model(tern: np.ndarray, iters: int, c: int):
    t = torch.from_numpy(tern)
    got, ran = model_labels(t, iters, c)
    assert torch.equal(got, label_components(t, iters=iters))
    want = (rounds_needed(t, iters) + 1).clamp(max=iters)
    assert ran == want.tolist()
    return ran


# the stress shapes that B1 takes (sides multiples of 4), each cut into
# C = 1, 2, 8 and 13 bands where it has that many tile rows
STRESS_BANDS = [(s, c) for s in CCL_STRESS_SHAPES
                if s[1] % 4 == 0 and s[2] % 4 == 0
                for c in (1, 2, 8, 13) if c <= s[1] // 4]


@pytest.mark.parametrize("shape,c", STRESS_BANDS,
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else f"C{v}")
def test_banded_rounds_equal_the_twin_at_stress_shapes(shape, c):
    """Bands with in-place Jacobi updates and column carries across band
    edges: the twin's labels bit for bit (4096-row strips cross all 13
    bands, 4096-pixel rows take one row a wave)."""
    _check_model(blob_tern(shape, 1), CAP, c)


@pytest.mark.parametrize("c", [2, 8, 13])
def test_banded_rounds_on_serpentine_where_the_cap_binds(c):
    """The snake's stripes cross every band; its minimum label moves one
    stripe a round, so each cap binds."""
    ran = [_check_model(serpentine()[None], iters, c)[0]
           for iters in (0, 1, 11, 12, 13)]
    assert ran == [0, 1, 11, 12, 13]


def test_banded_rounds_stop_each_frame_at_its_fixed_point():
    ran = _check_model(mixed_terns(64, 128, 20, 3), CAP, 8)
    assert ran == [2, 5, CAP, CAP]


@pytest.mark.parametrize("shape,c", [((52, 200), 13), ((400, 640), 8),
                                     ((96, 4096), 16)])
def test_banded_threshold_equals_the_twin(shape, c):
    """Each band thresholded from its own tile rows and the one above and
    below it gives the whole frame's ternary image."""
    rng = np.random.default_rng(3)
    gray = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))
    gray[:, : shape[1] // 3] //= 16  # low-contrast tiles: skip pixels
    assert torch.equal(band_threshold(gray, c),
                       adaptive_threshold(gray[None])[0])


def test_rounds_wrapper_counts_needed_plus_confirming_round():
    """On CPU tensors ``threshold_ccl_extract_rounds`` runs the twin and
    counts the rounds the kernel runs: needed + 1, at most ``iters``."""
    gray = torch.from_numpy(np.stack([serpentine()] * 2))
    for iters in (0, 1, 12, 13):
        pages, ran = threshold_ccl_extract_rounds(gray, iters)
        for got, want in zip(pages, threshold_ccl_extract_plain(gray, iters)):
            assert torch.equal(got, want)
        assert ran.dtype == torch.int32
        assert ran.tolist() == [min(19 + 1, iters)] * 2


# -- B2: the single-pass model ------------------------------------------------

TILE, CHUNK, STEP = 1024, 128, 128


def _status(seq, state, value):
    return (seq, state, value)


def b2_model(key: np.ndarray, payload: np.ndarray, rng):
    """One frame's (t, cand_len, cand_pos) as the kernel computes them.
    Returns them and the rows each forward scan read."""
    n = len(key)
    ntiles = -(-n // TILE)
    seq = 7
    # words of an older call lie in the status array
    status = [_status(seq - 1, 2, int(v)) for v in rng.integers(0, 99, ntiles)]
    prev = np.concatenate([[-1], key[:-1]])
    start = key != prev
    valid = key != NONE
    d0 = valid & (((payload >> 26) & 3) == 0)
    t = np.zeros(n, np.int64)
    next_start = np.full(n, n, np.int64)
    scanned = []
    late = None  # a tile whose inclusive prefix is published one tile late
    for k in range(ntiles):
        lo, hi = k * TILE, min((k + 1) * TILE, n)
        agg = int(d0[lo:hi].sum())
        before = 0
        if k == 0:
            status[k] = _status(seq, 2, agg)
        else:
            status[k] = _status(seq, 1, agg)
            j = k - 1
            while True:  # 32 predecessors at a time
                window = [status[i] if i >= 0 else _status(seq, 2, 0)
                          for i in range(j, j - 32, -1)]
                assert all(w[0] == seq and w[1] for w in window)  # ready
                stop = next((i for i, w in enumerate(window) if w[1] == 2),
                            None)
                before += sum(w[2] for w in window[:(stop if stop is not None
                                                     else 31) + 1])
                if stop is not None:
                    break
                j -= 32
        if late is not None:
            status[late[0]] = late[1]
            late = None
        prefix = _status(seq, 2, before + agg)
        if rng.random() < 0.5 and k + 1 < ntiles:
            late = (k, prefix)
        else:
            status[k] = prefix
        t[lo:hi] = before + np.cumsum(d0[lo:hi])
        # the next run start after each row, inside the tile
        starts = np.flatnonzero(start[lo:hi]) + lo
        nxt = n
        if starts.size and valid[hi - 1] and hi < n:  # forward scan
            base = hi
            while base < n:
                diff = np.flatnonzero(key[base:base + STEP] != key[hi - 1])
                scanned.append(min(STEP, n - base))
                if diff.size:
                    nxt = base + int(diff[0])
                    break
                base += STEP
        for i in range(hi - 1, lo - 1, -1):
            next_start[i] = nxt
            if start[i]:
                nxt = i
    score = np.where(start & valid, next_start - np.arange(n), 0)
    grid = score.reshape(-1, CHUNK)
    lanes = np.arange(CHUNK)
    best1 = ((grid << 7) | (127 - lanes)).max(1)
    a1 = 127 - (best1 & 127)
    grid2 = np.where(lanes == a1[:, None], 0, grid)
    best2 = ((grid2 << 7) | (127 - lanes)).max(1)
    a2 = 127 - (best2 & 127)
    base = np.arange(grid.shape[0]) * CHUNK
    cand_len = np.concatenate([best1 >> 7, best2 >> 7])
    cand_pos = np.concatenate([base + a1, base + a2])
    return (t.astype(np.int32), cand_len.astype(np.int32),
            cand_pos.astype(np.int32)), scanned


def _b2_layouts(n, rng):
    """One run over everything, all invalid, single-element runs, and
    sorted runs of up to 3,000 rows (crossing 3 or more tiles) with an
    invalid tail."""
    lengths = rng.integers(1, 3000, 40)
    lengths[1] = 2 * TILE + 300  # one run over three tile boundaries
    runs = np.repeat(np.sort(rng.choice(1 << 30, 40, replace=False)), lengths)
    runs = runs[:n - 100].astype(np.int32)
    return {
        "one_run": np.full(n, 7, np.int32),
        "all_invalid": np.full(n, NONE, np.int32),
        "single_element_runs": np.arange(n, dtype=np.int32),
        "long_runs_invalid_tail": np.concatenate(
            [runs, np.full(n - len(runs), NONE, np.int32)]),
    }


@pytest.mark.parametrize("n", [4096, 3200])
def test_single_pass_segment_stats_equal_twin_and_pallas(n):
    """Look-back carries and the forward run-end scan give the twin's
    output and the Pallas kernel's, at a row count that fills its tiles
    and one that ends inside a tile (3,200 = 3 tiles + 128 rows)."""
    rng = np.random.default_rng(n)
    layouts = _b2_layouts(n, rng)
    keys = np.stack(list(layouts.values()))
    payloads = rng.integers(0, 1 << 29, keys.shape).astype(np.int32)
    twin = segment_stats_plain(torch.from_numpy(keys),
                               torch.from_numpy(payloads))
    for row, name in enumerate(layouts):
        got, scanned = b2_model(keys[row], payloads[row], rng)
        want = segment_stats_pallas(jnp.asarray(keys[row]),
                                    jnp.asarray(payloads[row]),
                                    interpret=True)
        for field, g, tw, pw in zip(("t", "cand_len", "cand_pos"), got, twin,
                                    want):
            np.testing.assert_array_equal(g, tw[row].numpy(),
                                          err_msg=f"{name}: {field}")
            np.testing.assert_array_equal(g, np.asarray(pw),
                                          err_msg=f"{name}: {field}")
        # a scan reads at most the run it ends, a step past its end
        longest = max(np.diff(np.flatnonzero(
            np.concatenate([[True], keys[row][1:] != keys[row][:-1],
                            [True]]))))
        assert sum(scanned) <= len(scanned) * (longest + STEP)
        if name == "long_runs_invalid_tail":
            assert scanned, "no run crossed a tile"
        if name == "all_invalid":
            assert not scanned
