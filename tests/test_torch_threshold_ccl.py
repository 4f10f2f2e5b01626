"""Kernels B3, B4 and B5: their plain twins against the JAX package's
Pallas kernels in interpret mode, bit for bit.

B3 ``threshold_ccl`` and B4 ``label_components_ccl`` stop after ``iters``
rounds, as ``threshold_ccl_pallas`` and ``label_components_pallas`` do, so
they are compared on any input, including one where the round cap binds.
B5 ``threshold_ccl_exact`` computes the global fixed point that
``threshold_ccl_blocked``'s seam merges converge to; it is compared where
the JAX side certifies that fixed point (``segment.labels_converged``).

The CUDA kernels are compared with the same twins on the GPU by
``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chalkydri_tpu.detector import load_family as jax_load_family
from chalkydri_tpu.detector.segment import labels_converged as jax_converged
from chalkydri_tpu.ops.pallas.ccl_kernel import (
    label_components_pallas,
    threshold_ccl_blocked,
    threshold_ccl_pallas,
)
from chalkydri_tpu_torch.detector.segment import INVALID, padded_width
from chalkydri_tpu_torch.ops.threshold_ccl import (
    label_components_ccl,
    threshold_ccl,
    threshold_ccl_exact,
)
from tests.reference_impl.render import axis_aligned_corners, simple_scene

torch.set_num_threads(1)

FAM = jax_load_family("tag36h11")


def _serpentine_gray(h, w, stripes):
    """A white snake on black: vertical 1-px stripes joined alternately at
    the top and bottom row, close enough that every tile neighborhood has
    contrast, so it thresholds to exactly this 0/255 pattern. The minimum
    label moves about one stripe per round."""
    g = np.zeros((h, w), np.uint8)
    cols = np.linspace(2, w - 3, stripes).astype(int)
    g[:, cols] = 255
    for i in range(len(cols) - 1):
        g[0 if i % 2 == 0 else h - 1, cols[i]:cols[i + 1] + 1] = 255
    return g[None]


def _certified(tern, labels) -> bool:
    """The JAX package's ``labels_converged`` on a [1, 96, 256] canvas
    that holds the frame in its corner, skip (127) around it: skip pixels
    connect to nothing, so the canvas converged iff the frame did, and all
    cases share one compiled check."""
    h, w = tern.shape[1:]
    t = np.full((1, 96, 256), 127, np.uint8)
    lab = np.full((1, 96, 256), INVALID, np.int32)
    t[:, :h, :w] = np.asarray(tern)
    lab[:, :h, :w] = np.asarray(labels)
    return bool(jax_converged(jnp.asarray(t), jnp.asarray(lab)))


def _tag_scene(noise):
    """The scene of the JAX package's own Pallas CCL tests."""
    canvas, _ = simple_scene(FAM, [(5, axis_aligned_corners(320, 240, 90))],
                             noise=noise)
    return canvas[None]


def _assert_b3_b4_equal(gray):
    want_tern, want_lab = threshold_ccl_pallas(jnp.asarray(gray), iters=12,
                                               interpret=True)
    tern, labels = threshold_ccl(torch.from_numpy(gray), iters=12)
    np.testing.assert_array_equal(tern.numpy(), np.asarray(want_tern))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want_lab))
    want_b4 = label_components_pallas(want_tern, iters=12, interpret=True)
    got_b4 = label_components_ccl(tern, iters=12)
    assert got_b4.dtype == torch.int32
    np.testing.assert_array_equal(got_b4.numpy(), np.asarray(want_b4))
    return want_tern, want_lab


@pytest.mark.parametrize("noise", [0.0, 8.0])
def test_b3_b4_match_pallas_on_tag_scene(noise):
    _assert_b3_b4_equal(_tag_scene(noise))


def test_b3_b4_match_pallas_where_round_cap_binds():
    tern, labels = _assert_b3_b4_equal(_serpentine_gray(64, 128, 20))
    assert not _certified(tern, labels)


def _assert_b5_equal(gray, **blocked):
    """B5's twin against ``threshold_ccl_blocked`` where the JAX side
    reached its certified fixed point."""
    want_tern, want_lab = threshold_ccl_blocked(jnp.asarray(gray),
                                                interpret=True, **blocked)
    assert _certified(want_tern, want_lab)
    tern, labels = threshold_ccl_exact(torch.from_numpy(gray))
    np.testing.assert_array_equal(tern.numpy(), np.asarray(want_tern))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want_lab))
    return labels


def test_b5_matches_blocked_pallas_on_padded_scene():
    """52x200: rows cross block seams, and the labels' row pitch is the
    lane-padded 256."""
    canvas, _ = simple_scene(FAM, [(2, axis_aligned_corners(100, 26, 36))],
                             size=(52, 200), noise=8.0)
    labels = _assert_b5_equal(canvas[None], iters=16, block_rows=24,
                              merge_rounds=16)
    assert padded_width(200) == 256
    valid = labels[labels != INVALID]
    assert int((valid % 256).max()) < 200


@pytest.mark.parametrize("kind", ["flat", "gradient"])
def test_b5_matches_blocked_pallas_on_flat_and_gradient(kind):
    frame = (np.full((1, 32, 136), 150, np.uint8) if kind == "flat" else
             np.tile(np.linspace(0, 255, 136).astype(np.uint8), (32, 1))[None])
    _assert_b5_equal(frame, iters=8, block_rows=16, merge_rounds=8)


def test_b5_matches_blocked_pallas_on_serpentine():
    """The 96x128 snake across twelve 8-row blocks (the serpentine of the
    JAX package's hybrid-merge test, rendered as gray): its minimum label
    zig-zags across every seam."""
    _assert_b5_equal(_serpentine_gray(96, 128, 32), iters=16, block_rows=8)


def test_b5_labels_the_whole_snake_where_b3_is_capped():
    gray = torch.from_numpy(_serpentine_gray(64, 128, 20))
    tern, capped = threshold_ccl(gray, iters=12)
    tern_x, exact = threshold_ccl_exact(gray)
    assert torch.equal(tern, tern_x)
    snake = gray == 255
    # W = 128 = padded width, so both label the same flat index space
    assert not torch.equal(exact, capped)
    assert len(torch.unique(exact[snake])) == 1
    assert len(torch.unique(capped[snake])) > 1


def test_wrappers_count_only_kernel_launches():
    gray = torch.from_numpy(_serpentine_gray(64, 128, 20))
    before = (threshold_ccl.launches, label_components_ccl.launches,
              threshold_ccl_exact.launches)
    tern, _ = threshold_ccl(gray, iters=2)
    label_components_ccl(tern, iters=2)
    threshold_ccl_exact(gray)
    assert (threshold_ccl.launches, label_components_ccl.launches,
            threshold_ccl_exact.launches) == before  # CPU: plain twins


@pytest.mark.parametrize("fn", [threshold_ccl, label_components_ccl,
                                threshold_ccl_exact])
def test_wrappers_reject_other_devices(fn):
    with pytest.raises(ValueError, match="unsupported device"):
        fn(torch.zeros((1, 8, 8), dtype=torch.uint8, device="meta"))
