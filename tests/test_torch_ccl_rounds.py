"""The capped CCL rounds of kernels B1, B3 and B4: the plain twin
``segment.label_components`` against the JAX package at every shape and
round cap that ``chip_smoke.py`` holds the CUDA kernels to on the card, so
the card's yardstick is itself held to JAX; ``segment.rounds_needed``
against the JAX package's ``labels_converged``; and the premise of the
kernels' exit at the fixed point (a round that changes nothing is the last
that could change anything).

The JAX side is ``label_components_pallas`` in interpret mode, which stops
at the fixed point as the TPU kernel does. Exact equality throughout; no
tolerance is involved. The inputs come from ``tools/scenes.py``, where the
card run takes them too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chalkydri_tpu.detector import load_family as jax_load_family
from chalkydri_tpu.detector.segment import labels_converged as jax_converged
from chalkydri_tpu.ops.pallas.ccl_kernel import label_components_pallas
from chalkydri_tpu_torch.detector.segment import (
    INVALID,
    label_components,
    labels_converged,
    rounds_needed,
)
from chalkydri_tpu_torch.detector.threshold import adaptive_threshold
from chalkydri_tpu_torch.ops.threshold_ccl import label_components_ccl_rounds
from chalkydri_tpu_torch.tools.scenes import (
    CCL_STRESS_SHAPES,
    blob_tern,
    mixed_terns,
    serpentine,
)
from tests.reference_impl.render import axis_aligned_corners, simple_scene

torch.set_num_threads(1)

FAM = jax_load_family("tag36h11")
CAP = 12


def _assert_twin_equals_pallas(tern: np.ndarray, iters: int):
    want = label_components_pallas(jnp.asarray(tern), iters=iters,
                                   interpret=True)
    got = label_components(torch.from_numpy(tern), iters=iters)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    return got


@pytest.mark.parametrize("shape", CCL_STRESS_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_twin_matches_pallas_at_stress_shapes(shape):
    """Widths that are no multiple of 32, 8 or 4, a 4096-row strip and
    4096-pixel rows: the shapes that stress the kernels' index math."""
    _assert_twin_equals_pallas(blob_tern(shape, 1), CAP)


@pytest.mark.parametrize("iters", [0, 1, 11, 12, 13])
def test_twin_matches_pallas_on_serpentine_at_cap(iters):
    """The 20-stripe snake needs 19 rounds, so each of these caps binds."""
    _assert_twin_equals_pallas(serpentine()[None], iters)


def test_twin_matches_pallas_on_mixed_batch():
    """Frames that reach their fixed points at different rounds (the Pallas
    grid leaves its loop per frame, the CUDA kernels skip per frame)."""
    tern = mixed_terns(64, 128, 20, 3)
    _assert_twin_equals_pallas(tern, CAP)
    needed = rounds_needed(torch.from_numpy(tern), 40).tolist()
    assert needed[0] == 1 and needed[1] == 4
    assert needed[2] > CAP and needed[3] == 19


def test_twin_matches_pallas_where_every_round_binds():
    """A small cut of the card run's worst case: four snakes that 12
    rounds do not finish."""
    tern = np.stack([serpentine(48, 160, 30)] * 2)
    labels = _assert_twin_equals_pallas(tern, CAP)
    assert not labels_converged(torch.from_numpy(tern), labels)
    assert rounds_needed(torch.from_numpy(tern), CAP).tolist() == [CAP] * 2


def _tag_tern(noise: float) -> np.ndarray:
    """One thresholded tag, the scene of the JAX package's CCL tests cut
    to a 96x128 frame."""
    canvas, _ = simple_scene(FAM, [(5, axis_aligned_corners(64, 48, 60))],
                             size=(96, 128), noise=noise)
    return adaptive_threshold(torch.from_numpy(canvas[None])).numpy()


def _premise_inputs():
    rng = np.random.default_rng(22)
    noise = adaptive_threshold(torch.from_numpy(
        rng.integers(0, 256, (1, 16, 24), dtype=np.uint8))).numpy()
    return {"tag": _tag_tern(0.0), "tag_noisy": _tag_tern(8.0),
            "noise": noise, "flat": np.full((1, 32, 136), 255, np.uint8),
            "serpentine": serpentine(64, 128, 9)[None]}


PREMISE = _premise_inputs()


def _jax_converged(tern: np.ndarray, labels: torch.Tensor) -> bool:
    """The JAX package's ``labels_converged`` on a [1, 96, 256] canvas that
    holds the frame in its corner, skip (127) around it: skip pixels
    connect to nothing, so the canvas converged iff the frame did, and all
    cases share one compiled check."""
    h, w = tern.shape[1:]
    t = np.full((1, 96, 256), 127, np.uint8)
    lab = np.full((1, 96, 256), INVALID, np.int32)
    t[:, :h, :w] = tern
    lab[:, :h, :w] = labels.numpy()
    return bool(jax_converged(jnp.asarray(t), jnp.asarray(lab)))


@pytest.mark.parametrize("name", list(PREMISE))
def test_rounds_needed_is_where_jax_certifies_the_fixed_point(name):
    """``rounds_needed`` is the first round count whose labels the JAX
    package's ``labels_converged`` accepts, and it accepts every later
    one."""
    tern = PREMISE[name]
    t = torch.from_numpy(tern)
    needed = int(rounds_needed(t, 40)[0])
    assert needed < 40
    for k in range(needed + 3):
        assert _jax_converged(tern, label_components(t, iters=k)) == (
            k >= needed), (name, k, needed)


@pytest.mark.parametrize("name", list(PREMISE))
def test_a_round_that_changes_nothing_is_the_last_to_matter(name):
    """What the kernels' exit rests on: after the first round that changes
    no label, one more changes none either, and every cap from the rounds
    needed up to 12 (the noise page needs 14: up to 16) gives the same
    labels."""
    t = torch.from_numpy(PREMISE[name])
    needed = int(rounds_needed(t, 40)[0])
    top = max(CAP, needed + 2)
    assert needed < 40 and (needed < CAP or name == "noise")
    final = label_components(t, iters=top)
    again = label_components(t, iters=1, labels0=final)
    assert torch.equal(again, final)
    for k in range(needed, top + 1):
        assert torch.equal(label_components(t, iters=k), final), (name, k)
    if needed:
        assert not torch.equal(label_components(t, iters=needed - 1), final)


def test_cap_binds_on_serpentine():
    t = torch.from_numpy(serpentine()[None])
    assert not torch.equal(label_components(t, iters=11),
                           label_components(t, iters=12))
    assert rounds_needed(t, CAP).tolist() == [CAP]
    assert rounds_needed(t, 40).tolist() == [19]


def test_rounds_needed_counts_each_frame():
    tern = torch.from_numpy(mixed_terns(64, 128, 20, 3))
    whole = rounds_needed(tern, 40)
    assert whole.dtype == torch.int64 and whole.shape == (4,)
    for b in range(4):
        assert rounds_needed(tern[b:b + 1], 40).tolist() == [int(whole[b])]
    assert rounds_needed(tern, 0).tolist() == [0] * 4


@pytest.mark.parametrize("iters", [0, 1, 5, 12, 13])
def test_wrapper_reports_needed_plus_confirming_round(iters):
    """On CPU tensors ``label_components_ccl_rounds`` runs the twin and
    counts the rounds the kernel runs: the rounds a frame needs and the
    confirming one, at most ``iters``."""
    tern = torch.from_numpy(mixed_terns(64, 128, 20, 3))
    labels, ran = label_components_ccl_rounds(tern, iters)
    assert torch.equal(labels, label_components(tern, iters=iters))
    assert ran.dtype == torch.int32
    assert ran.tolist() == [min(n + 1, iters) for n in (1, 4, 21, 19)]
