"""The port's ``Detections`` helpers against the JAX package's: ``count()``
(valid detections per frame) and ``filtered_by_decision_margin()`` (the
(frame, id, corners, margin) tuples above a margin, frame by frame and
slot by slot), on a scene of the detector parity corpus
(``tests/reference_impl/corpus.py``) beside a frame without tags.

Ids, frames and counts must be equal; corners within the detector parity
tolerance of ``tests/test_torch_pipeline.py`` (float32 quad fit and
refine in another order), margins within 1e-3 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chalkydri_tpu.detector.pipeline import make_detector as jax_make_detector
from chalkydri_tpu_torch.detector import pipeline as tdet
from tests.reference_impl.corpus import build_parity_corpus
from tests.test_torch_pipeline import CORNER_TOL

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def both():
    """(JAX detections, port detections) of corpus scene 1 (tags 470 and
    28) and a flat frame."""
    canvas, gts = build_parity_corpus(2)[1]
    assert len(gts) == 2
    frames = np.stack([canvas, np.full_like(canvas, 150)])
    want = jax_make_detector()(jnp.asarray(frames))
    got = tdet.make_detector(device="cpu")(torch.from_numpy(frames))
    return want, got


def test_count_equals_jax(both):
    want, got = both
    count = got.count()
    assert count.shape == (2,)
    np.testing.assert_array_equal(count.numpy(), np.asarray(want.count()))
    assert count.tolist() == [2, 0]


def test_filtered_by_decision_margin_equals_jax(both):
    want, got = both
    margins = sorted(float(m) for m in np.asarray(want.decision_margins)[
        np.asarray(want.valid)])
    # every detection, then only the one above the midpoint of the two
    for threshold, n in ((0.0, 2), ((margins[0] + margins[1]) / 2, 1)):
        w = list(want.filtered_by_decision_margin(threshold))
        g = list(got.filtered_by_decision_margin(threshold))
        assert len(g) == len(w) == n
        for (gb, gid, gc, gm), (wb, wid, wc, wm) in zip(g, w):
            assert (gb, gid) == (wb, wid)
            assert isinstance(gid, int) and isinstance(gm, float)
            np.testing.assert_allclose(gc, np.asarray(wc), atol=CORNER_TOL,
                                       rtol=0)
            assert abs(gm - wm) <= 1e-3 * max(abs(wm), 1.0)
