"""The detector's options against the JAX package on the same numpy
inputs: extraction + compaction of ternary and label images (bitwise),
on-device grayscale conversion (bitwise, every format) and the capacity
fallback (ids, hammings and validity equal, corners within 1e-3 px); and
the port's entry points default to the card."""

import inspect
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chalkydri_tpu.detector import adaptive_threshold as jax_threshold
from chalkydri_tpu.detector import label_components as jax_label
from chalkydri_tpu.detector import load_family as jax_load_family
from chalkydri_tpu.detector import cluster as jc
from chalkydri_tpu.detector.grayscale import to_gray_device as jax_to_gray
from chalkydri_tpu.detector.pipeline import make_detector as jax_make_detector
from chalkydri_tpu_torch import pipeline as tp
from chalkydri_tpu_torch.detector import cluster as tc
from chalkydri_tpu_torch.detector import decode as tdecode
from chalkydri_tpu_torch.detector import pipeline as tdet
from chalkydri_tpu_torch.detector.grayscale import to_gray_device
from tests.reference_impl.render import axis_aligned_corners, simple_scene

torch.set_num_threads(1)

FAM = jax_load_family("tag36h11")
CORNER_TOL = 1e-3  # px: float32 quad fit and refine in another order


def _scene(noise, size=(240, 320), side=70):
    canvas, _ = simple_scene(
        FAM, [(7, axis_aligned_corners(size[1] // 2, size[0] // 2, side))],
        size=size, noise=noise, seed=3)
    return canvas


def test_extract_and_compact_and_clusters_match_jax_bitwise():
    gray = np.stack([_scene(4.0), _scene(0.0)])
    tern = jax_threshold(jnp.asarray(gray))
    labels = jax_label(tern, iters=12)
    max_points = 4096  # the block compaction drops candidates
    want = jax.jit(jax.vmap(partial(jc.extract_and_compact,
                                    max_points=max_points)))(tern, labels)
    t_tern = torch.from_numpy(np.array(tern))
    t_labels = torch.from_numpy(np.array(labels))
    got = tc.extract_and_compact(t_tern, t_labels, max_points=max_points)
    for name, j, t in zip(("black", "white", "payload", "dropped"), want, got):
        assert t.dtype == torch.int32, name
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    assert int(got[3].sum()) > 0

    want_c = jax.jit(partial(jc.gradient_clusters_batched,
                             max_points=max_points))(tern, labels)
    got_c = tc.gradient_clusters_batched(t_tern, t_labels,
                                         max_points=max_points)
    assert int(got_c.valid.sum()) > 0
    for name in jc.Clusters._fields:
        np.testing.assert_array_equal(getattr(got_c, name).numpy(),
                                      np.asarray(getattr(want_c, name)),
                                      err_msg=name)


_FORMATS = {  # fourcc -> raw frame shape for 8x12 gray frames
    "GREY": (2, 8, 12), "Y800": (2, 8, 12), "RGB": (2, 8, 12, 3),
    "RGBA": (2, 8, 12, 4), "BGR": (2, 8, 12, 3), "BGRA": (2, 8, 12, 4),
    "YUYV": (2, 8, 24), "YUY2": (2, 8, 24), "NV12": (2, 12, 12),
    "I420": (2, 12, 12),
}


@pytest.mark.parametrize("fourcc", sorted(_FORMATS))
def test_to_gray_device_matches_jax(fourcc):
    raw = np.random.default_rng(5).integers(0, 256, _FORMATS[fourcc],
                                            dtype=np.uint8)
    want = np.asarray(jax_to_gray(jnp.asarray(raw), fourcc=fourcc))
    got = to_gray_device(torch.from_numpy(raw), fourcc=fourcc.lower())
    assert got.dtype == torch.uint8 and got.is_contiguous()
    assert tuple(got.shape) == (2, 8, 12)
    np.testing.assert_array_equal(got.numpy(), want)


def test_to_gray_device_rejects_unknown_format():
    with pytest.raises(ValueError, match="unsupported fourcc"):
        to_gray_device(torch.zeros((1, 8, 8), dtype=torch.uint8), "MJPG")


def test_capacity_fallback_matches_jax():
    """A noisy frame whose candidates overflow a 1,024-point budget: both
    re-run the batch at twice the budget. max_clusters is 16 because the
    JAX package's cluster top-k needs at most 2 * 1024 / 128 chunks."""
    gray = _scene(4.0)[None]
    kw = dict(max_edge_points=1024, max_clusters=16, capacity_fallback=True)
    want = jax_make_detector(**kw)(jnp.asarray(gray))
    det = tdet.make_detector(device="cpu", **kw)
    assert int(det.detect(torch.from_numpy(gray)).dropped_points.max()) > 0
    got = det(torch.from_numpy(gray))
    assert det.wide is not None and det.wide.edge_cap == 2048
    for name in ("ids", "hammings", "valid", "dropped_points"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.ids[0, 0] == 7
    valid = np.asarray(want.valid)
    np.testing.assert_allclose(got.corners.numpy()[valid],
                               np.asarray(want.corners)[valid],
                               atol=CORNER_TOL, rtol=0)


def test_more_clusters_than_chunk_winners_is_refused_as_in_jax():
    gray = _scene(0.0)[None]
    with pytest.raises(ValueError):
        jax_make_detector(max_edge_points=1024)(jnp.asarray(gray))
    with pytest.raises(ValueError, match="max_clusters=64"):
        tdet.make_detector(max_edge_points=1024, device="cpu")(
            torch.from_numpy(gray))


def test_capacity_fallback_not_built_on_a_clean_frame():
    det = tdet.make_detector(capacity_fallback=True, device="cpu")
    out = det(torch.from_numpy(_scene(0.0)[None]))
    assert int(out.dropped_points.max()) == 0 and out.ids[0, 0] == 7
    assert det.wide is None


@pytest.mark.parametrize("entry_point", [
    tp.make_vision_pipeline, tp.build_rig_from_config, tp.rig_from_numpy,
    tdet.make_detector, tdecode.make_decoder])
def test_entry_points_default_to_the_card(entry_point):
    assert inspect.signature(entry_point).parameters["device"].default == "cuda"


def test_detector_rejects_other_decimation():
    with pytest.raises(ValueError, match="quad_decimate"):
        tdet.make_detector(quad_decimate=3, device="cpu")
