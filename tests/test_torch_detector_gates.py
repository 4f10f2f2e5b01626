"""The JAX package's detector gates, held on the port against JAX's
detector on the same frames (the port's ``make_detector(device="cpu")``
against ``chalkydri_tpu.detector.make_detector``):

- the margin scenes of ``tests/test_detector.py``: the blur, noise and
  contrast axes of ``TestMarginDiscrimination``, the contrasts of
  ``test_decision_margin_scale``, and ``decision_margin_min`` in the fused
  pipeline (``test_filtered_by_decision_margin_end_to_end``);
- the scenes of ``TestDetectorEndToEnd``: the four rotations, the
  projective warp, the empty frame, blur with low contrast, noise, and
  the other three families (tag16h5, tag25h9, tag36h10);
- ``TestCapacityAndEdgeCases``: the 16-tag capacity, the partial tag, the
  13 px tag and the duplicate id;
- the deployed ``quad_decimate=1`` path (``tools/scenes.py``'s
  ``deployed`` frames, 2 x 1304x1600): the port's B5 labels padded-flat,
  as JAX's TPU kernel does, so the port is held to JAX's
  ``threshold_ccl_blocked(..., interpret=True)`` followed by JAX's own
  tail (``extract_and_compact``, ``cluster_candidates_batched``,
  ``make_post_cluster``), every field equal, corners and decision
  margins bit for bit, the order of the slots of equal decision margin
  included.

Each scene is a test case. Elsewhere integer outputs equal; corners
within 1e-3 px and decision margins within 1e-3 relative (float32 sums
in another order in XLA-CPU and torch), as
``tests/test_torch_pipeline.py``."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from chalkydri_tpu.detector import load_family
from chalkydri_tpu.detector import make_detector as jax_make_detector
from chalkydri_tpu.detector.cluster import (
    MAX_CLUSTER_POINTS,
    MAX_CLUSTERS,
    MAX_EDGE_POINTS,
    cluster_candidates_batched,
    extract_and_compact,
)
from chalkydri_tpu.detector.decode import make_decoder
from chalkydri_tpu.detector.families import DEFAULT_BITS_CORRECTED
from chalkydri_tpu.detector.pipeline import make_post_cluster
from chalkydri_tpu.ops.pallas.ccl_kernel import threshold_ccl_blocked
from chalkydri_tpu.pipeline import build_rig_from_config as jax_build_rig
from chalkydri_tpu.pipeline import make_vision_pipeline as jax_pipeline
from chalkydri_tpu_torch.detector.pipeline import make_detector
from chalkydri_tpu_torch.pipeline import make_vision_pipeline, rig_from_numpy
from chalkydri_tpu_torch.tools.scenes import load_scene
from tests.reference_impl.render import (
    axis_aligned_corners,
    place_tag,
    simple_scene,
)
from tests.test_torch_pipeline import CORNER_TOL, POSE_TOL, YAW_TOL

torch.set_num_threads(1)

FAM = load_family("tag36h11")
MARGIN_RTOL = 1e-3
DET_INT_FIELDS = ("ids", "hammings", "valid", "dropped_points")


def _margin_scene(blur=0.0, noise=0.0, contrast=1.0, tid=17):
    """``TestMarginDiscrimination._scene``."""
    from scipy import ndimage

    canvas = np.full((480, 640), 160, np.uint8)
    place_tag(canvas, FAM, tid, axis_aligned_corners(320, 240, 70))
    f = 160 + (canvas.astype(np.float32) - 160) * contrast
    if blur > 0:
        f = ndimage.gaussian_filter(f, blur)
    if noise > 0:
        f = f + np.random.default_rng(7).normal(0, noise, f.shape)
    return np.clip(f, 0, 255).astype(np.uint8)


def _scale_scene(contrast):
    """``test_decision_margin_scale``'s tag 7 squeezed about 160."""
    tmp = np.full((480, 640), 160, np.uint8)
    place_tag(tmp, FAM, 7, axis_aligned_corners(320, 240, 80))
    sub = 160 + (tmp.astype(np.float32) - 160) * contrast
    return np.clip(sub, 0, 255).astype(np.uint8)


def _blur_contrast_scene(sigma, lo, hi):
    """``test_blur_and_low_contrast``: OpenCV's Gaussian blur."""
    import cv2

    canvas, _ = simple_scene(FAM, [(5, axis_aligned_corners(320, 240, 90))])
    f = canvas.astype(np.float32) / 255.0 * (hi - lo) + lo
    return cv2.GaussianBlur(f, (0, 0), sigma).astype(np.uint8)


def _one(tid, half, cx=320, cy=240, **kw):
    return simple_scene(FAM, [(tid, axis_aligned_corners(cx, cy, half))],
                        **kw)[0]


# name -> 480x640 frame for the default (tag36h11) detector, built lazily.
SCENES_36H11 = {
    **{f"rotated_{r}": partial(_one, 3, 80, rot90s=[r]) for r in range(4)},
    "projective_warp": lambda: simple_scene(FAM, [(11, np.array(
        [[180.0, 330.0], [420.0, 300.0], [400.0, 130.0], [210.0, 160.0]],
        np.float32))])[0],
    "empty": lambda: np.full((480, 640), 128, np.uint8),
    **{f"blur_{s}_contrast_{lo}_{hi}": partial(_blur_contrast_scene, s, lo, hi)
       for s, lo, hi in ((1.0, 0, 255), (2.0, 90, 170), (3.0, 110, 150))},
    "noise_8": partial(_one, 5, 90, noise=8.0),
    **{f"margin_blur_{b:g}": partial(_margin_scene, blur=b)
       for b in (0.0, 2.0, 3.0, 4.0, 5.0, 6.0)},
    **{f"margin_noise_{n}": partial(_margin_scene, noise=n)
       for n in (0, 10, 20, 30, 40, 50)},
    **{f"margin_contrast_{c:g}": partial(_margin_scene, contrast=c)
       for c in (1.0, 0.6, 0.4, 0.25)},
    **{f"margin_scale_{c:g}": partial(_scale_scene, c) for c in (1.0, 0.6, 0.3)},
    "partial_tag": partial(_one, 3, 80, cx=620),
    "small_tag": partial(_one, 9, 13),
    "duplicate_id": lambda: simple_scene(FAM, [
        (7, axis_aligned_corners(180, 240, 70)),
        (7, axis_aligned_corners(460, 240, 70))])[0],
}

# name -> (family, bits corrected, tag id); one 80 px tag at the centre.
FAMILY_SCENES = {"tag16h5": ("tag16h5", 0, 4), "tag25h9": ("tag25h9", 1, 7),
                 "tag36h10": ("tag36h10", 2, 1234)}


def _sixteen_tags():
    tags = [(i, axis_aligned_corners(90 + 150 * (i % 4), 70 + 115 * (i // 4),
                                     45)) for i in range(16)]
    return simple_scene(FAM, tags, size=(560, 720))[0]


def _detect_both(frames: np.ndarray, **kw):
    """(JAX's Detections, the port's) on the batch ``frames``."""
    want = jax_make_detector(**kw)(jnp.asarray(frames))
    got = make_detector(device="cpu", **kw)(torch.from_numpy(frames))
    return want, got


def _assert_detections_equal(want, got, b: int = 0, exact: bool = False):
    """Frame ``b`` of two Detections: integers equal, floats within the
    tolerances (``exact``: equal too)."""
    for name in DET_INT_FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy()[b],
                                      np.asarray(getattr(want, name))[b],
                                      err_msg=name)
    valid = np.asarray(want.valid)[b]
    c_got = got.corners.numpy()[b][valid]
    c_want = np.asarray(want.corners)[b][valid]
    m_got = got.decision_margins.numpy()[b][valid]
    m_want = np.asarray(want.decision_margins)[b][valid]
    if exact:
        np.testing.assert_array_equal(c_got, c_want, err_msg="corners")
        np.testing.assert_array_equal(m_got, m_want, err_msg="margins")
        return
    np.testing.assert_allclose(c_got, c_want, atol=CORNER_TOL, rtol=0,
                               err_msg="corners")
    assert (np.abs(m_got - m_want)
            <= MARGIN_RTOL * np.maximum(1.0, np.abs(m_want))).all(), (
        m_got, m_want)


@pytest.fixture(scope="module")
def scenes_36h11():
    names = list(SCENES_36H11)
    frames = np.stack([SCENES_36H11[n]() for n in names])
    want, got = _detect_both(frames)
    return {n: (want, got, b) for b, n in enumerate(names)}


@pytest.mark.parametrize("name", list(SCENES_36H11))
def test_tag36h11_scene_equals_jax(scenes_36h11, name):
    want, got, b = scenes_36h11[name]
    _assert_detections_equal(want, got, b)


def test_margin_axes_detect_tag_17_in_the_port(scenes_36h11):
    """Each frame of the margin axes holds tag 17 once in the port too."""
    for name, (_, got, b) in scenes_36h11.items():
        if name.startswith(("margin_blur", "margin_noise", "margin_contrast")):
            hit = (got.ids[b] == 17) & got.valid[b]
            assert int(hit.sum()) == 1, name


@pytest.mark.parametrize("family", sorted(FAMILY_SCENES))
def test_other_family_equals_jax(family):
    name, bits, tid = FAMILY_SCENES[family]
    fam = load_family(name)
    frame = simple_scene(fam, [(tid, axis_aligned_corners(320, 240, 80))])[0]
    want, got = _detect_both(frame[None], family=name, bits_corrected=bits)
    _assert_detections_equal(want, got)
    assert tid in got.ids[0][got.valid[0]].tolist()


def test_sixteen_tags_capacity_equals_jax():
    want, got = _detect_both(_sixteen_tags()[None])
    _assert_detections_equal(want, got)
    assert sorted(got.ids[0][got.valid[0]].tolist()) == list(range(16))


def test_decision_margin_min_in_the_pipeline_equals_jax():
    """``decision_margin_min=50`` on the tiny rig: the low-contrast frame's
    tags decode but leave the solve (tag_count 0, pose invalid), the clean
    frame solves; the port's step equals JAX's on both, with and without
    the gate."""
    layout_j, cams = ge._tiny_rig(jnp.float32)
    params_j, rc_j = jax_build_rig(cams, layout_j)
    rig_t = rig_from_numpy(
        np.asarray(layout_j.rotations), np.asarray(layout_j.translations),
        np.asarray(layout_j.present), np.asarray(params_j),
        np.asarray(rc_j.rotation), np.asarray(rc_j.translation), device="cpu")
    clean = ge._render_scene(layout_j, 1)
    low = np.clip(150 + (clean.astype(np.float32) - 150) * 0.25, 0,
                  255).astype(np.uint8)
    gyro = np.zeros(1, np.float32)
    for margin_min in (0.0, 50.0):
        step_j = jax_pipeline(layout_j, params_j, rc_j,
                              decision_margin_min=margin_min)
        step_t = make_vision_pipeline(*rig_t, decision_margin_min=margin_min,
                                      device="cpu")
        for frame in (low, clean):
            want = step_j(jnp.asarray(frame), jnp.asarray(gyro))
            got = step_t(torch.from_numpy(frame), torch.from_numpy(gyro))
            _assert_detections_equal(want.detections, got.detections)
            for name in ("tag_count", "pose_valid"):
                np.testing.assert_array_equal(getattr(got, name).numpy(),
                                              np.asarray(getattr(want, name)))
            for name, tol in (("pose_x", POSE_TOL), ("pose_y", POSE_TOL),
                              ("pose_yaw", YAW_TOL)):
                np.testing.assert_allclose(getattr(got, name).numpy(),
                                           np.asarray(getattr(want, name)),
                                           atol=tol, rtol=0)
            if frame is low:
                assert bool(got.pose_valid[0]) == (margin_min == 0.0)
            else:
                assert bool(got.pose_valid[0])


@pytest.fixture(scope="module")
def deployed_qd1():
    """The deployed frames through the port's ``quad_decimate=1`` detector
    and through JAX's TPU semantics: the row-blocked Pallas kernel in
    interpret mode, then JAX's own tail."""
    _, _, _, frames, _ = load_scene("deployed", "cpu")
    frames = frames.numpy()
    got = make_detector(quad_decimate=1, device="cpu")(torch.from_numpy(frames))

    gray = jnp.asarray(frames)
    tern, labels = threshold_ccl_blocked(gray, iters=12, interpret=True)
    black, white, payload, dropped = jax.vmap(
        partial(extract_and_compact, max_points=MAX_EDGE_POINTS))(tern, labels)
    clusters = cluster_candidates_batched(
        black, white, payload, max_points=MAX_EDGE_POINTS,
        max_clusters=MAX_CLUSTERS, cluster_points=MAX_CLUSTER_POINTS,
        dropped=dropped)
    finish = make_post_cluster(
        make_decoder(FAM, bits_corrected=DEFAULT_BITS_CORRECTED), refine=True,
        quad_decimate=1)
    want = jax.jit(finish)(gray, clusters)
    return want, got


@pytest.mark.parametrize("frame", [0, 1])
def test_deployed_qd1_equals_jax_blocked_kernel(deployed_qd1, frame):
    want, got = deployed_qd1
    _assert_detections_equal(want, got, frame, exact=True)
    # slots of equal decision margin, in the order of the padded-flat labels
    valid = got.valid[frame]
    assert len(set(got.decision_margins[frame][valid].tolist())) < int(
        valid.sum())
    assert int(valid.sum()) == 4
