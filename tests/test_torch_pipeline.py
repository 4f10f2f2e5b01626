"""The whole slice, frames -> robot poses: the JAX package's fused
``make_vision_pipeline`` against the PyTorch port's, on the same rendered
frames and the same rig constants (built once in JAX, carried across with
``rig_from_numpy``).

The same comparison runs with ``quad_decimate=1`` (full-resolution quad
search) on each branch of the port's dispatch by pixel count, reached by
lowering the port's two dispatch constants; JAX on the CPU takes its
capped-CCL jnp path on every branch.

Integer outputs must be equal. Float tolerances: float32 operations run in
a different order in XLA-CPU and in torch (the quad fit's weighted sums,
refine's line fits, the solver's Jacobi sweeps and Newton steps), and the
JAX side runs under the suite's x64 mode with float32 inputs."""

import json
import logging
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chalkydri_tpu.detector import load_family as jax_load_family
from chalkydri_tpu.geometry import SE3 as JSE3
from chalkydri_tpu.geometry import parse_field_layout as jax_parse_layout
from chalkydri_tpu.geometry import robot_to_cam_from_offsets as jax_rc
from chalkydri_tpu.geometry.camera import OpenCVModel5 as JCam
from chalkydri_tpu.geometry.tags import corners_world as jax_corners_world
from chalkydri_tpu.pipeline import build_rig_from_config as jax_build_rig
from chalkydri_tpu.pipeline import make_vision_pipeline as jax_pipeline
from chalkydri_tpu_torch.detector import pipeline as tdet
from chalkydri_tpu_torch.detector.segment import label_components, labels_converged
from chalkydri_tpu_torch.detector.threshold import adaptive_threshold
from chalkydri_tpu_torch.geometry.field_layout import parse_field_layout
from chalkydri_tpu_torch.pipeline import (
    build_rig_from_config,
    make_vision_pipeline,
    rig_from_numpy,
)
from tests.reference_impl.render import place_tag

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELD = os.path.join(ROOT, "examples", "field_2026.json")
CALIB = {"fx": 900.0, "fy": 900.0, "cx": 320.0, "cy": 240.0, "k1": 0.0,
         "k2": 0.0, "p1": 0.0, "p2": 0.0, "k3": 0.0, "width": 640,
         "height": 480}
CAMS = [{"calib": json.dumps({"OpenCVModel5": CALIB}),
         "robot_to_cam": json.dumps({"roll": 0, "pitch": 0, "yaw": 0, "x": 0,
                                     "y": 0, "z": 1.0})}] * 2
# Tags 1 and 2 hang on the red wall (x = 11.86 m) facing -x; each robot
# pose looks at them from in front, so every tag is before the camera.
POSES = [((8.6, 4.0215), 0.0), ((8.3, 4.2), -0.04)]
TAGS = (1, 2)

CORNER_TOL = 1e-3  # px
POSE_TOL = 1e-3  # m
YAW_TOL = 1e-3  # rad


def _layout_json():
    with open(FIELD) as f:
        return json.load(f)


def _render(layout, rc, robot_xy, robot_yaw):
    """The camera's view of TAGS from a robot pose (pinhole, so the
    homography warp is the exact lens image)."""
    fam = jax_load_family("tag36h11")
    model = JCam.from_dict(CALIB, dtype=jnp.float32)
    c, s = np.cos(robot_yaw), np.sin(robot_yaw)
    w2r_rot = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], np.float32)
    w2r_t = -w2r_rot @ np.array([*robot_xy, 0.0], np.float32)
    w2c = rc.compose(JSE3(jnp.asarray(w2r_rot), jnp.asarray(w2r_t)))
    canvas = np.full((480, 640), 150, np.uint8)
    for tid in TAGS:
        pc = w2c.apply(jax_corners_world(layout.tag_pose(jnp.asarray(tid))))
        assert bool(jnp.all(pc[..., 2] > 0.5)), f"tag {tid} behind camera"
        pix, _ = model.project(pc)
        pix = np.asarray(pix, np.float32)
        assert (pix[:, 0] > 8).all() and (pix[:, 0] < 632).all()
        place_tag(canvas, fam, tid, pix)
    return canvas


@pytest.fixture(scope="module")
def scene():
    """The rig in JAX and carried across to the port, the frames and the
    gyro."""
    layout_j = jax_parse_layout(_layout_json(), dtype=jnp.float32)
    params_j, rc_j = jax_build_rig(CAMS, layout_j)
    rc_one = jax_rc(0, 0, 1.0, 0, 0, 0, dtype=jnp.float32)
    frames = np.stack([_render(layout_j, rc_one, xy, yaw) for xy, yaw in POSES])
    gyro = np.array([yaw for _, yaw in POSES], np.float32)
    rig_t = rig_from_numpy(
        np.asarray(layout_j.rotations), np.asarray(layout_j.translations),
        np.asarray(layout_j.present), np.asarray(params_j),
        np.asarray(rc_j.rotation), np.asarray(rc_j.translation), device="cpu")
    return (layout_j, params_j, rc_j), rig_t, frames, gyro


@pytest.fixture(scope="module")
def slice_outputs(scene):
    rig_j, rig_t, frames, gyro = scene
    want = jax_pipeline(*rig_j)(jnp.asarray(frames), jnp.asarray(gyro))
    step = make_vision_pipeline(*rig_t, device="cpu")
    got = step(torch.from_numpy(frames), torch.from_numpy(gyro))
    return want, got, rig_j


def test_integer_outputs_equal(slice_outputs):
    want, got, _ = slice_outputs
    for name in ("ids", "hammings", "valid", "dropped_points"):
        np.testing.assert_array_equal(
            getattr(got.detections, name).numpy(),
            np.asarray(getattr(want.detections, name)), err_msg=name)
    for name in ("tag_count", "pose_valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for b in range(len(POSES)):
        ids = got.detections.ids[b][got.detections.valid[b]].tolist()
        assert sorted(ids) == sorted(TAGS)
    assert got.pose_valid.all() and (got.tag_count == len(TAGS)).all()


def test_float_outputs_within_tolerance(slice_outputs):
    want, got, _ = slice_outputs
    valid = np.asarray(want.detections.valid)
    np.testing.assert_allclose(got.detections.corners.numpy()[valid],
                               np.asarray(want.detections.corners)[valid],
                               atol=CORNER_TOL, rtol=0)
    m_want = np.asarray(want.detections.decision_margins)[valid]
    m_got = got.detections.decision_margins.numpy()[valid]
    assert (np.abs(m_got - m_want) <= 1e-3 * np.maximum(1.0, np.abs(m_want))).all()
    for name in ("pose_x", "pose_y"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=POSE_TOL, rtol=0, err_msg=name)
    np.testing.assert_allclose(got.pose_yaw.numpy(), np.asarray(want.pose_yaw),
                               atol=YAW_TOL, rtol=0)


def test_both_recover_the_true_pose(slice_outputs):
    want, got, _ = slice_outputs
    for out in (want, got):
        for b, ((x, y), yaw) in enumerate(POSES):
            assert abs(float(out.pose_x[b]) - x) < 0.02
            assert abs(float(out.pose_y[b]) - y) < 0.02
            assert abs(float(out.pose_yaw[b]) - yaw) < 0.01


def test_port_rig_builder_reproduces_jax_rig(slice_outputs):
    _, _, (layout_j, params_j, rc_j) = slice_outputs
    layout_t = parse_field_layout(_layout_json(), dtype=torch.float32)
    np.testing.assert_allclose(layout_t.rotations.numpy(),
                               np.asarray(layout_j.rotations), atol=1e-6)
    np.testing.assert_allclose(layout_t.translations.numpy(),
                               np.asarray(layout_j.translations), atol=1e-6)
    np.testing.assert_array_equal(layout_t.present.numpy(),
                                  np.asarray(layout_j.present))
    assert layout_t.field_size == layout_j.field_size
    params_t, rc_t = build_rig_from_config(CAMS, layout_t, device="cpu")
    np.testing.assert_array_equal(params_t.numpy(), np.asarray(params_j))
    np.testing.assert_allclose(rc_t.rotation.numpy(), np.asarray(rc_j.rotation),
                               atol=1e-6)
    np.testing.assert_allclose(rc_t.translation.numpy(),
                               np.asarray(rc_j.translation), atol=1e-6)


def _assert_equal_fields(got, want, names):
    for name in names:
        g = getattr(got.detections, name, None)
        if g is None:
            g, w = getattr(got, name), getattr(want, name)
        else:
            w = getattr(want.detections, name)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def _assert_floats_close(got, want):
    valid = np.asarray(want.detections.valid)
    np.testing.assert_allclose(got.detections.corners.numpy()[valid],
                               np.asarray(want.detections.corners)[valid],
                               atol=CORNER_TOL, rtol=0)
    for name in ("pose_x", "pose_y"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=POSE_TOL, rtol=0, err_msg=name)
    np.testing.assert_allclose(got.pose_yaw.numpy(), np.asarray(want.pose_yaw),
                               atol=YAW_TOL, rtol=0)


# Dispatch branch -> (EXTRACT_BLOCK_MAX_PIXELS, SINGLE_BLOCK_MAX_PIXELS,
# the kernel wrapper it calls); None keeps the port's constant. A 480x640
# frame (307,200 px) takes the B1 branch with the constants as they are.
BRANCHES = {
    "B1": (None, None, "threshold_ccl_extract"),
    "B3": (0, None, "threshold_ccl"),
    "B5": (0, 0, "threshold_ccl_exact"),
}
_WRAPPERS = ("threshold_ccl_extract", "threshold_ccl", "threshold_ccl_exact")


@pytest.fixture(scope="module")
def qd1_outputs(scene):
    rig_j, rig_t, frames, gyro = scene
    kw = {"quad_decimate": 1}
    want = jax_pipeline(*rig_j, detector_kwargs=kw)(jnp.asarray(frames),
                                                    jnp.asarray(gyro))
    step = make_vision_pipeline(*rig_t, detector_kwargs=kw, device="cpu")
    got, called = {}, {}
    for branch, (extract_max, single_max, _) in BRANCHES.items():
        calls = []
        with pytest.MonkeyPatch.context() as mp:
            for name, value in (("EXTRACT_BLOCK_MAX_PIXELS", extract_max),
                                ("SINGLE_BLOCK_MAX_PIXELS", single_max)):
                if value is not None:
                    mp.setattr(tdet, name, value)
            for name in _WRAPPERS:
                fn = getattr(tdet, name)
                mp.setattr(tdet, name, lambda *a, _fn=fn, _name=name, **k: (
                    calls.append(_name), _fn(*a, **k))[1])
            got[branch] = step(torch.from_numpy(frames), torch.from_numpy(gyro))
        called[branch] = calls
    return want, got, called


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_qd1_dispatch_reaches_each_branch(qd1_outputs, branch):
    _, _, called = qd1_outputs
    assert called[branch] == [BRANCHES[branch][2]]


@pytest.mark.parametrize("branch", ["B1", "B3"])
def test_qd1_capped_branches_equal_jax(qd1_outputs, branch):
    want, got, _ = qd1_outputs
    _assert_equal_fields(got[branch], want, ("ids", "hammings", "valid",
                                             "dropped_points", "tag_count",
                                             "pose_valid"))
    _assert_floats_close(got[branch], want)


def test_qd1_exact_branch_matches_capped_jax_on_a_converging_scene(
        scene, qd1_outputs):
    """B5's labels are fixed-point, padded-flat ones, JAX's here capped
    flat ones: on a scene where 12 rounds converge both name the same
    components, so the detections agree."""
    _, _, frames, _ = scene
    tern = adaptive_threshold(torch.from_numpy(frames))
    assert labels_converged(tern, label_components(tern, iters=12))
    want, got, _ = qd1_outputs
    _assert_equal_fields(got["B5"], want, ("ids", "hammings", "valid",
                                           "tag_count", "pose_valid"))
    _assert_floats_close(got["B5"], want)


def test_qd1_all_recover_the_true_pose(qd1_outputs):
    want, got, _ = qd1_outputs
    for out in (want, *got.values()):
        for b, ((x, y), yaw) in enumerate(POSES):
            assert abs(float(out.pose_x[b]) - x) < 0.02
            assert abs(float(out.pose_y[b]) - y) < 0.02
            assert abs(float(out.pose_yaw[b]) - yaw) < 0.01


def test_yuyv_input_gives_the_grey_step(scene, slice_outputs):
    _, rig_t, frames, gyro = scene
    _, grey_out, _ = slice_outputs
    chroma = np.random.default_rng(9).integers(0, 256, frames.shape,
                                               dtype=np.uint8)
    yuyv = np.stack([frames, chroma], axis=-1).reshape(*frames.shape[:2], -1)
    step = make_vision_pipeline(*rig_t, input_format="YUYV", device="cpu")
    out = step(torch.from_numpy(yuyv), torch.from_numpy(gyro))
    for name in out._fields:
        if name != "detections":
            assert torch.equal(getattr(out, name), getattr(grey_out, name)), name
    for name in out.detections._fields:
        assert torch.equal(getattr(out.detections, name),
                           getattr(grey_out.detections, name)), name


def test_pipeline_strips_detector_keys_of_other_layers(scene, caplog):
    _, rig_t, _, _ = scene
    with caplog.at_level(logging.WARNING):
        step = make_vision_pipeline(*rig_t, detector_kwargs={
            "ccl_impl": "union_find", "capacity_fallback": True,
            "quad_decimate": 1}, device="cpu")
    assert step.detector.quad_decimate == 1
    assert not step.detector.capacity_fallback
    assert "capacity_fallback" in caplog.text


def test_port_imports_no_jax():
    code = (
        "import sys, pkgutil, importlib, chalkydri_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'chalkydri_tpu_torch.bench' in sys.modules, 'bench twin'\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert not any(k.startswith('chalkydri_tpu.') or k == 'chalkydri_tpu'"
        " for k in sys.modules), 'JAX package imported'\n"
        "assert 'cv2' not in sys.modules, 'cv2 imported'\n"
        "assert not any(k == 'tests' or k.startswith('tests.')"
        " for k in sys.modules), 'tests imported'\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
