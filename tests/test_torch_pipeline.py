"""The whole slice, frames -> robot poses: the JAX package's fused
``make_vision_pipeline`` against the PyTorch port's, on the same rendered
frames and the same rig constants (built once in JAX, carried across with
``rig_from_numpy``).

Integer outputs must be equal. Float tolerances: float32 operations run in
a different order in XLA-CPU and in torch (the quad fit's weighted sums,
refine's line fits, the solver's Jacobi sweeps and Newton steps), and the
JAX side runs under the suite's x64 mode with float32 inputs."""

import json
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
def slice_outputs():
    layout_j = jax_parse_layout(_layout_json(), dtype=jnp.float32)
    params_j, rc_j = jax_build_rig(CAMS, layout_j)
    rc_one = jax_rc(0, 0, 1.0, 0, 0, 0, dtype=jnp.float32)
    frames = np.stack([_render(layout_j, rc_one, xy, yaw) for xy, yaw in POSES])
    gyro = np.array([yaw for _, yaw in POSES], np.float32)

    want = jax_pipeline(layout_j, params_j, rc_j)(jnp.asarray(frames),
                                                  jnp.asarray(gyro))
    layout_t, params_t, rc_t = rig_from_numpy(
        np.asarray(layout_j.rotations), np.asarray(layout_j.translations),
        np.asarray(layout_j.present), np.asarray(params_j),
        np.asarray(rc_j.rotation), np.asarray(rc_j.translation))
    step = make_vision_pipeline(layout_t, params_t, rc_t, device="cpu")
    got = step(torch.from_numpy(frames), torch.from_numpy(gyro))
    return want, got, (layout_j, params_j, rc_j)


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
    params_t, rc_t = build_rig_from_config(CAMS, layout_t)
    np.testing.assert_array_equal(params_t.numpy(), np.asarray(params_j))
    np.testing.assert_allclose(rc_t.rotation.numpy(), np.asarray(rc_j.rotation),
                               atol=1e-6)
    np.testing.assert_allclose(rc_t.translation.numpy(),
                               np.asarray(rc_j.translation), atol=1e-6)


def test_port_imports_no_jax():
    code = (
        "import sys, pkgutil, importlib, chalkydri_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert not any(k.startswith('chalkydri_tpu.') or k == 'chalkydri_tpu'"
        " for k in sys.modules), 'JAX package imported'\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
