"""Module parity between the PyTorch port and the JAX package on the same
numpy inputs: clustering (bitwise), camera and transforms (float32,
|d| <= 1e-5) and the robot-pose solver (|d| <= 1e-4 m)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chalkydri_tpu.detector import adaptive_threshold as jax_threshold
from chalkydri_tpu.detector import label_components as jax_label
from chalkydri_tpu.detector import load_family as jax_load_family
from chalkydri_tpu.detector import cluster as jc
from chalkydri_tpu.geometry import camera as jcam
from chalkydri_tpu.geometry import transforms as jtf
from chalkydri_tpu.geometry.field_layout import parse_field_layout as jax_layout
from chalkydri_tpu.geometry.tags import corners_world as jax_corners_world
from chalkydri_tpu.solver.robot_pose import solve_robot_pose_batched
from chalkydri_tpu_torch.detector import cluster as tc
from chalkydri_tpu_torch.detector import families as tfam
from chalkydri_tpu_torch.geometry import camera as tcam
from chalkydri_tpu_torch.geometry import transforms as ttf
from chalkydri_tpu_torch.solver.robot_pose import solve_robot_pose
from tests.reference_impl.render import axis_aligned_corners, simple_scene

torch.set_num_threads(1)

FIELD = os.path.join(os.path.dirname(__file__), "..", "examples",
                     "field_2026.json")


def _t(a):
    return torch.from_numpy(np.array(a))


def _candidates():
    """Dense candidates of three different 240x320 frames (JAX path)."""
    fam = jax_load_family("tag36h11")
    frames = []
    for i, (cx, cy, half) in enumerate([(160, 120, 70), (100, 90, 50),
                                        (220, 150, 40)]):
        canvas, _ = simple_scene(
            fam, [(3 + i, axis_aligned_corners(cx, cy, half)),
                  (9, axis_aligned_corners(40, 40, 25))],
            size=(240, 320), noise=4.0 * i, seed=i)
        frames.append(canvas)
    tern = jax_threshold(jnp.asarray(np.stack(frames)))
    labels = jax_label(tern, iters=12)
    return jax.vmap(jc.extract_boundary_points)(tern, labels)


@pytest.mark.parametrize("name", ["tag16h5", "tag25h9", "tag36h10",
                                  "tag36h11"])
def test_port_codebooks_equal_jax_tables(name):
    """The port reads its own copies of the codebooks: codes, dim,
    min_hamming and all four rotations equal the JAX package's."""
    assert os.path.dirname(tfam._DATA_DIR) == os.path.dirname(
        os.path.abspath(tfam.__file__))
    got, want = tfam.load_family(name), jax_load_family(name)
    assert (got.name, got.dim, got.nbits, got.ncodes, got.min_hamming) == (
        want.name, want.dim, want.nbits, want.ncodes, want.min_hamming)
    np.testing.assert_array_equal(got.codes, want.codes.astype(np.int64))
    np.testing.assert_array_equal(got.codes_rot,
                                  want.codes_rot.astype(np.int64))
    np.testing.assert_array_equal(got.codes32, want.codes32.astype(np.int64))


def test_top_indices_keep_lax_top_k_tie_order():
    rng = np.random.default_rng(0)
    score = rng.integers(0, 4, (3, 500)).astype(np.int32)  # many ties
    _, want = jax.lax.top_k(jnp.asarray(score), 37)
    got = tc.top_indices(_t(score), 37)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pair_hash_matches_int32_wrapping_multiply():
    rng = np.random.default_rng(1)
    black = rng.integers(0, 2 ** 31 - 1, 4096).astype(np.int32)
    white = rng.integers(0, 2 ** 31 - 1, 4096).astype(np.int32)
    black[:7] = 2 ** 31 - 1
    b32 = black.astype(np.int64) * np.int64(-1640531527)
    w32 = white.astype(np.int64) * np.int64(-2048144789)
    want = ((b32.astype(np.int32) ^ w32.astype(np.int32)) & tc._HASH_MASK)
    want = np.where(want == tc._HASH_MASK, tc._HASH_MASK - 1, want)
    want = np.where(black == 2 ** 31 - 1, tc._HASH_MASK, want)
    np.testing.assert_array_equal(tc.pair_hash(_t(black), _t(white)).numpy(),
                                  want)


def test_compaction_and_clusters_match_jax_bitwise():
    black, white, payload = (np.asarray(x) for x in _candidates())
    max_points = 4096  # small budget: the block compaction really drops
    jb, jw, jp, jd = jax.vmap(
        lambda b, w, p: jc.compact_candidates(b, w, p, width=320,
                                              max_points=max_points)
    )(black, white, payload)
    tb, tw, tp, td = tc.compact_candidates(_t(black), _t(white), _t(payload),
                                           width=320, max_points=max_points)
    for name, j, t in (("black", jb, tb), ("white", jw, tw),
                       ("payload", jp, tp), ("dropped", jd, td)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    assert int(td.sum()) > 0

    want = jc.cluster_candidates_batched(jb, jw, jp, max_points=max_points,
                                         dropped=jd)
    got = tc.cluster_candidates_batched(tb, tw, tp, max_points=max_points,
                                        dropped=td)
    assert int(got.valid.sum()) > 0
    for name in jc.Clusters._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


def test_clusters_match_jax_without_compaction():
    black, white, payload = (np.asarray(x) for x in _candidates())
    want = jc.cluster_candidates_batched(black, white, payload)
    got = tc.cluster_candidates_batched(_t(black), _t(white), _t(payload))
    for name in jc.Clusters._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


CALIB = {"fx": 910.0, "fy": 905.0, "cx": 322.0, "cy": 238.0, "k1": -0.21,
         "k2": 0.07, "p1": 0.001, "p2": -0.0007, "k3": -0.01,
         "width": 640, "height": 480}


def test_camera_project_unproject_match_jax():
    rng = np.random.default_rng(2)
    pts = np.concatenate([rng.uniform(-0.6, 0.6, (64, 2)),
                          rng.uniform(1.0, 4.0, (64, 1))], 1).astype(np.float32)
    calib = json.dumps({"OpenCVModel5": CALIB})
    jm = jcam.OpenCVModel5.from_json(calib, dtype=jnp.float32)
    tm = tcam.OpenCVModel5.from_json(calib, dtype=torch.float32)
    jpix, jvis = jm.project(jnp.asarray(pts))
    tpix, tvis = tm.project(_t(pts))
    np.testing.assert_allclose(tpix.numpy(), np.asarray(jpix), atol=1e-5)
    assert tvis.numpy().tolist() == np.asarray(jvis).tolist()
    pix = np.asarray(jpix, np.float32)
    jrays, jconv = jm.unproject(jnp.asarray(pix))
    trays, tconv = tm.unproject(_t(pix))
    np.testing.assert_allclose(trays.numpy(), np.asarray(jrays), atol=1e-5)
    assert tconv.numpy().tolist() == np.asarray(jconv).tolist()
    np.testing.assert_allclose(trays.numpy()[:, :2], pts[:, :2] / pts[:, 2:],
                               atol=1e-5)


def test_transforms_match_jax():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(16, 4)).astype(np.float32)
    np.testing.assert_allclose(ttf.quat_to_matrix(_t(q)).numpy(),
                               np.asarray(jtf.quat_to_matrix(jnp.asarray(q))),
                               atol=1e-5)
    ang = rng.uniform(-3.0, 3.0, (3, 16)).astype(np.float32)
    rot_t = ttf.euler_to_matrix(*(_t(a) for a in ang))
    rot_j = jtf.euler_to_matrix(*(jnp.asarray(a) for a in ang))
    np.testing.assert_allclose(rot_t.numpy(), np.asarray(rot_j), atol=1e-5)
    np.testing.assert_allclose(ttf.matrix_to_yaw(rot_t).numpy(),
                               np.asarray(jtf.matrix_to_yaw(rot_j)), atol=1e-5)
    theta = rng.uniform(-20, 20, 64).astype(np.float32)
    np.testing.assert_allclose(ttf.wrap_angle(_t(theta)).numpy(),
                               np.asarray(jtf.wrap_angle(jnp.asarray(theta))),
                               atol=1e-5)
    np.testing.assert_allclose(ttf.smoothstep(_t(theta / 20)).numpy(),
                               np.asarray(jtf.smoothstep(jnp.asarray(theta / 20))),
                               atol=1e-6)
    offs = (0.3, -0.1, 0.8, 5.0, -12.0, 30.0)
    rc_t = ttf.robot_to_cam_from_offsets(*offs, dtype=torch.float32)
    rc_j = jtf.robot_to_cam_from_offsets(*offs, dtype=jnp.float32)
    np.testing.assert_allclose(rc_t.rotation.numpy(), np.asarray(rc_j.rotation),
                               atol=1e-5)
    np.testing.assert_allclose(rc_t.translation.numpy(),
                               np.asarray(rc_j.translation), atol=1e-5)
    pts = rng.normal(size=(16, 3)).astype(np.float32)
    se_t = ttf.SE3(rot_t, _t(pts))
    se_j = jtf.SE3(rot_j, jnp.asarray(pts))
    comp_t = se_t.inverse().compose(se_t)
    comp_j = se_j.inverse().compose(se_j)
    np.testing.assert_allclose(comp_t.rotation.numpy(),
                               np.asarray(comp_j.rotation), atol=1e-5)
    np.testing.assert_allclose(se_t.apply(_t(pts)).numpy(),
                               np.asarray(se_j.apply(jnp.asarray(pts))),
                               atol=1e-5)


def _rendered_rays(layout_j, tag_ids, robot_xy, robot_yaw, rc):
    """Camera rays of the given tags' corners seen from a robot pose: the
    corners go through the JAX camera model in float32 and back."""
    model = jcam.OpenCVModel5.from_dict(CALIB, dtype=jnp.float32)
    c, s = np.cos(robot_yaw), np.sin(robot_yaw)
    w2r_rot = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], np.float32)
    w2r_t = -w2r_rot @ np.array([*robot_xy, 0.0], np.float32)
    w2c = rc.compose(jtf.SE3(jnp.asarray(w2r_rot), jnp.asarray(w2r_t)))
    pose = layout_j.tag_pose(jnp.asarray(tag_ids))
    pc = w2c.apply(jax_corners_world(pose))  # [T, 4, 3]
    pix, vis = model.project(pc)
    assert bool(jnp.all(vis))
    rays, conv = model.unproject(pix)
    assert bool(jnp.all(conv))
    return (np.asarray(pose.rotation, np.float32),
            np.asarray(pose.translation, np.float32),
            np.asarray(rays, np.float32))


@pytest.mark.parametrize("gyro_error", [0.0, 0.3])
def test_solve_robot_pose_matches_jax(gyro_error):
    """A truthful gyro recovers the true pose; a 0.3 rad gyro error
    pivots it (full parity either way)."""
    with open(FIELD) as f:
        layout_j = jax_layout(json.load(f), dtype=jnp.float32)
    rc = jtf.robot_to_cam_from_offsets(0, 0, 1.0, 0, 0, 0, dtype=jnp.float32)
    robot_xy, yaw = (8.6, 4.0), 0.05
    rot, trans, rays = _rendered_rays(layout_j, [1, 2], robot_xy, yaw, rc)
    # pad to 4 tag slots: two real, two masked out
    rot = np.concatenate([rot, np.stack([np.eye(3, dtype=np.float32)] * 2)])
    trans = np.concatenate([trans, np.zeros((2, 3), np.float32)])
    rays = np.concatenate([rays, np.full((2, 4, 3), 7.0, np.float32)])
    mask = np.array([True, True, False, False])
    rc_rot = np.asarray(rc.rotation, np.float32)[None]
    rc_t = np.asarray(rc.translation, np.float32)[None]
    g = np.array([yaw + gyro_error], np.float32)
    want = solve_robot_pose_batched(rot[None], trans[None], mask[None],
                                    rays[None], rc_rot, rc_t, g)
    got = solve_robot_pose(_t(rot[None]), _t(trans[None]), _t(mask[None]),
                           _t(rays[None]), ttf.SE3(_t(rc_rot), _t(rc_t)), _t(g))
    assert got.valid.numpy().tolist() == np.asarray(want.valid).tolist() == [True]
    np.testing.assert_allclose(got.position.numpy(), np.asarray(want.position),
                               atol=1e-4)
    np.testing.assert_allclose(got.rotation.numpy(), np.asarray(want.rotation),
                               atol=1e-4)
    if gyro_error == 0.0:
        np.testing.assert_allclose(got.position.numpy()[0, :2], robot_xy,
                                   atol=2e-3)
