"""The reference's gates, held on the port alone (no JAX run here):

- the detector on the 56-scene parity corpus (``tests/reference_impl/
  corpus.py``) against the checked-in golden file
  ``tests/golden/aruco_apriltag_refine.json`` (read only), with the gates
  of ``tests/test_detector.py::test_corpus_vs_golden_refined``: every
  golden tag found, corner RMS median < 1.0 px and p90 < 1.6 px, decision
  margins in libapriltag's scale; and corpus scene 18's texture flood,
  which only ``capacity_fallback`` recovers;
- ``solve_robot_pose`` against the float64 oracle
  ``tests/reference_impl/ref_sqpnp.py::RefSqPnP`` on the 16 seeds of
  ``tests/test_solver.py::test_matches_numpy_reference``, the distrust
  gate, too few points and the gyro pivot;
- ``TestFusedPipeline``'s cases (``tests/test_pipeline.py``) on a scene of
  the port's own renderer (``tools/scenes.py``): an unknown tag is
  ignored, the planar mirror holds over 6 orderings of the detections,
  and a frame without tags gives an invalid pose.

Tolerances against the oracle: position 1e-9 m and rotation 1e-9 (the
largest differences measured on these seeds: 3.3e-10 m and 1.1e-10),
std-devs 1e-9 relative. The port's detector against JAX's on the corpus
(measured when the port was first held to the reference): corners within
1.6e-4 px, margins within 5.4e-5."""

import json
import math
import os

import numpy as np
import pytest
import torch

from chalkydri_tpu_torch.detector.pipeline import make_detector
from chalkydri_tpu_torch.geometry.camera import OpenCVModel5
from chalkydri_tpu_torch.geometry.field_layout import load_field_layout
from chalkydri_tpu_torch.geometry.transforms import SE3
from chalkydri_tpu_torch.pipeline import build_rig_from_config, make_vision_pipeline
from chalkydri_tpu_torch.solver.robot_pose import solve_robot_pose
from chalkydri_tpu_torch.tools.scenes import FIELD_JSON, SCENES, TAGS, place_tag, render_scene
from tests.reference_impl.ref_sqpnp import RefSqPnP
from tests.test_solver import SIGN_FLIP_CONST, make_scene

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "aruco_apriltag_refine.json")
POS_TOL, ROT_TOL, STD_RTOL = 1e-9, 1e-9, 1e-9
MAX_TAGS = 8


def _cyclic_corner_rms(their_c, our_c) -> float:
    """Corner RMS under the best of the 8 rigid quad assignments (4 cyclic
    shifts x both windings), as the JAX suite's gate."""
    best = np.inf
    for oc in (our_c, our_c[::-1]):
        for shift in range(4):
            d = np.linalg.norm(their_c - np.roll(oc, shift, axis=0), axis=-1)
            best = min(best, float(np.sqrt((d ** 2).mean())))
    return best


@pytest.fixture(scope="module")
def corpus():
    from tests.reference_impl.corpus import build_parity_corpus

    return build_parity_corpus(56)


def test_corpus_vs_golden_refined(corpus):
    with open(GOLDEN) as f:
        golden = json.load(f)
    assert len(golden["scenes"]) == len(corpus)
    frames = torch.from_numpy(np.stack([c for c, _ in corpus]))
    out = make_detector(capacity_fallback=True, device="cpu")(frames)
    ids, corners = out.ids.numpy(), out.corners.numpy()
    valid, margins_all = out.valid.numpy(), out.decision_margins.numpy()
    n_oracle = n_matched = 0
    rms, margins = [], []
    for s, entry in enumerate(golden["scenes"]):
        ours = {int(ids[s, i]): (corners[s, i], float(margins_all[s, i]))
                for i in np.where(valid[s])[0]}
        for det in entry["detections"]:
            n_oracle += 1
            if det["id"] not in ours:
                continue
            n_matched += 1
            oc, mg = ours[det["id"]]
            rms.append(_cyclic_corner_rms(np.asarray(det["corners"]), oc))
            margins.append(mg)
    assert n_oracle >= 50
    assert n_matched == n_oracle, f"matched {n_matched}/{n_oracle}"
    rms, margins = np.array(rms), np.array(margins)
    assert np.median(rms) < 1.0 and np.quantile(rms, 0.9) < 1.6
    assert margins.min() > 100.0 and 110.0 < np.median(margins) <= 128.0


def test_capacity_fallback_recovers_flooded_scene(corpus):
    canvas, gts = corpus[18]
    assert 471 in gts
    frames = torch.from_numpy(canvas[None])
    base = make_detector(device="cpu")(frames)
    assert int(base.dropped_points[0]) > 0
    assert 471 not in base.ids[0][base.valid[0]].tolist()
    out = make_detector(capacity_fallback=True, device="cpu")(frames)
    assert 471 in out.ids[0][out.valid[0]].tolist()
    assert int(out.dropped_points[0]) == 0


def _padded(isometries, rays):
    """One frame's tags padded to MAX_TAGS, as a batch of one (float64)."""
    rots = np.stack([np.eye(3)] * MAX_TAGS)
    ts = np.zeros((MAX_TAGS, 3))
    mask = np.zeros(MAX_TAGS, bool)
    cam = np.zeros((MAX_TAGS, 4, 3))
    for i, (r, t) in enumerate(isometries):
        rots[i], ts[i], mask[i] = r, t, True
        cam[i] = rays[4 * i:4 * i + 4]
    return tuple(torch.from_numpy(a)[None] for a in (rots, ts, mask, cam))


def _solve(isometries, rays, rc, gyro):
    rots, ts, mask, cam = _padded(isometries, rays)
    return solve_robot_pose(
        rots, ts, mask, cam,
        SE3(torch.from_numpy(np.asarray(rc[0]))[None],
            torch.from_numpy(np.asarray(rc[1]))[None]),
        torch.tensor([gyro], dtype=torch.float64))


@pytest.mark.parametrize("n_tags,seed", [(2, s) for s in (0, 1, 2, 3, 4, 7, 8, 9)]
                         + [(3, s) for s in (0, 1, 2, 3, 4, 5, 7, 8)])
def test_solve_matches_f64_oracle(n_tags, seed):
    rng = np.random.default_rng(seed)
    isometries, rays, rc = make_scene(rng, n_tags=n_tags)
    gyro = rng.uniform(-np.pi, np.pi)
    ref_rot, ref_pos, ref_std = RefSqPnP().solve_robot_pose(
        isometries, rays, rc, gyro, SIGN_FLIP_CONST)
    out = _solve(isometries, rays, rc, gyro)
    assert bool(out.valid[0])
    np.testing.assert_allclose(out.position[0].numpy(), ref_pos, atol=POS_TOL, rtol=0)
    np.testing.assert_allclose(out.rotation[0].numpy(), ref_rot, atol=ROT_TOL, rtol=0)
    np.testing.assert_allclose(out.std_devs[0].numpy(), ref_std, rtol=STD_RTOL, atol=0)


def test_distrust_gate():
    rng = np.random.default_rng(3)
    isometries, rays, rc = make_scene(rng, n_tags=2, noise=0.2)
    out = _solve(isometries, rays, rc, 0.0)
    assert float(out.std_devs[0, 0]) > 1e30


def test_too_few_points_invalid():
    out = solve_robot_pose(
        torch.eye(3, dtype=torch.float64).expand(1, MAX_TAGS, 3, 3),
        torch.zeros(1, MAX_TAGS, 3, dtype=torch.float64),
        torch.zeros(1, MAX_TAGS, dtype=torch.bool),
        torch.zeros(1, MAX_TAGS, 4, 3, dtype=torch.float64),
        SE3(torch.eye(3, dtype=torch.float64)[None],
            torch.zeros(1, 3, dtype=torch.float64)),
        torch.zeros(1, dtype=torch.float64))
    assert not bool(out.valid[0])


def test_gyro_pivot_full_at_large_delta():
    rng = np.random.default_rng(13)
    isometries, rays, rc = make_scene(rng, n_tags=2)
    gyro = np.radians(45.0)  # the true yaw is 0
    out = _solve(isometries, rays, rc, gyro)
    rot = out.rotation[0].numpy()
    np.testing.assert_allclose(np.arctan2(rot[1, 0], rot[0, 0]), gyro,
                               atol=1e-9, rtol=0)


# -- TestFusedPipeline's cases on the port's own scene -----------------------

ROBOT = (13.0, 4.0215, 0.0)  # x m, y m, yaw rad: tags 28-31 about 3.5 m ahead


@pytest.fixture(scope="module")
def bench():
    """(layout, cams, params, rc, frame): tags 28-31 of the 2026 layout
    through the bench lens (1280x800, fx = fy = 1100, 1 m up)."""
    calib, _, mount = SCENES["bench"]
    layout = load_field_layout(FIELD_JSON, dtype=torch.float32)
    cams = [{"calib": json.dumps({"OpenCVModel5": calib}),
             "robot_to_cam": json.dumps(mount)}]
    params, rc = build_rig_from_config(cams, layout, device="cpu")
    frame = render_scene(layout, rc, *ROBOT, calib)
    return layout, params, rc, frame


def test_unknown_tag_ignored(bench):
    """A detected id absent from the layout (50) does not enter the solve."""
    from chalkydri_tpu_torch.detector.families import load_family, render_tag

    layout, params, rc, frame = bench
    assert not bool(layout.present[50])
    frame = frame.copy()
    corners = np.array([[60.0, 200.0], [200.0, 200.0], [200.0, 60.0],
                        [60.0, 60.0]])
    place_tag(frame, render_tag(load_family("tag36h11"), 50, cell_px=16), 16,
              corners)
    step = make_vision_pipeline(layout, params, rc, device="cpu")
    out = step(torch.from_numpy(frame)[None], torch.zeros(1))
    ids = set(out.detections.ids[0][out.detections.valid[0]].tolist())
    assert ids == {50, *TAGS}
    assert int(out.tag_count[0]) == len(TAGS)
    assert abs(float(out.pose_x[0]) - ROBOT[0]) < 0.02
    assert abs(float(out.pose_y[0]) - ROBOT[1]) < 0.02


def test_planar_mirror_ambiguity_all_orderings(bench):
    """The fronto-parallel tag wall (the planar two-fold ambiguity's worst
    case) solves to the true pose for 6 orderings of the detections."""
    layout, params, rc, frame = bench
    out = make_detector(device="cpu")(torch.from_numpy(frame)[None])
    ids = out.ids[0]
    idx = ids.clamp(0, len(layout.present) - 1)
    rays, conv = OpenCVModel5(params[0]).unproject(out.corners[0])
    known = out.valid[0] & layout.present[idx] & (ids >= 0) & conv.all(dim=-1)
    assert int(known.sum()) == len(TAGS)
    rng = np.random.default_rng(3)
    for trial in range(6):
        perm = torch.from_numpy(rng.permutation(len(ids)))
        res = solve_robot_pose(
            layout.rotations[idx][perm][None], layout.translations[idx][perm][None],
            known[perm][None], rays[perm][None].to(torch.float32),
            SE3(rc.rotation[:1], rc.translation[:1]), torch.zeros(1))
        pos = res.position[0].numpy()
        assert bool(res.valid[0]), trial
        assert math.hypot(pos[0] - ROBOT[0], pos[1] - ROBOT[1]) < 0.02, (trial, pos)
        assert abs(pos[2]) < 0.05, (trial, pos)


def test_no_tags_invalid(bench):
    layout, params, rc, frame = bench
    step = make_vision_pipeline(layout, params, rc, device="cpu")
    out = step(torch.full((1, *frame.shape), 150, dtype=torch.uint8), torch.zeros(1))
    assert not bool(out.pose_valid[0])
    assert int(out.tag_count[0]) == 0
