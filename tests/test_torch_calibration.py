"""The port's camera calibration (``chalkydri_tpu_torch/tools/calibration.py``)
against the JAX package's, on the CPU (the port with ``device="cpu"``,
JAX under the suite's x64 mode):

- the host init (``_homography``, ``_zhang_init``, ``_pose_from_homography``)
  is the same numpy code: equal bit for bit;
- ``calibrate_camera`` on the synthetic views of ``tests/test_calibration.py``
  (clean, noisy, and the stress lenses clean and noisy): every parameter
  within ``SOLVE_RTOL`` relative (against max(|p|, 1e-3), since a
  distortion term may be near 0) and the RMS likewise. Largest difference
  measured: 7.1e-8 (the port's float64 Gauss-Newton differs from JAX's
  only in the order of its float64 sums);
- ``Calibrator.process_frame`` over the port's detector and over JAX's on
  5 rendered 640x480 aprilgrid views (``tools/scenes.py::board_views``):
  the same views accepted with the same board points, image corners
  within ``CORNER_TOL`` (the detector parity corpus tolerance); the
  port's solve on JAX's features within ``SOLVE_RTOL`` of JAX's, and each
  side's solve of its own features within ``OWN_FEATURES_RTOL`` (the
  corner differences move the weakly observed distortion terms: measured
  1.6e-6 on fx..cy, 3.2e-4 on k1..k3, 8e-6 on the RMS);
- the calib JSON string, the MIN_CORNERS gate and the CalibrationMonitor
  (cv2) equal JAX's."""

import json

import numpy as np
import pytest
import torch

from chalkydri_tpu.tools import calibration as J
from chalkydri_tpu_torch.tools import calibration as T
from tests import test_calibration as jax_tests
from tests.test_calibration import synth_views

torch.set_num_threads(1)

SOLVE_RTOL = 1e-6
CORNER_TOL = 1.6e-4  # px
# (fx..cy, k1..k3, rms) for each side's solve of its own features
OWN_FEATURES_RTOL = (1e-5, 1e-3, 1e-4)

CASES = {"clean": dict(), "noisy": dict(n_frames=16, noise=0.3)}
for _lens, _p in jax_tests.TestCalibration.STRESS.items():
    CASES[f"{_lens}-clean"] = dict(n_frames=16, params=_p, seed=3)
    CASES[f"{_lens}-noisy"] = dict(n_frames=20, params=_p, noise=0.5, seed=4)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-3)


def test_host_init_bit_identical():
    feats = synth_views(n_frames=6, noise=0.3, seed=5)
    for f in feats:
        assert np.array_equal(T._homography(f.points_3d, f.points_2d),
                              J._homography(f.points_3d, f.points_2d))
    k_t, k_j = T._zhang_init(feats), J._zhang_init(feats)
    assert np.array_equal(k_t, k_j)
    kmat = np.array([[k_j[0], 0, k_j[2]], [0, k_j[1], k_j[3]], [0, 0, 1]])
    for f in feats:
        h = J._homography(f.points_3d, f.points_2d)
        (rt, tt), (rj, tj) = (T._pose_from_homography(kmat, h),
                              J._pose_from_homography(kmat, h))
        assert np.array_equal(rt, rj) and np.array_equal(tt, tj)
        assert np.array_equal(T._rvec_from_matrix(rt), J._rvec_from_matrix(rj))


@pytest.mark.parametrize("case", sorted(CASES))
def test_calibrate_camera_matches_jax(case):
    feats = synth_views(**CASES[case])
    want = J.calibrate_camera(feats)
    got = T.calibrate_camera(feats, device="cpu")
    assert got.n_frames == want.n_frames
    assert got.params.dtype == np.float64
    assert _rel(got.params, want.params).max() <= SOLVE_RTOL
    assert _rel(got.rms_px, want.rms_px) <= SOLVE_RTOL


def test_too_few_frames():
    with pytest.raises(ValueError):
        T.calibrate_camera(synth_views(n_frames=2), device="cpu")


def test_feature_from_detections_matches_jax():
    board = T.aprilgrid_board_corners()
    assert all(np.array_equal(board[k], v)
               for k, v in J.aprilgrid_board_corners().items())
    rng = np.random.default_rng(0)
    for n in (5, 6, 9):  # 20 corners are rejected, 24 and 36 accepted
        ids = np.concatenate([rng.permutation(36)[:n], [-1, 77]])
        corners = rng.uniform(0, 640, (len(ids), 4, 2))
        got = T.feature_from_detections(ids, corners, board)
        want = J.feature_from_detections(ids, corners, board)
        assert (got is None) == (want is None) == (n < 6)
        if got is not None:
            assert len(got.points_3d) == 4 * n
            assert np.array_equal(got.points_3d, want.points_3d)
            assert np.array_equal(got.points_2d, want.points_2d)


def test_result_to_json_matches_jax():
    feats = synth_views()
    got = T.calibrate_camera(feats, device="cpu")
    want = J.calibrate_camera(feats)
    # the same nine numbers give the same string (key order, float repr)
    same = J.CalibrationResult(params=got.params, rms_px=got.rms_px,
                               n_frames=got.n_frames)
    s = got.to_model(1280, 720, device="cpu").to_json()
    assert s == same.to_model(1280, 720).to_json()
    assert json.loads(s)["OpenCVModel5"]["width"] == 1280
    m2 = T.OpenCVModel5.from_json(s)
    assert np.array_equal(m2.params.numpy(), got.params)
    assert _rel(m2.params.numpy(), want.params).max() <= SOLVE_RTOL


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.calibrate_camera(synth_views(n_frames=3))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.Calibrator()


@pytest.fixture(scope="module")
def calibrators():
    """(port Calibrator, JAX Calibrator, acceptance lists) after 5 rendered
    640x480 views of the aprilgrid."""
    from chalkydri_tpu_torch.tools.scenes import CALIB_LENS, board_views

    lens = dict(CALIB_LENS, cx=320.0, cy=240.0, width=640, height=480)
    frames, _, _ = board_views(5, lens, seed=2, distance=(0.5, 0.6))
    port, jax_cal = T.Calibrator(device="cpu"), J.Calibrator()
    got = [port.process_frame(f) for f in frames]
    want = [jax_cal.process_frame(f) for f in frames]
    return port, jax_cal, got, want


def test_calibrator_views_match_jax(calibrators):
    port, jax_cal, got, want = calibrators
    assert got == want == [True] * 5
    assert len(port.features) == len(jax_cal.features) == 5
    for a, b in zip(port.features, jax_cal.features):
        assert np.array_equal(a.points_3d, b.points_3d)  # same ids, same order
        np.testing.assert_allclose(a.points_2d, b.points_2d, atol=CORNER_TOL,
                                   rtol=0)


def test_calibrator_solve_matches_jax(calibrators):
    port, jax_cal, _, _ = calibrators
    want = jax_cal.calibrate()
    same = T.calibrate_camera(jax_cal.features, device="cpu")
    assert _rel(same.params, want.params).max() <= SOLVE_RTOL
    own = port.calibrate()
    tol_k, tol_d, tol_rms = OWN_FEATURES_RTOL
    assert _rel(own.params[:4], want.params[:4]).max() <= tol_k
    assert _rel(own.params[4:], want.params[4:]).max() <= tol_d
    assert _rel(own.rms_px, want.rms_px) <= tol_rms


def test_calibration_monitor_matches_jax():
    pytest.importorskip("cv2")
    from chalkydri_tpu.subsystems.calib_viz import CalibrationMonitor as JMon
    from chalkydri_tpu_torch.subsystems.calib_viz import CalibrationMonitor

    def fake_detect(n):
        base = 40 + 60 * (n % 4)
        ids, corners = [], []
        for t in range(9):
            r, c = divmod(t, 3)
            x0, y0 = base + c * 90, 40 + r * 90
            ids.append(t)
            corners.append([[x0, y0 + 20], [x0 + 20, y0 + 20], [x0 + 20, y0],
                            [x0, y0]])
        return np.array(ids), np.array(corners, np.float32)

    mons = []
    for mon, cal in ((CalibrationMonitor(), T.Calibrator(detector=object(),
                                                         device="cpu")),
                     (JMon(), J.Calibrator(detector=object()))):
        cal.monitor = mon
        calls = iter(range(6))
        cal._detect = lambda frame, _c=calls: fake_detect(next(_c))
        frame = np.full((480, 640), 128, np.uint8)
        assert all(cal.process_frame(frame) for _ in range(6))
        mon.on_result(rms_px=0.123, n_frames=6)
        mons.append(mon)
    got, want = mons
    assert got.frames_accepted == want.frames_accepted == 6
    assert np.array_equal(got.coverage(), want.coverage())
    assert got.coverage_fraction() == want.coverage_fraction() > 0.15
    assert len(got.ring) == len(want.ring) >= 1
    assert got.ring.latest()[1] == want.ring.latest()[1]  # the same JPEG
    assert got.result_rms == pytest.approx(0.123)
