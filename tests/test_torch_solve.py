"""Host side of the solve kernel (``ops/solve.py``, ``csrc/solve.cu``).

The kernel itself runs only on a card (``chip_smoke.py`` holds it to the
plain twin there, bit for bit). Here: the shape function that sizes its
CTA and refuses too many tags, the C entries' arity against
``ops/build.py::_SIGNATURES``, the frame strides the wrapper passes for
the detector's sliced outputs, that CPU tensors take the plain twin
(``solver/robot_pose.py::solve_frames_plain``), unchanged, and never the
kernel library, and the plain twin at four
cameras against the float64 oracle. On a card (marked ``cuda``, skipped
without one): the kernel equals the plain chain bit for bit at [4, 16]
on the four-camera benchmark rig's drive.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import re

import pytest
import torch

import chalkydri_tpu_torch.pipeline as pipeline
from chalkydri_tpu_torch.geometry.field_layout import load_field_layout
from chalkydri_tpu_torch.ops import build
from chalkydri_tpu_torch.ops import solve as S
from chalkydri_tpu_torch.pipeline import build_rig_from_config
from chalkydri_tpu_torch.solver.robot_pose import solve_frames_plain
from chalkydri_tpu_torch.tools.scenes import (
    FIELD_JSON,
    MOUNT,
    SCENES,
    TAGS,
    projected_detections,
)

T = 16  # the detector's slots a frame


@pytest.mark.parametrize("t,threads", [(1, 256), (16, 256), (33, 256),
                                       (S.MAX_TAGS, 256)])
def test_solve_threads(t, threads):
    """A warp a candidate (8), at least a thread a corner."""
    assert S.solve_threads(t) == threads
    assert threads % 32 == 0 and threads >= 4 * t
    assert threads // 32 >= S.N_CAND


@pytest.mark.parametrize("t", [0, -1, S.MAX_TAGS + 1, 1000])
def test_solve_threads_refuses(t):
    with pytest.raises(ValueError):
        S.solve_threads(t)


def _c_params(entry: str) -> list:
    """The ctypes types of ``entry``'s parameters as its source declares
    them: pointers, doubles and ints."""
    src = "".join(open(os.path.join(build.CSRC_DIR, s)).read()
                  for s in build.SOURCES)
    m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src)
    assert m is not None, f"{entry} is not in csrc/"
    types = []
    for p in m.group(1).split(","):
        if "*" in p:
            types.append(ctypes.c_void_p)
        elif "double" in p:
            types.append(ctypes.c_double)
        else:
            types.append(ctypes.c_int)
    return types


@pytest.mark.parametrize("entry", sorted(build._SIGNATURES))
def test_signature_matches_source(entry):
    """ctypes passes what each C entry declares, in its order: a pointer
    as a 32-bit int, or a double as an int, would be cut."""
    assert build._SIGNATURES[entry] == _c_params(entry)


@pytest.mark.parametrize("case", ["contiguous", "slice of a wider buffer",
                                  "one frame"])
def test_rows_passes_the_frame_stride(case):
    """``_rows`` keeps a tensor whose frames are each contiguous (the
    detector's outputs are slices of wider buffers) and returns the
    elements between frames; the kernel reads frame f at f * stride."""
    wide = torch.arange(3 * 20 * 4 * 2, dtype=torch.float32).reshape(3, 20, 4, 2)
    x = {"contiguous": wide[:, :T].contiguous(),
         "slice of a wider buffer": wide[:, :T],
         "one frame": wide[:1, :T]}[case]
    got, stride = S._rows(x, (T, 4, 2))
    assert got.data_ptr() == x.data_ptr()  # no copy
    for f in range(x.shape[0]):
        frame = torch.as_strided(got, (T * 8,), (1,), f * stride)
        assert torch.equal(frame, x[f].reshape(-1))
    assert stride == (T * 8 if case != "slice of a wider buffer" else 20 * 8)


def test_rows_copies_a_frame_that_is_not_contiguous():
    """A frame whose own elements are strided is copied first."""
    x = torch.arange(2 * T * 2, dtype=torch.float32).reshape(2, 2, T)
    x = x.transpose(1, 2)  # [2, T, 2], each frame strided
    got, stride = S._rows(x, (T, 2))
    assert got.is_contiguous() and stride == 2 * T
    assert torch.equal(got, x)


ROBOT = (13.0, 4.0215, 0.0)  # tags 28-31 about 3.5 m ahead


@pytest.fixture(scope="module")
def frame_inputs():
    """Two cameras' detections of tags 28-31 projected through the bench
    lens, the second camera's order reversed with an unknown id, on the
    CPU: (layout, Detections, params, rc_rot, rc_t, gyro)."""
    calib = SCENES["bench"][0]
    layout = load_field_layout(FIELD_JSON, dtype=torch.float32)
    cams = [{"calib": json.dumps({"OpenCVModel5": calib}),
             "robot_to_cam": json.dumps(MOUNT)}] * 2
    params, rc = build_rig_from_config(cams, layout, device="cpu")
    dets = projected_detections(layout, rc, ROBOT, calib,
                                [TAGS, TAGS[::-1] + (50,)], capacity=T)
    return layout, dets, params, rc.rotation, rc.translation, torch.zeros(2)


def _refuse(*args, **kwargs):
    raise AssertionError("a CPU tensor reached the kernel library")


def _plain(solver, dets, cam_params, rc_rot, rc_t, gyro):
    """The plain twin of ``solver``'s solve: (``RobotPoseResult``,
    n_tags)."""
    *res, n_tags = solve_frames_plain(
        dets.ids, dets.corners, dets.valid, dets.decision_margins,
        solver.rot_table, solver.t_table, solver.present, cam_params, rc_rot,
        rc_t, gyro, tag_size=solver.tag_size, sign_flip=solver.sign_flip,
        decision_margin_min=solver.decision_margin_min,
        max_iter=pipeline.MAX_ITER)
    return pipeline.RobotPoseResult(*res), n_tags


def test_frame_solver_cpu_takes_the_plain_twin(frame_inputs, monkeypatch):
    """``FrameSolver.forward`` on CPU tensors is the plain twin
    (``solve_frames_plain``), bit for bit, and never reaches the kernel
    library."""
    layout, dets, params, rc_rot, rc_t, gyro = frame_inputs
    solver = pipeline.make_frame_solver(layout)
    monkeypatch.setattr(build, "kernel_library", _refuse)
    got, n = solver(dets, params, rc_rot, rc_t, gyro)
    want, n_want = _plain(solver, dets, params, rc_rot, rc_t, gyro)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(n, n_want) and n.tolist() == [4, 4]
    assert got.valid.tolist() == [True, True]
    for b in range(2):
        assert math.hypot(float(got.position[b, 0]) - ROBOT[0],
                          float(got.position[b, 1]) - ROBOT[1]) < 0.01


@pytest.mark.parametrize("entry", ["solve_frames"])
def test_kernel_entries_refuse_cpu_tensors(frame_inputs, entry,
                                           monkeypatch):
    """CPU tensors never reach the kernel: with the kernel library made to
    raise, the entry returns its plain twin's (rotation, position,
    std_devs, valid, n_tags) bit for bit."""
    layout, dets, params, rc_rot, rc_t, gyro = frame_inputs
    args = (dets.ids, dets.corners, dets.valid, dets.decision_margins,
            layout.rotations, layout.translations, layout.present, params,
            rc_rot, rc_t, gyro)
    kw = dict(tag_size=0.1651, sign_flip=600.0, decision_margin_min=0.0,
              max_iter=15)
    monkeypatch.setattr(build, "kernel_library", _refuse)
    got = getattr(S, entry)(*args, **kw)
    assert len(got) == 5 and got[4].dtype == torch.int32
    torch.testing.assert_close(got, solve_frames_plain(*args, **kw), rtol=0,
                               atol=0)


# -- four cameras: the plain twin at B = 4, and the kernel on a card ---------


ORACLE_FRAMES = ((2, 0), (3, 1), (2, 7), (3, 5))  # (tags, seed) a frame
ORACLE_TOL = 1e-9  # tests/test_torch_gates.py's position, rotation, std


def _oracle_batch():
    """Four of the float64 oracle's scenes (``tests/test_solver.py``) as one
    batch of ``FrameSolver`` inputs: a layout of every frame's tags (frame
    ``f``'s tags take ids ``8 f``, ``8 f + 1``, ...), each frame's
    detections the rays' (x, y) through a unit pinhole, which its
    undistortion returns exactly. Returns (solver, inputs, oracle answers
    [(rotation, position, std-devs)])."""
    import numpy as np

    from chalkydri_tpu_torch.detector.pipeline import Detections
    from chalkydri_tpu_torch.geometry.field_layout import FieldLayout
    from tests.reference_impl.ref_sqpnp import RefSqPnP
    from tests.test_solver import SIGN_FLIP_CONST, make_scene

    slots, b = 8, len(ORACLE_FRAMES)
    rots = np.tile(np.eye(3), (slots * b, 1, 1))
    ts = np.zeros((slots * b, 3))
    present = np.zeros(slots * b, bool)
    ids = torch.full((b, T), -1, dtype=torch.int32)
    corners = torch.zeros(b, T, 4, 2, dtype=torch.float64)
    rc_rot, rc_t, gyro, want = [], [], [], []
    for f, (n_tags, seed) in enumerate(ORACLE_FRAMES):
        rng = np.random.default_rng(seed)
        isometries, rays, rc = make_scene(rng, n_tags=n_tags)
        g = rng.uniform(-np.pi, np.pi)
        want.append(RefSqPnP().solve_robot_pose(isometries, rays, rc, g,
                                                SIGN_FLIP_CONST))
        for k, (r, t) in enumerate(isometries):
            rots[slots * f + k], ts[slots * f + k] = r, t
            present[slots * f + k] = True
            ids[f, k] = slots * f + k
        corners[f, :n_tags] = torch.from_numpy(
            np.asarray(rays)[:, :2]).reshape(n_tags, 4, 2)
        rc_rot.append(rc[0])
        rc_t.append(rc[1])
        gyro.append(g)
    layout = FieldLayout(torch.from_numpy(rots), torch.from_numpy(ts),
                         torch.from_numpy(present), (0.0, 0.0))
    dets = Detections(ids, corners, torch.full((b, T), 50.0,
                                               dtype=torch.float64),
                      torch.zeros(b, T, dtype=torch.int32), ids >= 0,
                      torch.zeros(b, dtype=torch.int32))
    cam = torch.tensor([[1.0, 1.0] + [0.0] * 7] * b, dtype=torch.float64)
    inputs = (dets, cam, torch.from_numpy(np.stack(rc_rot)),
              torch.from_numpy(np.stack(rc_t)),
              torch.tensor(gyro, dtype=torch.float64))
    return pipeline.FrameSolver(layout, dtype=torch.float64), inputs, want


def test_plain_twin_at_four_cameras_matches_the_f64_oracle():
    """The plain twin (``solve_frames_plain``) over a batch of four
    cameras, each frame its own oracle scene, in float64: every frame
    within the gates' 1e-9 of the numpy oracle, as at one camera."""
    solver, inputs, want = _oracle_batch()
    out, n_tags = _plain(solver, *inputs)
    assert n_tags.tolist() == [n for n, _ in ORACLE_FRAMES]
    assert out.valid.tolist() == [True] * len(ORACLE_FRAMES)
    for f, (rot, pos, std) in enumerate(want):
        torch.testing.assert_close(out.position[f], torch.from_numpy(pos),
                                   atol=ORACLE_TOL, rtol=0)
        torch.testing.assert_close(out.rotation[f], torch.from_numpy(rot),
                                   atol=ORACLE_TOL, rtol=0)
        torch.testing.assert_close(out.std_devs[f], torch.from_numpy(std),
                                   rtol=ORACLE_TOL, atol=0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_equals_the_plain_chain_at_four_cameras(card):
    """On a card, the solve kernel is the plain chain bit for bit at
    [4, 16], float32, on the four-camera benchmark rig's rendered drive
    (``benchmark/configs/north-4x1280x800-qd2.json``), as at [2, 16]: the
    benchmark's ``correct`` rests on it. The check is ``chip_smoke.py``'s,
    which holds every configuration's drives at five seeds; here one."""
    import chip_smoke

    drives, shape_of, _ = chip_smoke.solve_drives(
        card, seeds=chip_smoke.SOLVE_SEEDS[:1],
        names=("north-4x1280x800-qd2",))
    assert shape_of == {"north-4x1280x800-qd2": (4, T)}
    gaps = drives[(4, T)]
    gaps.check("solve drives at [4, 16]")
    assert gaps.frames == 4 * 14 and gaps.same == gaps.frames
