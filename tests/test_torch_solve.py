"""Host side of the solve kernel (``ops/solve.py``, ``csrc/solve.cu``).

The kernel itself runs only on a card (``chip_smoke.py`` holds it to the
plain twin there, bit for bit). Here: the shape function that sizes its
CTA and refuses too many tags, the C entries' arity against
``ops/build.py::_SIGNATURES``, the frame strides the wrapper passes for
the detector's sliced outputs, and that CPU tensors take the plain twin,
unchanged, and never the kernel's entry.
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
    raise AssertionError("a CPU tensor reached the kernel's entry")


def test_frame_solver_cpu_takes_the_plain_twin(frame_inputs, monkeypatch):
    """``FrameSolver.forward`` on CPU tensors is ``forward_plain``,
    bit for bit, and never calls the kernel's entry."""
    layout, dets, params, rc_rot, rc_t, gyro = frame_inputs
    solver = pipeline.make_frame_solver(layout)
    monkeypatch.setattr(pipeline, "solve_frames", _refuse)
    got, n = solver(dets, params, rc_rot, rc_t, gyro)
    want, n_want = solver.forward_plain(dets, params, rc_rot, rc_t, gyro)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(n, n_want) and n.tolist() == [4, 4]
    assert got.valid.tolist() == [True, True]
    for b in range(2):
        assert math.hypot(float(got.position[b, 0]) - ROBOT[0],
                          float(got.position[b, 1]) - ROBOT[1]) < 0.01


@pytest.mark.parametrize("entry", ["solve_frames"])
def test_kernel_entries_refuse_cpu_tensors(frame_inputs, entry):
    """The kernel's entry takes CUDA tensors or raises: no plain path
    hides behind it."""
    layout, dets, params, rc_rot, rc_t, gyro = frame_inputs
    with pytest.raises(ValueError, match="unsupported device"):
        getattr(S, entry)(dets.ids, dets.corners, dets.valid,
                          dets.decision_margins, layout.rotations,
                          layout.translations, layout.present, params,
                          rc_rot, rc_t, gyro, tag_size=0.1651,
                          sign_flip=600.0, decision_margin_min=0.0,
                          max_iter=15)
