"""The solve stage as one CUDA kernel (``csrc/solve.cu``).

``solve_frames`` computes ``pipeline.FrameSolver.forward`` (the id
lookup, the undistortion, SQPnP and the robot pose), a CTA a frame, in
one launch where ``build.on_card`` says so, and returns its plain twin's
result (``solver/robot_pose.py::solve_frames_plain``) elsewhere. The
kernel replaces no TPU kernel (the JAX package's solver is
plain ``jnp`` under ``jit``); it repeats the plain chain's arithmetic in
the plain chain's order, so that on the card the two agree bit for bit at
the step's shape (float32; the double instance for the float64 oracle).

Launches are counted in ``solve_frames.launches``
(``ops/build.py::count``).
"""

from __future__ import annotations

import ctypes

import torch

from chalkydri_tpu_torch.geometry.camera import UNDISTORT_ITERS
from chalkydri_tpu_torch.geometry.tags import TAG_SIZE
from chalkydri_tpu_torch.ops import build
from chalkydri_tpu_torch.solver.robot_pose import solve_frames_plain

MAX_TAGS = 64  # tag slots a frame (csrc/solve.cu::MAX_TAGS)
N_EIGVECS = 4  # solver/sqpnp.py::solve_candidates's eigenvectors
N_CAND = 2 * N_EIGVECS  # each eigenvector x {-1, +1}


def solve_threads(t: int) -> int:
    """Threads of the kernel's CTA for ``t`` tag slots a frame: a warp a
    rotation candidate and at least a thread a tag corner. Raises outside
    1..``MAX_TAGS``."""
    if not 1 <= t <= MAX_TAGS:
        raise ValueError(f"solve: {t} tag slots a frame, the kernel takes "
                         f"1 to {MAX_TAGS}")
    return 32 * max(N_CAND, -(-4 * t // 32))


def _dtype(*tensors) -> torch.dtype:
    dtype = tensors[0].dtype
    for x in tensors[1:]:
        dtype = torch.promote_types(dtype, x.dtype)
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"solve: floating inputs of {dtype}, the kernel "
                         f"takes float32 or float64")
    return dtype


def _rows(x: torch.Tensor, inner: tuple) -> tuple[torch.Tensor, int]:
    """``x`` [B, *inner] with each frame contiguous, and the elements
    between frames: the detector's outputs are slices of wider buffers,
    so a frame stride is passed rather than a copy made."""
    n, stride = 1, []
    for s in reversed(inner):
        stride.insert(0, n)
        n *= s
    if tuple(x.stride()[1:]) != tuple(stride) and n > 1:
        x = x.contiguous()
    return x, x.stride(0) if x.shape[0] > 1 else n


def solve_frames(ids, corners, valid, margins, rot_table, t_table, present,
                 cam_params, rc_rot, rc_t, gyro, *, tag_size: float,
                 sign_flip: float, decision_margin_min: float,
                 max_iter: int):
    """``FrameSolver.forward`` on the card: detections ids [B, T] int32,
    corners [B, T, 4, 2], valid [B, T] bool, margins [B, T]; the layout's
    rot_table [L, 3, 3], t_table [L, 3], present [L] bool; per camera
    cam_params [B, 9], rc_rot [B, 3, 3], rc_t [B, 3], gyro [B]. Returns
    (rotation [B, 3, 3], position [B, 3], std_devs [B, 3], valid [B],
    n_tags [B] int32), in the floating inputs' promoted dtype on the
    kernel's route."""
    args = (ids, corners, valid, margins, rot_table, t_table, present,
            cam_params, rc_rot, rc_t, gyro)
    if not build.on_card(ids):
        return solve_frames_plain(
            *args, tag_size=tag_size, sign_flip=sign_flip,
            decision_margin_min=decision_margin_min, max_iter=max_iter)
    build.same_device("solve_frames", *args)
    b, t = ids.shape
    if (tuple(corners.shape) != (b, t, 4, 2) or tuple(valid.shape) != (b, t)
            or tuple(margins.shape) != (b, t)):
        raise ValueError("solve_frames: expected ids/valid/margins [B, T] "
                         "and corners [B, T, 4, 2]")
    n_layout = present.shape[0]
    if (n_layout < 1 or tuple(rot_table.shape) != (n_layout, 3, 3)
            or tuple(t_table.shape) != (n_layout, 3)):
        raise ValueError("solve_frames: expected rot_table [L, 3, 3], "
                         "t_table [L, 3] and present [L], L >= 1")
    dtype = _dtype(corners, margins, rot_table, t_table, cam_params, rc_rot,
                   rc_t, gyro)
    solve_threads(t)
    like = corners
    rot, pos, std = (build.empty(shape, dtype, like)
                     for shape in ((b, 3, 3), (b, 3), (b, 3)))
    ok = build.empty((b,), torch.bool, like)
    n_tags = build.empty((b,), torch.int32, like)
    if b == 0:
        return rot, pos, std, ok, n_tags
    corners_, c_rs = _rows(corners.to(dtype), (t, 4, 2))
    margins_, m_rs = _rows(margins.to(dtype), (t,))
    ids_, i_rs = _rows(ids.to(torch.int32), (t,))
    valid_, v_rs = _rows(valid.to(torch.bool), (t,))
    f = [x.to(dtype).contiguous() for x in (rot_table, t_table, cam_params,
                                             rc_rot, rc_t, gyro)]
    for x, shape in ((f[2], (b, 9)), (f[3], (b, 3, 3)), (f[4], (b, 3)),
                     (f[5], (b,))):
        if tuple(x.shape) != shape:
            raise ValueError(f"solve_frames: expected a per-camera {shape}, "
                             f"got {tuple(x.shape)}")
    present_ = present.to(torch.bool).contiguous()
    ptrs = (ctypes.c_void_p * 16)(
        ids_.data_ptr(), corners_.data_ptr(), valid_.data_ptr(),
        margins_.data_ptr(), f[0].data_ptr(), f[1].data_ptr(),
        present_.data_ptr(), f[2].data_ptr(), f[3].data_ptr(),
        f[4].data_ptr(), f[5].data_ptr(), rot.data_ptr(), pos.data_ptr(),
        std.data_ptr(), ok.data_ptr(), n_tags.data_ptr())
    ints = (ctypes.c_int * 12)(
        int(dtype == torch.float64), b, t, n_layout, max_iter,
        UNDISTORT_ITERS, N_EIGVECS, solve_threads(t), i_rs, c_rs, v_rs, m_rs)
    # compute_std_devs scales by the module's TAG_SIZE, whatever the tags' size
    reals = (ctypes.c_double * 4)(tag_size / 2.0, TAG_SIZE, sign_flip,
                                  decision_margin_min)
    build.launch("chalkydri_solve", like, *(ctypes.cast(a, ctypes.c_void_p)
                                            for a in (ptrs, ints, reals)))
    build.count(solve_frames)
    return rot, pos, std, ok, n_tags


solve_frames.launches = 0
