"""GPU smoke run of the PyTorch/CUDA port: frames -> robot poses on one card.

    python3 chip_smoke.py

1. prints the card (``nvidia-smi`` name and power limit) and fails without
   CUDA;
2. builds the hand-written CUDA kernels from ``chalkydri_tpu_torch/csrc``;
3. renders the scenes of ``chalkydri_tpu_torch/tools/scenes.py``: the
   bench scene, four 1280x800 frames of tag36h11 tags 28-31 of the 2026
   field layout through the bench camera (fx = fy = 1100, camera 1 m up,
   no tilt), one known robot pose per frame, as a batch of 4 cameras; the
   deployed scene, two 1600x1304 frames of the same tags through the
   deployed geometry (fx = fy = 1100, cx = 800, cy = 652) from two robot
   poses; and the spatial scene, the deployed one padded to 1312 rows
   with the cameras 1.2 m up, so that every tag straddles the middle seam
   of four row bands;
4. runs each kernel on the card at its path's shapes against its plain
   PyTorch twin on the same CUDA tensors (bit-identical required), times
   both with CUDA events, and checks both again on edge cases (a scene
   where the CCL round cap binds, noise, adversarial run layouts, row
   counts under one tile and off the 128-row chunk; for the CCL rounds of
   B1, B3 and B4 also odd widths, a 4096-row strip, 4096-pixel rows, a
   batch whose frames reach their fixed points at different rounds, the
   cap at 0, 1, 11, 12 and 13 rounds, the rounds each frame ran against
   the rounds it needs, and the time of a page on which all 12 rounds
   bind): B1 and B2 at the ``quad_decimate=2`` shapes (B1 also at the
   deployed rig's [2, 652, 800], on a frame over its cluster route's
   capacity, which takes the chain of launches, and with the rounds each
   frame ran; B2 also at [4, 65536] with a run over three tiles and at
   row counts off its 1024-row tile; both with their device time and
   device launches a call by ``torch.profiler``), B3 and B4 at
   [4, 800, 1280], B5 at [2, 1304, 1600] (with its device time and device
   launches a call, at most 3; also on a serpentine of that shape whose
   snake crosses every border of B5's rectangles, and at one tile, a
   4096-row strip, widths no multiple of 128 or 16, three frames and gray
   off 4-byte alignment), B6 (both entries) and B7 (whole frame and band
   entry) at the row bands of the spatial scene, 2 x 1312x1600 in four
   bands of 328 rows (and of 164x800 after decimation), with their device
   time and device launches a call, plus a snake that crosses every seam
   of four bands; B6's per-frame gate (``active``) on both of its routes,
   the global-memory one included, at those band shapes and on snakes:
   every frame active, none, and mixed flags, each bit-identical to the
   plain version, an inactive frame's output equal to its labels, and
   the time of a call in which no frame is active; and off those shapes
   (bands of 1-3 rows and of odd height, CTAs of B6's cluster left
   without rows, widths that are no multiple of 4 or 16, snakes through
   every CTA, the last band of the cluster route and one row over it,
   which takes B6's global-memory route; B7 with halos of 0-2 rows, an
   input off 16-byte alignment, ``y_offset`` at the 13-bit limit); the
   solve kernel (``ops/solve.py``: ``FrameSolver`` in one launch) against
   the plain chain, float32, bit for bit at each of the cells' shapes,
   [2, 16] and [4, 16] (the drives of every configuration in
   ``BENCHMARK.json``, ``benchmark/scene.py``, every camera, 5 seeds of
   each; edge cases at two and at four cameras: no tags, one tag, every
   slot full, unknown ids, non-finite corners, a failed undistortion),
   and at B = 1 (the oracle's 16 seeds, the planar mirror's 6
   orderings) within POSE_TOL m and ROT_TOL, its std-devs no further
   from the float64 plain chain than twice the float32 twin's; its
   double instance against ``tests/reference_impl/ref_sqpnp.py`` at the
   1e-9 gates (a unit pinhole); and its time beside its bound and the
   plain chain's; the tail's three kernels (``ops/tail.py``: T1 the quad
   fit and top-k selection, T2 the refinement, T3 the decode with rank,
   dedup and compaction) against the plain chain stage by stage, bit for
   bit, at the cells' [2, 64, 128] and [4, 64, 128] (the drives of every
   configuration, 3 seeds; edge cases at both shapes: no valid cluster,
   all valid, degenerate clusters, squares across the frame's edges,
   duplicate ids, more detections than slots; each family with refine on
   and off at quad_decimate 2 and 1), each kernel's time beside its
   bound and the plain chain's, and the qd2 step's graph nodes with the
   tail plain and with the kernels; the front end's extraction and block
   compaction (``ops/front.py``: X1 count, X2 select, X3 emit) against
   ``extract_and_compact`` bit for bit on the deployed qd1 frames (B5's
   labels), the qd1 bench frames (B3's), a blank frame, the deployed
   frames under noise (far over the budget), both at the capacity
   fallback's wide budget too, sides no multiple of 128 or 16, blobs of
   odd sides (B4's labels) and a tern off 16-byte alignment, and a crop
   that needs no compaction (B7's dense pages, none of X1-X3); and at the
   two qd1 shapes each kernel's device time beside the three's bound and
   the plain chain's, and the graph nodes of one call of each;
5. drives four paths through the entry points (``build_rig_from_config``
   -> ``make_vision_pipeline`` / ``make_sharded_vision_pipeline``), each
   with the launch counts set to 0 just before it and read just after
   (on the single-card paths after the step's first call, which captures
   its CUDA graph, ``utils/graph.py``: the counted steps are replays, and
   each must launch exactly the kernels its capture recorded):
   ``quad_decimate=2`` at 4 x 1280x800 (B1, B2), ``quad_decimate=1`` at
   4 x 1280x800 (B3, B4, B2), ``quad_decimate=1`` at 2 x 1600x1304 (B5,
   B2), and the row-banded step (``spatial=True``) at 2 x 1600x1312 over a
   grid of four bands on the one card, at ``quad_decimate=2`` and ``1``
   (B6 on its cluster route only, B7, B2; the step a replay of one CUDA
   graph, its band CCL's seam rounds gated on the card: a fixed tally a
   replay of one B6 label call, ``2 * bands + 2`` B6 propagate calls and
   one B7 call a band, and one B2 call); every path also one launch of
   the solve kernel and of each tail kernel a step, and the qd1 paths one
   X1-X3 call a step (with the qd1 steps' graph nodes, and those of the same steps with the plain
   extraction in X1-X3's place: less X1-X3's nodes, plus the plain
   chain's). Each checks the ids and each
   frame's pose against its own truth and that every kernel of the path
   launched, compares the step with the same step run on the plain twins
   only (the eager module's, inside ``build.plain_chain()``, where no
   kernel may launch), and times both; the row-banded step is
   also held against the single-card step on the same frames, and run,
   eager and replayed, under PyTorch's sync debug mode "error", which
   raises at a host read (none may come), beside the seam rounds each
   frame ran;
6. holds the captured step to its eager module (``.module``) on the
   qd2, qd1 bench and qd1 deployed paths, on the bench twin's scene, on
   the data-parallel grid (two groups on the one card, a graph each) and
   on the row-banded paths at qd2 and qd1 (four bands on the card):
   two eager steps on one input bit-identical, then
   ``GRAPH_REPLAYS`` replays on alternating inputs each bit-identical to
   the eager output of its input, the first call's output again after
   the last replay, and the replays' launch counts; prints eager and
   replayed step ms (host clock around a synced call), warm-up and
   capture ms, the profiler over replays and the graph pool's bytes;
7. checks the options: the bench scene as YUYV gives the GREY step's ids
   and poses, and a flooded frame with a small ``max_edge_points`` drives
   ``capacity_fallback`` to its second program (each program replayed
   from a graph of its own);
8. runs ``bench.py``'s twin (``chalkydri_tpu_torch/bench.py``) on
   ``bench.py``'s scene and rig (4 x 1280x800, tags 1/5/9/13, stored in
   ``tools/bench_scene.npz`` with the JAX package's outputs): its CPU
   denominator, then ``bench_gpu`` (its capture, a round of
   ``BENCH_ITERS`` eager steps, ``BENCH_REPS`` rounds of replays) with
   the launch counts set to 0 just before (exactly one B1, one B2 and one
   solve a step, eager or replayed, no other kernel), the card's replayed output
   held to the stored JAX outputs; prints the twin's JSON line;
9. drives the runtime App (``runtime.app.App``) at the deployed rig: two
   1600x1304 cameras on mounts 0.3 m apart seeing tags 28-31 from one
   robot pose, frames put in through each chain's ``camera._cap``, the
   gyro sent to the App's whacknet ``Comm`` as the roboRIO's 8-byte
   double, packets read from a loopback socket; at ``pipeline_depth`` 1
   and 0 every packet must carry 4 tags and a position within 0.02 m,
   every frame a pose packet, every poll without a frame a heartbeat, and
   every dispatched step exactly one B1, one B2 and one solve launch
   (counts set to 0 just before; the step is a replay); the App's outputs equal the
   rig's eager step's bit for bit; it prints
   the App's rate, the host p50/p90 of its spans, the packets' latency
   field and the upload time of one staged batch; then
   ``capacity_fallback`` in the App (the 2x-budget step warmed up in a
   thread, its graph captured there, while the loop replays; outputs
   equal to the eager 2x-budget step's bit for bit); and runs ``python -m
   chalkydri_tpu_torch.main`` on ``examples/chalkydri.ron`` (synthetic
   cameras, packets to loopback), which must exit 0 and log frames of
   both cameras;
10. calibrates a camera on the card through the configurator
   (``tools/configurator.py calibrate``, in-process): 12 views of the 6x6
   aprilgrid rendered at 1280x800 through a lens with distortion
   (``tools/scenes.py::board_views``), put in through the camera's
   ``_cap``; every view must be accepted, the views must launch exactly
   12 B1 and 12 B2 (a replay each) after the first view's eager warm-up
   steps, and no other kernel (counts set to 0 just before),
   the recovered fx, fy, cx, cy must lie within ``CALIB_TOL_REL`` of the
   truth, the RMS under ``CALIB_RMS_PX``, the stored calib JSON must
   load back, and the card's solve must equal the CPU's on the same
   features within ``CALIB_SOLVE_REL``; it prints the detect time a view
   (CUDA events; and the detector alone, replayed and eager), the
   solve's time and accepted steps and the parameters beside the truth;
11. runs ``python -m chalkydri_tpu_torch.tools.logread replay`` on the
    log ``main`` wrote (one JSON line per frame record, 20 a camera; the
    ids of the first two frames equal the CPU detector's) and
    ``python -m chalkydri_tpu_torch.tools.soak`` for 15 s on 2 synthetic
    1280x800 cameras (at least 10 iterations, a packet received, every
    latency span of the report, the projection the sum of its parts, the
    staged batch's bytes).

Every failed check raises (non-zero exit). The last three lines are a
JSON kernel report, the ``nvidia-smi`` name and power limit line, and
``{"ok": true, "device": {...}}``. Imports neither JAX nor OpenCV.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from chalkydri_tpu_torch.tools.scenes import serpentine  # noqa: E402

GYRO_OFFSETS = (0.0, 0.01, -0.01, 0.02, -0.02)  # rad, one per step
POSE_TOL_M = 0.02
CORNER_TOL, POSE_TOL, YAW_TOL = 1e-3, 1e-3, 1e-3  # as the CPU parity tests
TIMED_RUNS = 20  # CUDA-event runs per kernel and twin
STEPS = 5  # checked steps per path
# host-clock steps per side and turn
TIMED_STEPS = {"qd2": 10, "qd1": 6, "spatial": 6}
BANDS = 4  # row bands of the spatial path, all on the one card
# The graph phase: replays per path on alternating inputs, and host-clock
# steps per side and turn (eager, replay, replay, eager).
GRAPH_REPLAYS, GRAPH_TIMED = 20, 10
APP_WARMUP, APP_ITERS = 3, 30  # App iterations per pipeline depth
# The App's rig: the deployed lens on two mounts 0.3 m apart, one robot pose.
APP_MOUNT_Y = (0.15, -0.15)  # m
APP_POSE = (12.9, 3.99, 0.015)  # x m, y m, yaw rad (the gyro the robot sends)
APP_GAP_EVERY = 7  # camera 1 has no fresh frame every 7th poll
MAIN_ITERS = 20  # iterations of the ``main`` subprocess
# its iteration rate cap (``--rate``), under the synthetic cameras' 30
# frames/s, so that every iteration finds a fresh frame of each camera
MAIN_RATE_HZ = 20
# The bench twin's rounds here (``python -m chalkydri_tpu_torch.bench``
# runs 3 rounds of 400 steps).
BENCH_ITERS, BENCH_REPS = 20, 3
# The calibration path: fx, fy, cx, cy within 1 % of the truth and the RMS
# under 0.25 px (the port on the CPU on the same 12 views: 0.44 % and
# 0.182 px, PERF.md); the card's Gauss-Newton equal to the CPU's on the
# same features within 1e-6 (relative, against max(|p|, 1e-3)).
CALIB_TOL_REL, CALIB_RMS_PX, CALIB_SOLVE_REL = 1e-2, 0.25, 1e-6
SOAK_SECONDS = 15
# The latency spans of the soak report (the JAX package's schema).
SOAK_SPANS = ("rtt_ms", "host_capture_ms", "h2d_put_ms", "h2d_deploy_ms",
              "device_step_ms", "d2h_fetch_ms", "host_publish_ms",
              "projection_p50_ms")

# The least time the card could take (H100 SXM datasheet figures):
# bytes over the memory rate, operations over the
# 32-bit non-tensor rate (67 T/s, the float32 figure, taken for the int32
# compares and mins these kernels do).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = 67e12
# Operations per pixel the kernels' functions need: the tile threshold
# (tile min/max, 3x3-tile dilation, classify), one CCL round (8 neighbor
# mins + forward and backward run mins along rows and columns), the
# extraction (8-neighbor speckle gate + 2 edge tests and selects), the
# union-find (4 neighbor tests, their unions and the root walk); and per
# element for the segment statistics (cumsum, run starts, run lengths,
# chunk top-2).
THRESH_OPS, ROUND_OPS, EXTRACT_OPS, UNION_FIND_OPS, SEGMENT_OPS = 6, 12, 16, 10, 8


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_times_ms(fn, runs: int = TIMED_RUNS) -> list[float]:
    """Per-run device times of ``fn()`` by CUDA events, after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def max_abs_err(got, want) -> float:
    return max(float((g.double() - w.double()).abs().max())
               for g, w in zip(got, want))


def bound(bytes_moved: int, ops: int) -> tuple[float, str]:
    """(least ms for the work, "bytes" or "operations", whichever bounds)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_counters() -> dict:
    """Every kernel wrapper of the port by its launch counter's name (the
    stage stamps are not counted)."""
    from chalkydri_tpu_torch.ops import front, tail
    from chalkydri_tpu_torch.ops.ccl_extract import threshold_ccl_extract
    from chalkydri_tpu_torch.ops.extract_blocked import extract_candidates_band
    from chalkydri_tpu_torch.ops.propagate import (
        label_components_blocked,
        propagate_components_blocked,
    )
    from chalkydri_tpu_torch.ops.segment_stats import segment_stats
    from chalkydri_tpu_torch.ops.solve import solve_frames
    from chalkydri_tpu_torch.ops.threshold_ccl import (
        label_components_ccl,
        threshold_ccl,
        threshold_ccl_exact,
    )

    return {"threshold_ccl_extract": threshold_ccl_extract,
            "segment_stats": segment_stats,
            "solve_frames": solve_frames,
            "fit_select": tail.fit_select,
            "refine_corners": tail.refine_corners,
            "decode_rank": tail.decode_rank,
            "threshold_ccl": threshold_ccl,
            "label_components_ccl": label_components_ccl,
            "threshold_ccl_exact": threshold_ccl_exact,
            "extract_compact": front.extract_compact,
            "label_components_blocked": label_components_blocked,
            "propagate_components_blocked": propagate_components_blocked,
            "extract_candidates_band": extract_candidates_band}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_counters().items()}


def plain_run(label, fn):
    """``fn()`` inside ``build.plain_chain()``: every kernel wrapper returns
    its plain twin's result, on the card's tensors too. Raises if a kernel
    launched in it (a wrapper's launch count moved)."""
    from chalkydri_tpu_torch.ops import build

    before = launch_counts()
    with build.plain_chain():
        out = fn()
    moved = {k: n - before[k] for k, n in launch_counts().items()
             if n != before[k]}
    if moved:
        raise AssertionError(f"{label}: kernels launched inside "
                             f"plain_chain(): {moved}")
    return out


def kernel_run(label, fn, expect):
    """``fn()`` on the kernels' route. Raises unless each wrapper named in
    ``expect`` launched in it."""
    before = launch_counts()
    out = fn()
    still = [k for k in expect if launch_counts()[k] == before[k]]
    if still:
        raise AssertionError(f"{label}: kernels {still} did not launch")
    return out


# The solve kernel's checks: every benchmark configuration's scenes at
# these seeds, each drive of 14 poses seen by all its cameras.
SOLVE_SEEDS = (2147483711, 3000000019, 4052555153, 5000000111, 6442450967)
# The tail kernels (ops/tail.py, csrc/tail.cu) by their counters' names;
# their checks' seeds (every benchmark configuration's drives);
# operations they need a cluster point (T1: four EM
# rounds of ~144 and the initial fit, counted from the code) and a
# candidate (T2: 32 lanes of 9 bilinear samples, their sums and the line
# fit; T3: the normal equations, the 8-step elimination, ~35 a sample, the
# fits, 4 a code word).
TAIL_KERNELS = ("fit_select", "refine_corners", "decode_rank")
TAIL_SEEDS = SOLVE_SEEDS[:3]
TAIL_POINT_OPS, TAIL_REFINE_OPS, TAIL_DECODE_OPS, TAIL_WORD_OPS = (
    600, 7_000, 7_000, 4)
# tests/test_solver.py::test_matches_numpy_reference's seeds by tag count
ORACLE_SEEDS = ((2, (0, 1, 2, 3, 4, 7, 8, 9)), (3, (0, 1, 2, 3, 4, 5, 7, 8)))
ORACLE_TOL = 1e-9  # tests/test_torch_gates.py's position, rotation, std
ROT_TOL = 1e-3  # largest gap of a rotation entry off the cells' shape
# Off the cells' shape, the kernel's std-devs may be at most this many
# times as far from the float64 plain chain as the float32 twin's are:
# both round the fit's energy, which they scale by (a sum that cancels to
# a small residual), in other orders.
STD_NOISE_FACTOR = 2.0


def _bits(x):
    """x as integers of its width, so NaNs of one payload compare equal."""
    import torch

    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    return x.view(ints[x.dtype]) if x.dtype in ints else x


def _std_gap(got, want) -> float:
    """Largest relative gap of std-devs; a huge value (rms over 0.1: the
    pose is not to be trusted) on one side only is a gap of 1."""
    big_g, big_w = got.abs() > 1e30, want.abs() > 1e30
    if bool((big_g != big_w).any()):
        return 1.0
    keep = ~big_w
    if not bool(keep.any()):
        return 0.0
    g, w = got[keep].double(), want[keep].double()
    return float(((g - w).abs() / w.abs()).max())


class SolveGaps:
    """The kernel's solve against the plain twin's, frame by frame. Every
    frame must agree on ``valid`` and the tag count. With ``exact`` (the
    cells' shape, where ``correct`` rests on it) every frame must be bit
    for bit the twin's. Elsewhere the largest gaps are kept and gated:
    position POSE_TOL m, rotation entries ROT_TOL, and std-devs against
    the float64 plain chain (``anchor``): the kernel's largest relative
    gap at most STD_NOISE_FACTOR times the float32 twin's own. ``abs_err``
    is the largest absolute gap of rotation, position and std-devs over
    every frame compared."""

    def __init__(self, exact: bool):
        self.exact = exact
        self.frames = self.same = 0
        self.pos = self.rot = self.std = self.abs_err = 0.0
        self.std_kernel = self.std_twin = 0.0  # from the float64 chain
        self.anchored = 0  # valid frames held to the float64 chain
        self.differ = []  # the labels of the frames that are not

    def add(self, label, got, n_got, want, n_want, anchor=None) -> None:
        import torch

        keys = ("rotation", "position", "std_devs")
        for f in range(got.valid.shape[0]):
            self.frames += 1
            if int(n_got[f]) != int(n_want[f]):
                raise AssertionError(f"{label} frame {f}: tag count "
                                     f"{int(n_got[f])}, twin {int(n_want[f])}")
            if bool(got.valid[f]) != bool(want.valid[f]):
                raise AssertionError(f"{label} frame {f}: valid "
                                     f"{bool(got.valid[f])}, twin "
                                     f"{bool(want.valid[f])}")
            if anchor is not None and bool(want.valid[f]):
                self.anchored += 1
                self.std_kernel = max(self.std_kernel, _std_gap(
                    got.std_devs[f], anchor.std_devs[f]))
                self.std_twin = max(self.std_twin, _std_gap(
                    want.std_devs[f], anchor.std_devs[f]))
            if all(torch.equal(_bits(getattr(got, k)[f]),
                               _bits(getattr(want, k)[f])) for k in keys):
                self.same += 1
                continue
            self.differ.append(f"{label} frame {f}")
            gaps = [float((getattr(got, k)[f].double()
                           - getattr(want, k)[f].double()).abs()
                          .nan_to_num(0.0, 0.0, 0.0).max()) for k in keys]
            self.rot = max(self.rot, gaps[0])
            self.pos = max(self.pos, gaps[1])
            self.abs_err = max(self.abs_err, *gaps)
            self.std = max(self.std, _std_gap(got.std_devs[f],
                                              want.std_devs[f]))

    def line(self) -> str:
        out = f"{self.same} of {self.frames} frames bit-identical"
        if self.same != self.frames:
            out += (f"; the others ({'; '.join(self.differ[:8])}) within "
                    f"position {self.pos:.3e} m, rotation {self.rot:.3e}, "
                    f"std-devs {self.std:.3e} relative")
        if self.anchored:
            out += (f"; std-devs from the float64 plain chain on "
                    f"{self.anchored} valid frames: kernel "
                    f"{self.std_kernel:.3e}, float32 twin "
                    f"{self.std_twin:.3e} relative")
        return out + " (valid and tag counts equal)"

    def check(self, label) -> None:
        if self.exact and self.same != self.frames:
            raise AssertionError(f"{label}: {self.line()}, where every frame "
                                 f"must be bit-identical")
        if self.pos > POSE_TOL or self.rot > ROT_TOL:
            raise AssertionError(f"{label}: {self.line()}: position over "
                                 f"{POSE_TOL} m or rotation over {ROT_TOL}")
        if self.same != self.frames and self.std > 0 and not self.anchored:
            raise AssertionError(f"{label}: std-devs differ with no float64 "
                                 f"chain to hold them to")
        if self.std_kernel > STD_NOISE_FACTOR * self.std_twin:
            raise AssertionError(f"{label}: {self.line()}: the kernel's "
                                 f"std-devs over {STD_NOISE_FACTOR} times "
                                 f"the twin's gap")


def solve_both(solver, dets, cam, rc_rot, rc_t, gyro, anchor=False):
    """(kernel, its n_tags, twin, its n_tags[, the float64 plain chain]):
    ``FrameSolver`` on the card and its plain twin on the same inputs;
    with ``anchor`` also the plain chain in float64."""
    import copy

    import torch

    with torch.no_grad():
        got, n_got = kernel_run("solve", lambda: solver(
            dets, cam, rc_rot, rc_t, gyro), ("solve_frames",))
        want, n_want = plain_run("solve", lambda: solver(
            dets, cam, rc_rot, rc_t, gyro))
        if not anchor:
            return got, n_got, want, n_want
        s64 = copy.deepcopy(solver).double()
        d64 = dets._replace(corners=dets.corners.double(),
                            decision_margins=dets.decision_margins.double())
        ref, _ = plain_run("solve float64", lambda: s64(
            d64, cam.double(), rc_rot.double(), rc_t.double(), gyro.double()))
    return got, n_got, want, n_want, ref


def oracle_scene(rng, n_tags):
    """tests/test_solver.py::make_scene in numpy (the same draws): tags 1.5-4
    m before a camera at the origin, their world isometries, the rays of
    their corners and the world->camera transform."""
    import scipy.spatial.transform as sst

    from chalkydri_tpu_torch.solver.robot_pose import TAG_SIZE

    ref = reference_module()
    rc_rot, rc_t = ref.create_solver_camera_transform(0, 0, 0, 0, 0, 0.0)
    h = TAG_SIZE / 2
    corners = np.array([[0.0, -h, -h], [0.0, h, -h], [0.0, h, h], [0.0, -h, h]])
    isometries, rays = [], []
    for _ in range(n_tags):
        pos = np.array([rng.uniform(1.5, 4.0), rng.uniform(-1.0, 1.0),
                        rng.uniform(0.3, 1.5)])
        tilt = sst.Rotation.from_euler(
            "zyx", rng.uniform(-0.3, 0.3, size=3)).as_matrix()
        rot = tilt @ sst.Rotation.from_euler("z", np.pi).as_matrix()
        isometries.append((rot, pos))
        for c in corners:
            pc = rc_rot @ (rot @ c + pos) + rc_t
            rays.append(pc / pc[2])
    return isometries, np.array(rays), (rc_rot, rc_t)


def oracle_inputs(isometries, rays, rc, gyro, dtype, dev, slots: int = 8):
    """The oracle's scene as ``FrameSolver`` inputs: a layout of its tags
    (ids 0..n-1), one frame of ``slots`` detections whose corners are the
    rays' (x, y) and a unit pinhole without distortion, whose undistortion
    returns them exactly. Returns (solver, dets, cam, rc_rot, rc_t, gyro)."""
    import torch

    from chalkydri_tpu_torch.detector.pipeline import Detections
    from chalkydri_tpu_torch.geometry.field_layout import FieldLayout
    from chalkydri_tpu_torch.pipeline import FrameSolver

    n = len(isometries)
    layout = FieldLayout(
        torch.from_numpy(np.stack([r for r, _ in isometries])),
        torch.from_numpy(np.stack([t for _, t in isometries])),
        torch.ones(n, dtype=torch.bool), (0.0, 0.0)).to(dev)
    solver = FrameSolver(layout, dtype=dtype)
    ids = torch.full((1, slots), -1, dtype=torch.int32)
    ids[0, :n] = torch.arange(n, dtype=torch.int32)
    corners = torch.zeros(1, slots, 4, 2, dtype=torch.float64)
    corners[0, :n] = torch.from_numpy(rays[:, :2]).reshape(n, 4, 2)
    dets = Detections(ids, corners.to(dtype),
                      torch.full((1, slots), 50.0, dtype=dtype),
                      torch.zeros(1, slots, dtype=torch.int32), ids >= 0,
                      torch.zeros(1, dtype=torch.int32))
    dets = type(dets)(*(x.to(dev) for x in dets))
    cam = torch.tensor([[1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]],
                       dtype=dtype, device=dev)
    rcr, rct = (torch.from_numpy(a)[None].to(dev, dtype) for a in rc)
    return (solver, dets, cam, rcr, rct,
            torch.tensor([gyro], dtype=dtype, device=dev))


def reference_module():
    """tests/reference_impl/ref_sqpnp.py (numpy), loaded by its path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "ref_sqpnp", os.path.join(ROOT, "tests", "reference_impl",
                                  "ref_sqpnp.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def eager_of(step):
    """The eager module of a captured step (the step itself on the CPU)."""
    return getattr(step, "module", step)


def solve_drives(dev, seeds=SOLVE_SEEDS, names=None):
    """The solve kernel against its plain twin, float32, on the rendered
    drives of every benchmark configuration (or those in ``names``) at
    ``seeds``, one batch of the rig's cameras a pose. Returns ({batch
    shape: SolveGaps, exact}, {configuration: its shape}, (solver, dets,
    args, gyro) of the first two-camera batch or None)."""
    import torch

    from benchmark.scene import camera_entries, make_scene
    from chalkydri_tpu_torch.geometry.field_layout import load_field_layout
    from chalkydri_tpu_torch.pipeline import (
        build_rig_from_config,
        make_vision_pipeline,
    )

    traffic = json.load(open(os.path.join(ROOT, "benchmark", "traffic",
                                          "live.json")))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        configs = json.load(f)["configs"]
    drives, shape_of = {}, {}  # batch shape -> SolveGaps; config -> shape
    timing = None
    for entry in configs:
        name = entry["name"]
        if names is not None and name not in names:
            continue
        with open(os.path.join(ROOT, entry["file"])) as f:
            cfg = json.load(f)
        field = os.path.join(ROOT, cfg["field"])
        layout = load_field_layout(field, dtype=torch.float32, device=dev)
        params, rc = build_rig_from_config(camera_entries(cfg), layout,
                                           device=dev)
        pipe = eager_of(make_vision_pipeline(
            layout, params, rc, device=dev,
            detector_kwargs={"quad_decimate": int(cfg["quad_decimate"])}))
        args = (pipe.camera_params, pipe.rc_rot, pipe.rc_t)
        for seed in seeds:
            scene = make_scene(cfg, traffic, field, seed)
            gyro = torch.full((len(scene.frames),), scene.heading,
                              dtype=torch.float32, device=dev)
            for k in range(len(scene.poses)):
                frames = torch.from_numpy(np.stack(
                    [f[k] for f in scene.frames])).to(dev)
                with torch.no_grad():
                    dets = pipe.detector(frames)
                shape = shape_of[name] = tuple(dets.ids.shape)
                drives.setdefault(shape, SolveGaps(exact=True)).add(
                    f"{name} seed {seed} pose {k}",
                    *solve_both(pipe.solver, dets, *args, gyro))
                if timing is None and shape[0] == 2:
                    timing = (pipe.solver, dets, args, gyro)
    return drives, shape_of, timing


def solve_phase(dev, card) -> dict:
    """The solve kernel (``ops/solve.py``, ``csrc/solve.cu``) against its
    plain twin on the card: float32 on every benchmark configuration's
    rendered drives and on edge cases at the cells' shapes ([2, 16] and
    [4, 16]: two and four cameras), bit for bit; on the f64 oracle's
    scenes and the planar mirror's orderings (B = 1) within stated gaps;
    the double instance against the oracle at its 1e-9 gates; and its
    time beside its bound and the plain chain's at [2, 16]. Returns the
    kernel report's numbers."""
    import torch

    from chalkydri_tpu_torch.geometry.field_layout import load_field_layout
    from chalkydri_tpu_torch.ops import solve as sv
    from chalkydri_tpu_torch.pipeline import (
        build_rig_from_config,
        make_vision_pipeline,
    )
    from chalkydri_tpu_torch.solver import robot_pose as rp
    from chalkydri_tpu_torch.tools.scenes import (
        FIELD_JSON,
        MOUNT,
        SCENES,
        TAGS,
        projected_detections,
        render_scene,
    )

    t_phase = time.perf_counter()
    drives, shape_of, timing = solve_drives(dev)
    for shape, gaps in sorted(drives.items()):
        names = [n for n, s in shape_of.items() if s == shape]
        print(f"solve kernel vs plain twin, float32 FrameSolver on the "
              f"benchmark drives ({', '.join(names)}; seeds "
              f"{list(SOLVE_SEEDS)}) at {list(shape)}: {gaps.line()}",
              flush=True)
    for shape, gaps in sorted(drives.items()):
        gaps.check(f"solve drives at {list(shape)}")

    # the oracle's scenes through FrameSolver with a unit pinhole: double
    # against numpy, float32 against the twin
    ref = reference_module()
    oracle32 = SolveGaps(exact=False)
    worst = [0.0, 0.0, 0.0]
    for n_tags, seeds in ORACLE_SEEDS:
        for seed in seeds:
            rng = np.random.default_rng(seed)
            isometries, rays, rc = oracle_scene(rng, n_tags)
            gyro = rng.uniform(-np.pi, np.pi)
            ref_rot, ref_pos, ref_std = ref.RefSqPnP().solve_robot_pose(
                isometries, rays, rc, gyro, rp.SIGN_FLIP_CONST)
            s64, *in64 = oracle_inputs(isometries, rays, rc, gyro,
                                       torch.float64, dev)
            with torch.no_grad():
                out, _ = s64(*in64)
            if not bool(out.valid[0]):
                raise AssertionError(f"oracle seed {seed}: no valid pose")
            gaps = (np.abs(out.position[0].cpu().numpy() - ref_pos).max(),
                    np.abs(out.rotation[0].cpu().numpy() - ref_rot).max(),
                    (np.abs(out.std_devs[0].cpu().numpy() - ref_std)
                     / np.abs(ref_std)).max())
            worst = [max(w, float(g)) for w, g in zip(worst, gaps)]
            s32, *in32 = oracle_inputs(isometries, rays, rc, gyro,
                                       torch.float32, dev)
            oracle32.add(f"oracle {n_tags} tags seed {seed}",
                         *solve_both(s32, *in32), anchor=out)
    if max(worst) > ORACLE_TOL:
        raise AssertionError(f"solve double vs the f64 oracle: {worst} over "
                             f"{ORACLE_TOL}")
    print(f"solve kernel, double, vs tests/reference_impl/ref_sqpnp.py on "
          f"the 16 seeds of test_matches_numpy_reference (FrameSolver, unit "
          f"pinhole): position {worst[0]:.3e} m, rotation {worst[1]:.3e}, "
          f"std-devs {worst[2]:.3e} relative (gates {ORACLE_TOL}); float32 "
          f"vs the plain twin there ([1, 8]): {oracle32.line()}", flush=True)
    oracle32.check("solve oracle float32")

    # edge cases, float32, through FrameSolver at [2, 16] and [4, 16]:
    # projected detections of the bench lens (tags 28-31 from the gates'
    # robot pose); four cameras see what two see, twice over
    calib = SCENES["bench"][0]
    layout = load_field_layout(FIELD_JSON, dtype=torch.float32, device=dev)
    cams = [{"calib": json.dumps({"OpenCVModel5": calib}),
             "robot_to_cam": json.dumps(MOUNT)}] * 2
    params, rc = build_rig_from_config(cams, layout, device=dev)
    pipe = eager_of(make_vision_pipeline(layout, params, rc, device=dev))
    robot = (13.0, 4.0215, 0.0)
    full = [TAGS * 4, TAGS[::-1] * 4]
    cases = {
        "no tags": [(), ()],
        "one tag": [TAGS[:1], TAGS[2:3]],
        "every slot full": full,
        "an unknown id": [TAGS[:2] + (50,) + TAGS[2:], (1000,) + TAGS],
        "non-finite corners": [TAGS, TAGS],
        "an undistortion that fails": [TAGS, TAGS],
        "the gates' tags": [TAGS, TAGS[::-1]],
    }
    edge = {}  # cameras -> SolveGaps
    for n_cams in (2, 4):
        rig, rig_rc = pipe, rc
        if n_cams != 2:
            params4, rig_rc = build_rig_from_config(cams * 2, layout,
                                                    device=dev)
            rig = eager_of(make_vision_pipeline(layout, params4, rig_rc,
                                                device=dev))
        gaps = edge[n_cams] = SolveGaps(exact=True)
        for label, slots in cases.items():
            dets = projected_detections(layout, rig_rc, robot, calib,
                                        slots * (n_cams // 2))
            cam = rig.camera_params
            if label == "every slot full":  # each repeat moved under a pixel
                jitter = torch.arange(16, dtype=torch.float32)[
                    None, :, None, None]
                dets = dets._replace(
                    corners=dets.corners + 0.05 * (jitter % 4))
            if label == "non-finite corners":
                corners = dets.corners.clone()
                corners[0, 1, 2, 0] = float("nan")
                corners[1, 3, 0, 1] = float("inf")
                dets = dets._replace(corners=corners)
            if label == "an undistortion that fails":
                corners = dets.corners.clone()
                corners[:, 0, 1] = torch.tensor([1279.0, 799.0])
                dets = dets._replace(corners=corners)
                cam = cam.clone()
                cam[:, 4:] = torch.tensor([-0.5, 0.0, 0.001, 0.001, 0.0])
            dets = type(dets)(*(x.to(dev) for x in dets))
            gyro = torch.zeros(n_cams, device=dev)
            got, n_got, want, n_want = solve_both(rig.solver, dets, cam,
                                                  rig.rc_rot, rig.rc_t, gyro)
            gaps.add(f"solve edge case {label}, {n_cams} cameras", got, n_got,
                     want, n_want)
            counts = n_got.tolist()
            if (label == "an undistortion that fails"
                    and counts != [3] * n_cams):
                raise AssertionError(f"{label}: tag counts {counts}")
            if label == "no tags" and (got.valid.any() or n_got.any()):
                raise AssertionError(f"{label}: valid {got.valid.tolist()}")
            if label == "an unknown id" and counts != [4] * n_cams:
                raise AssertionError(f"{label}: tag counts {counts}")
        print(f"solve edge cases vs the plain twin at [{n_cams}, 16] "
              f"({', '.join(cases)}): {gaps.line()}", flush=True)
        gaps.check(f"solve edge cases at [{n_cams}, 16]")

    # the planar mirror: a fronto-parallel wall, its detections' slots in 6
    # orders (tests/test_torch_gates.py's case), one frame through
    # FrameSolver
    lay_cpu = load_field_layout(FIELD_JSON, dtype=torch.float32)
    _, bench_rc = build_rig_from_config(cams[:1], lay_cpu, device="cpu")
    frame = render_scene(lay_cpu, bench_rc, *robot, calib)
    with torch.no_grad():
        det_out = pipe.detector(torch.from_numpy(frame)[None].to(dev))
    mirror = SolveGaps(exact=False)
    rng = np.random.default_rng(3)
    t_slots = det_out.ids.shape[1]
    for trial in range(6):
        perm = torch.from_numpy(rng.permutation(t_slots)).to(dev)
        dets = det_out._replace(**{k: getattr(det_out, k)[:, perm] for k in (
            "ids", "corners", "decision_margins", "hammings", "valid")})
        *pair, ref64 = solve_both(
            pipe.solver, dets, pipe.camera_params[:1], pipe.rc_rot[:1],
            pipe.rc_t[:1], torch.zeros(1, device=dev), anchor=True)
        mirror.add(f"planar mirror ordering {trial}", *pair, anchor=ref64)
        got = pair[0]
        pos = got.position[0].tolist()
        if (not bool(got.valid[0]) or math.hypot(pos[0] - robot[0],
                                                 pos[1] - robot[1]) >= 0.02
                or abs(pos[2]) >= 0.05):
            raise AssertionError(f"planar mirror ordering {trial}: {pos}")
    print(f"solve planar mirror, 6 orderings of one frame's slots ([1, "
          f"{t_slots}], each within 0.02 m of the truth) vs the plain twin: "
          f"{mirror.line()}", flush=True)
    mirror.check("solve planar mirror")

    solver, dets, args, gyro = timing
    with torch.no_grad():
        ms = statistics.median(cuda_times_ms(lambda: solver(dets, *args, gyro)))
        plain_ms = statistics.median(cuda_times_ms(lambda: plain_run(
            "solve timing", lambda: solver(dets, *args, gyro))))
        device_ms, launches = graph_device_ms(
            lambda: solver(dets, *args, gyro), sv.solve_frames)
    print(f"solve solve_frames {tuple(dets.ids.shape)}: kernel {ms:.4f} ms "
          f"(device {device_ms:.4f} ms a call by events over a graph of 20 "
          f"calls; {launches:g} launches a call counted by the wrapper), "
          f"plain {plain_ms:.4f} ms; bit-identical on "
          f"{drives[(2, 16)].same + edge[2].same} of "
          f"{drives[(2, 16)].frames + edge[2].frames} frames at this shape "
          f"[{card}]", flush=True)
    bytes_moved, ops = solve_work(*dets.ids.shape)
    bound_ms, bound_by = bound(bytes_moved, ops)
    print(f"solve solve_frames [2, 16]: bound {bound_ms * 1e3:.4f} us by "
          f"{bound_by} ({ops} operations, {bytes_moved} bytes): the kernel "
          f"is the chain of dependent steps; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    err = max(g.abs_err for g in (*drives.values(), oracle32,
                                  *edge.values(), mirror))
    return {"ms": ms, "plain_ms": plain_ms, "device_ms": device_ms,
            "counted_launches_per_call": launches, "bytes": bytes_moved,
            "ops": ops, "max_abs_err": err}


def graph_device_ms(fn, wrapper, calls: int = 20) -> tuple[float, int]:
    """(device ms a call of ``fn``, launches a call): ``calls`` calls
    captured into one CUDA graph and its replays timed by CUDA events, so
    no host launch cost is counted; the launches are the wrapper's count
    of the capture (the profiler's window lost launches of this short
    kernel)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = wrapper.launches
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    launches = (wrapper.launches - before) / calls
    ms = statistics.median(cuda_times_ms(graph.replay)) / calls
    return ms, launches


def solve_work(b: int, t: int, max_iter: int = 15,
               undistort_iters: int = 20) -> tuple[int, int]:
    """(bytes, operations) of the solve for [b, t]: the detections,
    camera parameters, the layout rows the ids pick and the outputs once;
    the arithmetic of each phase of csrc/solve.cu, counted from its code
    (adds, multiplies, divisions, roots, compares alike)."""
    from chalkydri_tpu_torch.ops.solve import N_CAND

    n, c = 4 * t, N_CAND
    bytes_moved = b * (t * (4 + 32 + 1 + 4 + 48) + 9 * 4 + 48 + 4
                       + 36 + 12 + 12 + 1 + 4)
    per_frame = (n * (undistort_iters * 88 + 25)  # undistortion
                 + n * 71  # world points, projectors, p_i p_j
                 + 117 * n * 2  # Q_tt, Q_rt, Q_rr
                 + 27 * 6 + 81 * 7 + 9 * (18 + 162 * 2)  # omega, inverse
                 + 4 * (45 * 18 + 5 * (4 * 35 + 27)) + 70 * 18  # subspace
                 + 25 * (20 + 3 * 25 * 10) + 36 * 10  # Jacobi, basis
                 + c * (400 + max_iter * 3000 + 180 + n * 7 + 100))
    return bytes_moved, b * per_frame


# -- the tail kernels (ops/tail.py, csrc/tail.cu) ---------------------------

def same_bits(a, b) -> bool:
    """``a`` and ``b`` equal bit for bit (NaNs of any payload alike)."""
    import torch

    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        nan = torch.isnan(a)
        if not torch.equal(nan, torch.isnan(b)):
            return False
        a, b = torch.where(nan, 0.0, a), torch.where(nan, 0.0, b)
        return torch.equal(_bits(a), _bits(b))
    return torch.equal(a, b)


class TailGaps:
    """The tail kernels' stage outputs against the plain chain's."""

    def __init__(self):
        self.calls = 0
        self.bad = []  # "label: field" of each output that differs

    def add(self, label, names, got, want) -> None:
        for name, g, w in zip(names, got, want):
            if not same_bits(g, w):
                self.bad.append(f"{label}: {name}")

    def check(self, what) -> None:
        if self.bad:
            raise AssertionError(f"{what}: the tail kernels differ from the "
                                 f"plain chain in {len(self.bad)} outputs: "
                                 f"{self.bad[:8]}")


def tail_clusters(det, gray):
    """The detector's clusters of frames ``gray`` (its stages up to B2)."""
    from chalkydri_tpu_torch.detector.cluster import cluster_candidates_batched
    from chalkydri_tpu_torch.detector.pipeline import decimate2

    small = decimate2(gray) if det.quad_decimate == 2 else gray.contiguous()
    black, white, payload, dropped = det.candidates(small)
    return cluster_candidates_batched(
        black, white, payload, max_points=det.edge_cap,
        max_clusters=det.max_clusters, cluster_points=det.cluster_points,
        dropped=dropped)


def tail_compare(det, gray, cl, gaps, label, max_detections=None):
    """T1-T3 against the plain chain on one batch, stage by stage, each
    kernel fed the plain chain's previous stage: T1's quads of every
    cluster and its selection, T2's corners, T3's decode of every
    candidate and its detections. Returns the plain chain's (corners
    decoded, their valid, the ``Decoded``)."""
    import torch

    from chalkydri_tpu_torch.detector.decode import decode_rank_plain
    from chalkydri_tpu_torch.detector.quad import fit_select_plain
    from chalkydri_tpu_torch.detector.refine import refine_quads
    from chalkydri_tpu_torch.ops import tail

    kw = det._wide_kwargs
    qd, kq = kw["quad_decimate"], kw["max_quad_candidates"]
    d = max_detections or kw["max_detections"]
    with torch.no_grad():
        q, corners, valid = fit_select_plain(cl.points, cl.mask, cl.valid,
                                             cl.count, kq, qd)
        kquads, kc, kv = tail.fit_select(cl.points, cl.mask, cl.valid,
                                         cl.count, kq, qd)
        gaps.add(label, ("quads' corners", "quads' valid", "corners",
                         "valid"), (kquads.corners, kquads.valid, kc, kv),
                 (q.corners, q.valid, corners, valid))
        if kw["refine"]:
            refined = refine_quads(gray, corners, valid)
            gaps.add(label, ("refined corners",),
                     (tail.refine_corners(gray, corners, valid),), (refined,))
            corners = refined
        dec, dets = decode_rank_plain(det.decode, gray, corners, valid, d)
        kdec, kdets = tail.decode_rank(det.decode, gray, corners, valid, d)
        gaps.add(label, [f"decoded {f}" for f in dec._fields], kdec, dec)
        gaps.add(label, ("ids", "detections' corners", "margins", "hammings",
                         "detections' valid"), kdets, dets)
    gaps.calls += 1
    return corners, valid, dec


def tail_drives(dev, seeds=TAIL_SEEDS, names=None):
    """T1-T3 against the plain chain on the rendered drives of every
    benchmark configuration (or those in ``names``) at ``seeds``, one
    batch of the rig's cameras a pose. Returns ({clusters' shape
    [B, K, P]: TailGaps}, {configuration: (detector, gray, clusters) of
    its first batch})."""
    import torch

    from benchmark.scene import camera_entries, make_scene
    from chalkydri_tpu_torch.geometry.field_layout import load_field_layout
    from chalkydri_tpu_torch.pipeline import (
        build_rig_from_config,
        make_vision_pipeline,
    )

    traffic = json.load(open(os.path.join(ROOT, "benchmark", "traffic",
                                          "live.json")))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        configs = json.load(f)["configs"]
    drives, first = {}, {}
    for entry in configs:
        name = entry["name"]
        if names is not None and name not in names:
            continue
        with open(os.path.join(ROOT, entry["file"])) as f:
            cfg = json.load(f)
        field = os.path.join(ROOT, cfg["field"])
        layout = load_field_layout(field, dtype=torch.float32, device=dev)
        params, rc = build_rig_from_config(camera_entries(cfg), layout,
                                           device=dev)
        det = eager_of(make_vision_pipeline(
            layout, params, rc, device=dev,
            detector_kwargs={"quad_decimate": int(cfg["quad_decimate"])})
        ).detector
        for seed in seeds:
            scene = make_scene(cfg, traffic, field, seed)
            for k in range(len(scene.poses)):
                gray = torch.from_numpy(np.stack(
                    [f[k] for f in scene.frames])).to(dev)
                with torch.no_grad():
                    cl = tail_clusters(det, gray)
                shape = tuple(cl.mask.shape)
                tail_compare(det, gray, cl, drives.setdefault(shape,
                                                              TailGaps()),
                             f"{name} seed {seed} pose {k}")
                first.setdefault(name, (det, gray, cl))
    return drives, first


def square_points(cx, cy, half, angle, p, jitter, seed):
    """``p`` boundary points of a square (numpy [2, p]): ``p // 4`` an
    edge, evenly spaced, each moved by up to ``jitter`` pixels."""
    rng = np.random.default_rng(seed)
    t = (np.arange(p) % (p // 4) + 0.5) / (p // 4) * 2.0 - 1.0
    e = np.arange(p) // (p // 4) % 4
    u = np.where(e == 0, t, np.where(e == 1, 1.0, np.where(e == 2, -t, -1.0)))
    v = np.where(e == 0, -1.0, np.where(e == 1, t, np.where(e == 2, 1.0, -t)))
    c, s = np.cos(angle), np.sin(angle)
    x = cx + half * (c * u - s * v) + rng.uniform(-jitter, jitter, p)
    y = cy + half * (s * u + c * v) + rng.uniform(-jitter, jitter, p)
    return np.stack([x, y]).astype(np.float32)


def tail_edge_clusters(cl, case: str, h: int, w: int):
    """Clusters of the shape of ``cl`` for an edge case of T1 (squares
    where the case wants valid quads) in an ``h`` x ``w`` quad-search
    frame."""
    import torch

    from chalkydri_tpu_torch.detector.cluster import Clusters

    b, _, k, p = cl.points.shape
    pts = np.zeros((b, 4, k, p), np.float32)
    mask = np.ones((b, k, p), bool)
    valid = np.ones((b, k), bool)
    count = np.zeros((b, k), np.int32)
    for f in range(b):
        for c in range(k):
            seed = 1000 * f + c
            half = 8.0 + (c * 7 % 23)
            cx = (c % 8 + 0.5) * w / 8
            cy = (c // 8 % 8 + 0.5) * h / 8
            if case == "border":  # squares across the frame's edges
                cx = (-0.3 + (c % 4) * 0.1) * half if c % 2 else w - 0.6 * half
                cy = (c // 2 % 8 + 0.5) * h / 8
            pts[f, :2, c] = square_points(cx, cy, half, 0.1 * c + 0.05 * f, p,
                                          0.4, seed)
            count[f, c] = p + (c % 5)  # ties between clusters
            if case == "degenerate" and c >= k // 2:
                kind = c % 5
                if kind == 0:  # every point on one line
                    pts[f, 0, c] = np.linspace(5, 60, p)
                    pts[f, 1, c] = 2.0 * pts[f, 0, c] + 3.0
                elif kind == 1:  # one point
                    pts[f, :2, c] = 17.0
                elif kind == 2:  # three points
                    pts[f, :2, c] = square_points(30, 30, 9, 0.2, p, 0.0,
                                                  seed)[:, np.arange(p) % 3][:, :p]
                elif kind == 3:  # overflows: non-finite corners
                    pts[f, :2, c] *= np.float32(1e20)
                else:  # few points, the rest masked off
                    mask[f, c, 6:] = False
                valid[f, c] = kind != 4 or c % 2 == 0
    if case == "no valid cluster":
        mask[:] = False
        valid[:] = False
        count[:] = 0
    dev = cl.points.device
    return Clusters(points=torch.from_numpy(pts).to(dev),
                    mask=torch.from_numpy(mask).to(dev),
                    count=torch.from_numpy(count).to(dev),
                    valid=torch.from_numpy(valid).to(dev),
                    dropped=cl.dropped)


def tail_edge_cases(det, gray, cl, gaps) -> list:
    """T1-T3 against the plain chain on the edge cases, at the shape of
    the clusters ``cl``: no valid cluster; all K valid (ties of size);
    degenerate clusters (collinear, one point, three points, overflowing
    coordinates, five points) beside valid ones, so that none is picked;
    squares across the frame's edges, whose samples clamp; and, on the
    drive's own candidates, duplicate ids and more valid detections than
    slots. Returns the cases' names."""
    import torch

    b = gray.shape[0]
    h, w = gray.shape[1:]
    if det.quad_decimate == 2:
        h, w = h // 2, w // 2
    cases = ["no valid cluster", "all valid", "degenerate", "border"]
    for case in cases:
        tail_compare(det, gray, tail_edge_clusters(cl, case, h, w), gaps,
                     f"edge case {case} at {list(cl.mask.shape)}")
    corners, valid, _ = tail_compare(det, gray, cl, TailGaps(), "drive")
    half = corners.shape[1] // 2
    dup = torch.cat([corners[:, :half], corners[:, :half] + 0.25], dim=1)
    dup_valid = torch.cat([valid[:, :half], valid[:, :half]], dim=1)
    from chalkydri_tpu_torch.detector.decode import decode_rank_plain
    from chalkydri_tpu_torch.ops import tail

    with torch.no_grad():
        for d in (1, 2, 16):
            dec, dets = decode_rank_plain(det.decode, gray, dup, dup_valid, d)
            kdec, kdets = tail.decode_rank(det.decode, gray, dup, dup_valid, d)
            label = (f"edge case duplicate ids, {d} slots, at "
                     f"{list(cl.mask.shape)}")
            gaps.add(label, [f"decoded {f}" for f in dec._fields], kdec, dec)
            gaps.add(label, ("ids", "corners", "margins", "hammings",
                             "valid"), kdets, dets)
    return [*cases, "duplicate ids", f"more detections than slots ({b} "
            f"frames of {int(dec.valid.sum())} valid candidates into 1 and "
            f"2 slots)"]


def family_frames(family, b: int, h: int, w: int, seed: int):
    """``b`` frames of ``h`` x ``w`` with six tags of ``family`` each,
    pasted upright at 4-7 pixels a cell on the benchmark's gray."""
    from chalkydri_tpu_torch.detector.families import render_tag

    rng = np.random.default_rng(seed)
    frames = np.full((b, h, w), 150, np.uint8)
    for f in range(b):
        for i in range(6):
            tag = render_tag(family, int(rng.integers(0, family.ncodes)),
                             cell_px=int(rng.integers(4, 8)))
            y = 20 + (i // 3) * (h // 2)
            x = 20 + (i % 3) * (w // 3)
            frames[f, y:y + tag.shape[0], x:x + tag.shape[1]] = tag
    return frames


def tail_families(dev) -> list:
    """T1-T3 against the plain chain for each family, refine on and off,
    at quad_decimate 2 and 1, on two 480 x 640 frames of the family's
    tags ([2, 64, 128] clusters). Returns the labels checked."""
    import torch

    from chalkydri_tpu_torch.detector.families import load_family
    from chalkydri_tpu_torch.detector.pipeline import Detector

    gaps, labels = TailGaps(), []
    for name in ("tag16h5", "tag25h9", "tag36h10", "tag36h11"):
        fam = load_family(name)
        gray = torch.from_numpy(family_frames(fam, 2, 480, 640, 7)).to(dev)
        for qd in (2, 1):
            for refine in (True, False):
                det = Detector(family=fam, quad_decimate=qd,
                               refine=refine).to(dev)
                with torch.no_grad():
                    cl = tail_clusters(det, gray)
                label = f"{name} qd{qd} refine {'on' if refine else 'off'}"
                _, _, dec = tail_compare(det, gray, cl, gaps, label)
                labels.append(f"{label}: {int(dec.valid.sum())} decoded")
    gaps.check("tail families")
    return labels


def graph_nodes(fn):
    """Nodes of a CUDA graph that captures one call of ``fn`` (the
    driver's count of the graph; None where this torch keeps no graph to
    count)."""
    import ctypes

    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    try:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError:
        graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    try:
        handle = graph.raw_cuda_graph()
        n = ctypes.c_size_t(0)
        rc = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
            ctypes.c_void_p(handle), None, ctypes.byref(n))
        return int(n.value) if rc == 0 else None
    except (AttributeError, OSError, RuntimeError):
        return None


def tail_work(b, k, p, kq, nbits, samples, nwords) -> dict:
    """(bytes, operations) of T1-T3 at clusters [b, k, p], ``kq``
    candidates and a family of ``nbits`` bits, ``samples`` samples and
    ``nwords`` code words: inputs and outputs once (a bilinear sample's 4
    pixels), the arithmetic counted from the code."""
    t1 = (b * k * (p * 17 + 5) + b * k * 33 + b * kq * 33,
          b * k * p * TAIL_POINT_OPS)
    t2 = (b * kq * (33 + 32 * 9 * 4 + 32), b * kq * TAIL_REFINE_OPS)
    t3 = (b * kq * (33 + samples * 4) + nwords * 16 + b * kq * 45
          + b * 16 * 45,
          b * kq * (TAIL_DECODE_OPS + nwords * TAIL_WORD_OPS))
    return {"fit_select": t1, "refine_corners": t2, "decode_rank": t3}


def tail_phase(dev, card) -> dict:
    """The tail kernels (``ops/tail.py``, ``csrc/tail.cu``) against the
    plain chain on the card, bit for bit: the drives of every benchmark
    configuration at their shapes ([2, 64, 128] and [4, 64, 128]); the
    edge cases at both; every family, refine on and off, quad_decimate 2
    and 1; then each kernel's time beside its bound and the plain
    chain's, and the replayed step's graph nodes with the tail plain and
    with the kernels. Returns the kernel report's numbers."""
    import torch

    from chalkydri_tpu_torch.detector.decode import decode_rank_plain
    from chalkydri_tpu_torch.detector.quad import fit_select_plain
    from chalkydri_tpu_torch.detector.refine import refine_quads
    from chalkydri_tpu_torch.ops import tail

    t_phase = time.perf_counter()
    drives, first = tail_drives(dev)
    for shape, gaps in sorted(drives.items()):
        gaps.check(f"tail drives at {list(shape)}")
        print(f"tail kernels vs the plain chain, the drives at clusters "
              f"{list(shape)}: {gaps.calls} batches, T1's quads and "
              f"selection, T2's corners, T3's decode and detections "
              f"bit-identical [{card}]", flush=True)
    if sorted(drives) != [(2, 64, 128), (4, 64, 128)]:
        raise AssertionError(f"tail drives at {sorted(drives)}, the cells' "
                             f"[2, 64, 128] and [4, 64, 128] expected")
    edge = TailGaps()
    for name in ("comp2-1600x1304-qd2", "north-4x1280x800-qd2"):
        cases = tail_edge_cases(*first[name], edge)
    edge.check("tail edge cases")
    print(f"tail edge cases bit-identical at [2, 64, 128] and [4, 64, 128]: "
          f"{'; '.join(cases)} ({edge.calls} batches)", flush=True)
    print(f"tail families bit-identical: {'; '.join(tail_families(dev))}",
          flush=True)

    det, gray, cl = first["comp2-1600x1304-qd2"]
    kw = det._wide_kwargs
    kq, qd, d = (kw["max_quad_candidates"], kw["quad_decimate"],
                 kw["max_detections"])
    corners, valid, _ = tail_compare(det, gray, cl, TailGaps(), "timing")
    _, sel, sel_valid = fit_select_plain(cl.points, cl.mask, cl.valid,
                                         cl.count, kq, qd)
    b, k, p = cl.mask.shape
    fam = det.decode
    work = tail_work(b, k, p, min(kq, k), len(fam.data_xy),
                     len(fam.data_xy) + len(fam.black_xy) + len(fam.white_xy),
                     fam.codes.shape[0])
    stages = {
        "fit_select": (lambda: tail.fit_select(cl.points, cl.mask, cl.valid,
                                               cl.count, kq, qd),
                       lambda: fit_select_plain(cl.points, cl.mask,
                                                cl.valid, cl.count, kq, qd)),
        "refine_corners": (lambda: tail.refine_corners(gray, sel, sel_valid),
                           lambda: refine_quads(gray, sel, sel_valid)),
        "decode_rank": (lambda: tail.decode_rank(fam, gray, corners, valid, d),
                        lambda: decode_rank_plain(fam, gray, corners, valid,
                                                  d)),
    }
    out = {}
    with torch.no_grad():
        for name, (kernel, plain) in stages.items():
            ms = statistics.median(cuda_times_ms(kernel))
            plain_ms = statistics.median(cuda_times_ms(plain))
            device_ms, launches = graph_device_ms(kernel, getattr(tail, name))
            plain_dev_ms, _ = graph_device_ms(plain, getattr(tail, name))
            bound_ms, bound_by = bound(*work[name])
            print(f"tail {name} clusters {[b, k, p]}: kernel {ms:.4f} ms "
                  f"(device {device_ms:.4f} ms a call by events over a graph "
                  f"of 20 calls; {launches:g} launches a call counted), plain "
                  f"{plain_ms:.4f} ms (device {plain_dev_ms:.4f} ms replayed);"
                  f" bound {bound_ms * 1e3:.4f} us by {bound_by} "
                  f"({work[name][1]} operations, {work[name][0]} bytes) "
                  f"[{card}]", flush=True)
            out[name] = {"ms": ms, "plain_ms": plain_ms,
                         "device_ms": device_ms, "plain_device_ms": plain_dev_ms,
                         "counted_launches_per_call": launches,
                         "bytes": work[name][0], "ops": work[name][1]}
    # the replayed step's graph, tail plain and tail kernels
    from chalkydri_tpu_torch.geometry.field_layout import load_field_layout
    from chalkydri_tpu_torch.pipeline import (
        build_rig_from_config,
        make_vision_pipeline,
    )
    from benchmark.scene import camera_entries

    with open(os.path.join(ROOT, "benchmark", "configs",
                           "comp2-1600x1304-qd2.json")) as f:
        cfg = json.load(f)
    layout = load_field_layout(os.path.join(ROOT, cfg["field"]),
                               dtype=torch.float32, device=dev)
    params, rc = build_rig_from_config(camera_entries(cfg), layout, device=dev)
    pipe = eager_of(make_vision_pipeline(layout, params, rc, device=dev))
    gyro = torch.zeros(gray.shape[0], device=dev)
    with torch.no_grad():
        before = plain_run("tail graph nodes", lambda: graph_nodes(
            lambda: pipe(gray, gyro)))
        after = kernel_run("tail graph nodes", lambda: graph_nodes(
            lambda: pipe(gray, gyro)), ("threshold_ccl_extract",
                                        "segment_stats", "solve_frames",
                                        *TAIL_KERNELS))
    print(f"tail graph nodes of the comp2 qd2 step: {before} with the plain "
          f"chain, {after} with the kernels; phase "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


# X1-X3 (ops/front.py): the noise that floods the deployed frames with
# candidates (sigma, gray levels), and the capacity fallback's wide budget.
FRONT_NOISE = 6.0
FRONT_WIDE = 2


def front_cases(dev) -> dict:
    """name -> (tern, labels, max_points) for X1-X3: the deployed qd1
    frames with B5's labels, the qd1 bench frames with B3's, a blank
    frame, the deployed frames under noise (far over the budget), both at
    the wide budget too, and off the fast paths: sides no multiple of 128
    or 16 (B5's labels), blobs of odd sides (B4's) and a tern one byte off
    16-byte alignment; and a crop that needs no compaction (B7's dense
    pages, X1-X3 not launched)."""
    import torch

    from chalkydri_tpu_torch.detector.cluster import MAX_EDGE_POINTS
    from chalkydri_tpu_torch.ops.threshold_ccl import (
        label_components_ccl,
        threshold_ccl,
        threshold_ccl_exact,
    )
    from chalkydri_tpu_torch.tools.scenes import blob_tern, load_scene

    _, _, _, bench, _ = load_scene("bench", dev)
    _, _, _, dep, _ = load_scene("deployed", dev)
    rng = np.random.default_rng(5)
    noisy = torch.from_numpy(np.clip(
        dep.cpu().numpy() + rng.normal(0, FRONT_NOISE, dep.shape), 0,
        255).astype(np.uint8)).to(dev)
    blobs = torch.from_numpy(blob_tern((2, 333, 517), 3)).to(dev)
    dep_tl = threshold_ccl_exact(dep)
    noisy_tl = threshold_ccl_exact(noisy)
    off = torch.empty(dep.numel() + 1, dtype=torch.uint8, device=dev)[1:]
    off = off.view(dep.shape).copy_(dep_tl[0])
    return {
        "deployed qd1": (*dep_tl, MAX_EDGE_POINTS),
        "qd1 bench": (*threshold_ccl(bench, iters=12), MAX_EDGE_POINTS),
        "blank": (*threshold_ccl_exact(torch.zeros_like(dep)),
                  MAX_EDGE_POINTS),
        "overflow": (*noisy_tl, MAX_EDGE_POINTS),
        "wide budget": (*dep_tl, FRONT_WIDE * MAX_EDGE_POINTS),
        "wide budget, overflow": (*noisy_tl, FRONT_WIDE * MAX_EDGE_POINTS),
        "odd sides": (*threshold_ccl_exact(
            dep[:, 400:732, 200:716].contiguous()), 4096),
        "blobs": (blobs, label_components_ccl(blobs, 12), 8192),
        "unaligned tern": (off, dep_tl[1], MAX_EDGE_POINTS),
        "within the budget": (*threshold_ccl_exact(
            dep[:, 400:528, 200:456].contiguous()), MAX_EDGE_POINTS),
    }


def front_checks(dev) -> dict:
    """X1-X3 against their twin, ``extract_and_compact`` inside
    ``build.plain_chain()``, bit for bit on ``front_cases``; the noisy
    frames must drop candidates at the standard budget; frames that need
    no compaction launch B7 and none of X1-X3. Returns a line a case."""
    import torch

    from chalkydri_tpu_torch.ops import front

    lines = {}
    for name, (tern, labels, mp) in front_cases(dev).items():
        label = f"X1-X3 {name}"
        dense = 2 * tern[0].numel() <= mp
        x_before = front.extract_compact.launches
        got = kernel_run(label, lambda: front.extract_compact(
            tern, labels, mp),
            ("extract_candidates_band",) if dense else ("extract_compact",))
        if dense and front.extract_compact.launches != x_before:
            raise AssertionError(f"{label}: X1-X3 launched on frames that "
                                 f"need no compaction")
        want = plain_run(label, lambda: front.extract_compact(
            tern, labels, mp))
        require_equal(label, ("black", "white", "payload", "dropped"), got,
                      want)
        kept = (want[0] != 2 ** 31 - 1).sum(1).tolist()
        dropped = want[3].tolist()
        if name == "overflow" and min(dropped) <= 0:
            raise AssertionError(f"{label}: dropped {dropped}, the budget "
                                 f"does not bite")
        lines[name] = (f"{list(tern.shape)} max_points {mp}: "
                       f"{want[0].shape[1] // front.BLOCK} blocks a frame, "
                       f"edges kept {kept}, dropped {dropped}")
    return lines


def front_work(b: int, h: int, w: int, max_points: int,
               edges: int) -> tuple[int, int]:
    """(bytes, operations) of X1-X3 on [b, h, w] with ``edges`` edge slots
    kept: the ternary image read once, an edge slot's two labels (its
    pixel's and its partner's) read, the compacted pages and ``dropped``
    written; EXTRACT_OPS a pixel."""
    from chalkydri_tpu_torch.ops import front

    slots = b * sum(front.kept_blocks(h, w, max_points)) * front.BLOCK
    return b * h * w + 8 * edges + 12 * slots + 4 * b, b * h * w * EXTRACT_OPS


def front_phase(dev, card, deployed, bench) -> dict:
    """X1-X3 against the twin on ``front_cases``; then at the two qd1
    shapes (``deployed``: B5's (tern, labels) of the deployed frames,
    ``bench``: B3's of the bench frames) each kernel's device time, the
    three's by events over a graph of 20 calls, beside their bound and
    the plain chain's, and the graph nodes of one call of each. Returns
    the deployed shape's numbers for the kernel report."""
    t_phase = time.perf_counter()
    for name, line in front_checks(dev).items():
        print(f"X1-X3 extract_compact {name} bit-identical: {line} [{card}]",
              flush=True)
    out = {label: front_timing(label, *tl, card)
           for label, tl in (("deployed qd1", deployed),
                             ("qd1 bench", bench))}
    print(f"X1-X3 phase: {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out["deployed qd1"] | {"bench": out["qd1 bench"]}


def front_timing(label, tern, labels, card) -> dict:
    """X1-X3 on one qd1 shape: each kernel's device time (the profiler),
    the three's by events over a graph of 20 calls, the plain chain's, the
    bound (its edge slots counted in the twin's output), and the graph
    nodes of one call of each."""
    import torch

    from chalkydri_tpu_torch.detector.cluster import MAX_EDGE_POINTS
    from chalkydri_tpu_torch.ops import front
    from chalkydri_tpu_torch.tools.perfprobe import device_times

    def kernel():
        return front.extract_compact(tern, labels)

    def plain():
        return plain_run(label, kernel)

    with torch.no_grad():
        ms = statistics.median(cuda_times_ms(kernel))
        plain_ms = statistics.median(cuda_times_ms(plain))
        kernels = device_times(kernel, per_call=3,
                               wrapper=front.extract_compact)
        graph_ms, launches = graph_device_ms(kernel, front.extract_compact)
        plain_graph_ms, _ = graph_device_ms(plain, front.extract_compact)
        nodes, plain_nodes = graph_nodes(kernel), graph_nodes(plain)
        edges = int((plain()[0] != 2 ** 31 - 1).sum())
    device_ms = sum(k["us_per_call"] for k in kernels.values()) / 1e3
    per_call = sum(k["launches_per_call"] for k in kernels.values())
    work = front_work(*tern.shape, MAX_EDGE_POINTS, edges)
    bound_ms, bound_by = bound(*work)
    each = ", ".join(f"{k} {v['us_per_call']:.2f} us"
                     for k, v in sorted(kernels.items()))
    print(f"X1-X3 extract_compact {label} {tuple(tern.shape)}: kernel "
          f"{ms:.4f} ms (device {device_ms:.4f} ms in {per_call} launches a "
          f"call: {each}; {graph_ms:.4f} ms a call by events over a graph "
          f"of 20 calls, {launches:g} launch a call counted), plain chain "
          f"{plain_ms:.4f} ms (device {plain_graph_ms:.4f} ms replayed); "
          f"bound {bound_ms * 1e3:.4f} us by {bound_by} ({work[0]} bytes, "
          f"{work[1]} operations, {edges} edge slots: "
          f"{bound_ms / graph_ms * 100:.2f} % of the replayed time); "
          f"graph nodes a call {nodes} (plain chain "
          f"{plain_nodes}) [{card}]", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "device_ms": device_ms,
            "graph_ms": graph_ms, "plain_graph_ms": plain_graph_ms,
            "nodes": nodes, "plain_nodes": plain_nodes, "bytes": work[0],
            "ops": work[1], "launches_per_call": per_call}


def require_equal(label: str, names, got, want) -> None:
    import torch

    torch.cuda.synchronize()
    for name, g, w in zip(names, got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"{label}: {name} differs from its plain twin")


def ccl_round_checks(dev, card, tern_scene) -> None:
    """The capped CCL rounds, reached through B4, B3 and B1, against their
    twins where the index math and the exit at the fixed point are
    stressed; the rounds each frame ran against the rounds it needs; and
    the time of B4 on a page where all 12 rounds bind. ``tern_scene`` is
    one thresholded frame of the bench scene."""
    import torch

    from chalkydri_tpu_torch.detector.segment import (
        label_components,
        rounds_needed,
    )
    from chalkydri_tpu_torch.detector.threshold import adaptive_threshold
    from chalkydri_tpu_torch.ops.ccl_extract import (
        threshold_ccl_extract,
        threshold_ccl_extract_plain,
        threshold_ccl_extract_rounds,
    )
    from chalkydri_tpu_torch.ops.threshold_ccl import (
        label_components_ccl_rounds,
        threshold_ccl,
        threshold_ccl_plain,
    )
    from chalkydri_tpu_torch.tools.scenes import (
        CCL_STRESS_SHAPES,
        blob_tern,
        mixed_terns,
    )

    def check_b4(label, tern, iters=12):
        """Labels equal to the twin's; every frame ran the rounds it
        needs and the confirming one, at most ``iters``."""
        got, ran = label_components_ccl_rounds(tern, iters)
        require_equal(label, ("labels",), (got,),
                      (label_components(tern, iters=iters),))
        want = (rounds_needed(tern, iters) + 1).clamp(max=iters)
        if ran.tolist() != want.tolist():
            raise AssertionError(f"{label}: frames ran {ran.tolist()} rounds,"
                                 f" expected {want.tolist()}")
        return ran.tolist()

    def check_b1(label, gray, iters=12):
        """B1's pages equal to the twin's; every frame ran the rounds its
        thresholded frame needs and the confirming one, at most
        ``iters``."""
        got, ran = threshold_ccl_extract_rounds(gray, iters)
        require_equal(label, ("black", "white", "payload"), got,
                      threshold_ccl_extract_plain(gray, iters))
        want = (rounds_needed(adaptive_threshold(gray), iters) + 1).clamp(
            max=iters)
        if ran.tolist() != want.tolist():
            raise AssertionError(f"{label}: frames ran {ran.tolist()} rounds,"
                                 f" expected {want.tolist()}")
        return ran.tolist()

    rng = np.random.default_rng(13)
    for shape in CCL_STRESS_SHAPES:
        check_b4(f"B4 {shape}", torch.from_numpy(blob_tern(shape, 1)).to(dev))
        if shape[1] % 4 or shape[2] % 4:
            continue  # B1 and B3 threshold in 4x4 tiles
        gray = torch.from_numpy(
            rng.integers(0, 256, shape, dtype=np.uint8)).to(dev)
        require_equal(f"B3 {shape}", ("tern", "labels"),
                      threshold_ccl(gray, iters=12),
                      threshold_ccl_plain(gray, iters=12))
        require_equal(f"B1 {shape}", ("black", "white", "payload"),
                      threshold_ccl_extract(gray, iters=12),
                      threshold_ccl_extract_plain(gray, iters=12))
    print(f"CCL rounds: B4 bit-identical at "
          f"{[list(s) for s in CCL_STRESS_SHAPES]}, B1 and B3 on noise at "
          f"those that are multiples of 4", flush=True)

    serp = torch.from_numpy(serpentine()[None]).to(dev)
    ran = {iters: check_b4(f"B4 serpentine iters={iters}", serp, iters)[0]
           for iters in (0, 1, 11, 12, 13)}
    mixed = check_b4("B4 mixed batch", torch.from_numpy(
        mixed_terns(64, 128, 20, 3)).to(dev))
    h, w = tern_scene.shape
    big = torch.from_numpy(mixed_terns(h, w, 200, 3)).to(dev)
    big[2] = tern_scene
    mixed_big = check_b4(f"B4 mixed batch {tuple(big.shape)}", big)
    if len(set(mixed)) < 3 or len(set(mixed_big)) < 3:
        raise AssertionError(f"mixed batches: frames ran {mixed} and "
                             f"{mixed_big} rounds, exits do not differ")
    # B1, on both routes: the snake thresholds to itself; the mixed
    # batches as gray frames (the [4, 800, 1280] one takes the chain)
    b1_ran = [check_b1(f"B1 serpentine iters={iters}", serp, iters)[0]
              for iters in (0, 1, 11, 12, 13)]
    b1_mixed = check_b1("B1 mixed batch", torch.from_numpy(
        mixed_terns(64, 128, 20, 3)).to(dev))
    b1_mixed_big = check_b1(f"B1 mixed batch {tuple(big.shape)}", big)
    print(f"B1 rounds run per frame (needed + 1, at most iters), pages "
          f"bit-identical: serpentine at iters 0, 1, 11, 12, 13 ran "
          f"{b1_ran}; mixed batch [4, 64, 128] ran {b1_mixed}; "
          f"{list(big.shape)} ran {b1_mixed_big}", flush=True)
    print(f"CCL rounds run per frame (needed + 1, at most iters), labels "
          f"bit-identical: serpentine at iters 0, 1, 11, 12, 13 ran "
          f"{list(ran.values())}; flat, 5-stripe snake, blobs, 20-stripe "
          f"snake at [4, 64, 128] ran {mixed}; flat, 5-stripe snake, bench "
          f"scene, 200-stripe snake at {list(big.shape)} ran {mixed_big}",
          flush=True)

    worst = torch.from_numpy(
        np.stack([serpentine(h, w, 200)] * 4)).to(dev)
    if check_b4("B4 all rounds bind", worst) != [12] * 4:
        raise AssertionError("the worst case left its rounds early")
    time_pair("B4 label_components_ccl, all 12 rounds bind", worst.shape,
              card, lambda: label_components_ccl_rounds(worst, 12),
              lambda: label_components(worst, iters=12))


def edge_cases(dev, shape) -> None:
    """B1 and B2 against their twins on inputs the bench scene does not
    reach: a scene where the 12-round CCL cap binds, uniform noise at bench
    shape, and run layouts of one run, all invalid, single-element runs
    and random runs with an invalid tail, at 2048 rows and cut to 256 and
    200 rows."""
    import torch

    from chalkydri_tpu_torch.ops.ccl_extract import (
        threshold_ccl_extract,
        threshold_ccl_extract_plain,
    )
    from chalkydri_tpu_torch.ops.segment_stats import (
        segment_stats,
        segment_stats_plain,
    )

    rng = np.random.default_rng(7)
    grays = [serpentine()[None],
             rng.integers(0, 256, shape, dtype=np.uint8)]
    for i, g in enumerate(grays):
        x = torch.from_numpy(g).to(dev)
        require_equal(f"B1 case {i}", ("black", "white", "payload"),
                      threshold_ccl_extract(x, iters=12),
                      threshold_ccl_extract_plain(x, iters=12))
    n, int_max = 2048, 2 ** 31 - 1
    runs = np.sort(np.repeat(rng.integers(0, 1 << 30, 40), 45)[:n - 100])
    keys = np.stack([
        np.full(n, 7), np.full(n, int_max), np.arange(n),
        np.concatenate([runs, np.full(n - len(runs), int_max)]),
    ]).astype(np.int32)
    payloads = rng.integers(0, 1 << 29, keys.shape, dtype=np.int32)
    k = torch.from_numpy(keys).to(dev)
    p = torch.from_numpy(payloads).to(dev)
    names = ("t", "cand_len", "cand_pos")
    require_equal("B2 adversarial layouts", names, segment_stats(k, p),
                  segment_stats_plain(k, p))
    for m in (256, 200):  # under one 1024-row tile, and off the 128 chunk
        km, pm = k[:, :m].contiguous(), p[:, :m].contiguous()
        require_equal(f"B2 at n = {m}", names, segment_stats(km, pm),
                      segment_stats_plain(km, pm))
    # [4, 65536] as the main path's, with a valid run over three tile
    # boundaries (rows 1000-3999) among random runs, an invalid tail, and
    # row counts that end inside a 1024-row tile
    n = 65536
    lengths = rng.integers(1, 400, 600)
    lengths[0], lengths[1] = 1000, 3000
    runs = np.repeat(np.sort(rng.choice(1 << 30, 600, replace=False)),
                     lengths)[:n - 5000]
    keys = np.stack([np.concatenate([runs, np.full(n - len(runs), int_max)]),
                     np.full(n, 7), np.arange(n), np.full(n, int_max)])
    k = torch.from_numpy(keys.astype(np.int32)).to(dev)
    p = torch.from_numpy(
        rng.integers(0, 1 << 29, keys.shape, dtype=np.int32)).to(dev)
    for m in (n, 65152, 5000):
        km, pm = k[:, :m].contiguous(), p[:, :m].contiguous()
        require_equal(f"B2 at [4, {m}]", names, segment_stats(km, pm),
                      segment_stats_plain(km, pm))


def routes(dev, card, dep_small, big) -> None:
    """B1 on both routes of its wrapper: the deployed rig's decimated
    frames [2, 652, 800] (the cluster route, 16 CTAs a frame), timed; and
    one frame over the cluster route's capacity (1280x800, the chain of
    launches), which only direct callers send."""
    from chalkydri_tpu_torch.ops.ccl_extract import (
        cluster_size,
        threshold_ccl_extract,
        threshold_ccl_extract_plain,
    )

    chain = threshold_ccl_extract.chain_launches
    require_equal("B1 deployed qd2", ("black", "white", "payload"),
                  threshold_ccl_extract(dep_small, iters=12),
                  threshold_ccl_extract_plain(dep_small, iters=12))
    if threshold_ccl_extract.chain_launches != chain:
        raise AssertionError("B1 deployed qd2: took the chain route")
    time_kernel(f"B1 threshold_ccl_extract deployed qd2, cluster of "
                f"{cluster_size(*dep_small.shape)}", dep_small.shape, card,
                lambda: threshold_ccl_extract(dep_small, iters=12),
                lambda: threshold_ccl_extract_plain(dep_small, iters=12),
                threshold_ccl_extract, 1)
    require_equal("B1 chain route", ("black", "white", "payload"),
                  threshold_ccl_extract(big, iters=12),
                  threshold_ccl_extract_plain(big, iters=12))
    if (cluster_size(*big.shape) is not None
            or threshold_ccl_extract.chain_launches != chain + 1):
        raise AssertionError("B1 chain route: not taken")
    print(f"B1 routes: [2, 652, 800] on the cluster route, "
          f"{list(big.shape)} on the chain route, both bit-identical",
          flush=True)


def gate_checks(label, bands, merged) -> int:
    """B6's propagate entry with a per-frame gate, on each band of
    ``bands`` with its labels ``merged``, on both routes (the wrapper's
    cluster route and ``propagate_components_global``): no gate, every
    frame active, none, and each frame alone, each bit-identical to the
    plain version with the same gate, and the output of an inactive frame
    equal to its labels. Returns the calls checked."""
    import torch

    from chalkydri_tpu_torch.ops.propagate import (
        band_cluster_size,
        propagate_components_blocked,
        propagate_components_blocked_plain,
        propagate_components_global,
    )

    checked = 0
    for j, (t, m) in enumerate(zip(bands, merged)):
        b = t.shape[0]
        if band_cluster_size(*t.shape) is None:
            raise AssertionError(f"{label} band {j}: not on the cluster route")
        gates = [None, torch.ones(b, dtype=torch.int32, device=t.device),
                 torch.zeros(b, dtype=torch.int32, device=t.device)]
        gates += [torch.nn.functional.one_hot(
            torch.tensor(i, device=t.device), b).to(torch.int32)
            for i in range(b)] if b > 1 else []
        for active in gates:
            want = propagate_components_blocked_plain(t, m, active=active)
            for route, fn in (("cluster", propagate_components_blocked),
                              ("global", propagate_components_global)):
                got = fn(t, m, active=active)
                require_equal(f"{label} band {j} {route} route, gate "
                              f"{None if active is None else active.tolist()}",
                              ("labels",), (got,), (want,))
                off = (torch.zeros(b, dtype=torch.bool, device=t.device)
                       if active is None else active == 0)
                if not torch.equal(got[off], m[off]):
                    raise AssertionError(f"{label} band {j} {route} route: "
                                         f"an inactive frame's labels moved")
                checked += 1
    return checked


def band_phases(dev, card, frames_sp):
    """B6 and B7 against their plain twins on the spatial scene's row bands
    (full resolution and decimated), on a whole frame, and on a snake that
    crosses every seam of four bands; B6's per-frame gate on both routes
    (``gate_checks``) at every band and on two snakes. Times them at the
    full-resolution band shape, with their device time and device launches
    a call, and B6's propagate entry with no frame active. Returns
    {kernel: (err, ms, plain_ms, bytes, ops, device_ms, device launches a
    call)} and, under "propagate inactive", (ms, plain_ms, device_ms,
    device launches a call)."""
    import torch

    from chalkydri_tpu_torch.detector.cluster import extract_boundary_points
    from chalkydri_tpu_torch.detector.pipeline import decimate2
    from chalkydri_tpu_torch.detector.segment import INVALID, padded_width
    from chalkydri_tpu_torch.detector.threshold import adaptive_threshold
    from chalkydri_tpu_torch.ops.extract_blocked import (
        extract_candidates_band,
        extract_candidates_band_plain,
        extract_candidates_blocked,
    )
    from chalkydri_tpu_torch.ops.propagate import (
        label_components_blocked,
        label_components_blocked_plain,
        propagate_components_blocked,
        propagate_components_blocked_plain,
    )
    from chalkydri_tpu_torch.parallel.mesh import (
        gather_frames,
        make_mesh,
        place_frames,
    )
    from chalkydri_tpu_torch.parallel.sharded_stages import (
        _ici_seam_min,
        _with_seam_rows,
        label_components_block_kernel,
        label_components_block_kernel_rounds,
    )

    mesh = make_mesh([dev] * BANDS, space=BANDS)
    out = {}
    for qd, frames in ((1, frames_sp), (2, decimate2(frames_sp))):
        tern = adaptive_threshold(frames)
        bands = place_frames(mesh, tern, spatial=True)[0]
        hl, w = bands[0].shape[1:]
        stride = hl * padded_width(w)
        # B6, first entry: every band from flat indices
        local = [label_components_blocked(t) for t in bands]
        for j, (t, lab) in enumerate(zip(bands, local)):
            require_equal(f"B6 label qd{qd} band {j}", ("labels",), (lab,),
                          (label_components_blocked_plain(t),))
        # B6, second entry: globally offset labels after one seam exchange
        labels = [torch.where(lab == INVALID, lab, lab + j * stride)
                  for j, lab in enumerate(local)]
        seams = _ici_seam_min(labels, bands)
        merged = [_with_seam_rows(lab, top, bottom)
                  for lab, (top, bottom) in zip(labels, seams)]
        moved = sum(int((m != lab).sum()) for m, lab in zip(merged, labels))
        if moved == 0:
            raise AssertionError(f"qd{qd}: no tag crosses a band seam")
        for j, (t, m) in enumerate(zip(bands, merged)):
            require_equal(f"B6 propagate qd{qd} band {j}", ("labels",),
                          (propagate_components_blocked(t, m),),
                          (propagate_components_blocked_plain(t, m),))
        gates = gate_checks(f"B6 gate qd{qd}", bands, merged)
        print(f"B6 gate qd{qd}: {gates} calls ({BANDS} bands x no gate, "
              f"every frame active, none, each frame alone x the cluster "
              f"and the global-memory route) bit-identical to the plain "
              f"version, inactive frames' labels unchanged", flush=True)
        # B7: the whole frame, and every band with its halo rows
        whole_labels = gather_frames([label_components_block_kernel(bands)])
        whole = extract_candidates_blocked(tern, whole_labels)
        require_equal(f"B7 whole frame qd{qd}", ("black", "white", "payload"),
                      whole, extract_boundary_points(tern, whole_labels))
        b, h = tern.shape[:2]
        t_pad = torch.nn.functional.pad(tern, (0, 0, 1, 2), value=127)
        l_pad = torch.nn.functional.pad(whole_labels, (0, 0, 1, 2),
                                        value=INVALID)
        for j in range(BANDS):
            t_ext = t_pad[:, j * hl:(j + 1) * hl + 3].contiguous()
            l_ext = l_pad[:, j * hl:(j + 1) * hl + 3].contiguous()
            got = extract_candidates_band(t_ext, l_ext, 1, 2, j * hl)
            require_equal(f"B7 band {j} qd{qd}", ("black", "white", "payload"),
                          got, extract_candidates_band_plain(t_ext, l_ext, 1, 2,
                                                             j * hl))
            for g, wh in zip(got, whole):  # the whole-frame run's slots
                if not torch.equal(g.reshape(b, 2, hl, w),
                                   wh.reshape(b, 2, h, w)[:, :, j * hl:(j + 1) * hl]):
                    raise AssertionError(f"B7 band {j} qd{qd}: differs from "
                                         f"the whole-frame extraction")
        print(f"B6/B7 qd{qd}: {BANDS} bands of {tuple(bands[0].shape)} "
              f"bit-identical to their twins; the seam exchange lowered "
              f"{moved} labels; band extraction equals the whole frame's",
              flush=True)
        if qd != 1:
            continue
        # time at the band that holds the tags' upper halves
        j = BANDS // 2 - 1
        t, m = bands[j], merged[j]
        t_ext = t_pad[:, j * hl:(j + 1) * hl + 3].contiguous()
        l_ext = l_pad[:, j * hl:(j + 1) * hl + 3].contiguous()
        px, px_ext = t.numel(), t_ext.numel()
        wrappers = {"label_components_blocked": label_components_blocked,
                    "propagate_components_blocked":
                    propagate_components_blocked,
                    "extract_candidates_band": extract_candidates_band}
        pairs = {
            "label_components_blocked": (
                lambda: label_components_blocked(t),
                lambda: label_components_blocked_plain(t),
                px * (1 + 4), px * UNION_FIND_OPS),
            "propagate_components_blocked": (
                lambda: propagate_components_blocked(t, m),
                lambda: propagate_components_blocked_plain(t, m),
                px * (1 + 4 + 4), px * (UNION_FIND_OPS + 2)),
            "extract_candidates_band": (
                lambda: extract_candidates_band(t_ext, l_ext, 1, 2, j * hl),
                lambda: extract_candidates_band_plain(t_ext, l_ext, 1, 2,
                                                      j * hl),
                px_ext * (1 + 4) + px * 24, px * EXTRACT_OPS),
        }
        for name, (kernel, plain, nbytes, ops) in pairs.items():
            err = max_abs_err(_as_tuple(kernel()), _as_tuple(plain()))
            ms, plain_ms, dev_ms, dev_launches = time_kernel(
                f"{'B7' if 'band' in name else 'B6'} {name}",
                t_ext.shape if "band" in name else t.shape, card, kernel,
                plain, wrappers[name], 1)
            out[name] = (err, ms, plain_ms, nbytes, ops, dev_ms, dev_launches)
        # a round in which no frame is active: the launch copies the labels
        off = torch.zeros(t.shape[0], dtype=torch.int32, device=dev)
        out["propagate inactive"] = time_kernel(
            "B6 propagate_components_blocked, no frame active", t.shape, card,
            lambda: propagate_components_blocked(t, m, active=off),
            lambda: propagate_components_blocked_plain(t, m, active=off),
            propagate_components_blocked, 1)

    # a snake through every seam of four 16-row bands, and beside it a
    # shorter one, which ends its seam rounds earlier
    serp = torch.from_numpy(np.stack(
        [serpentine(stripes=6), serpentine(stripes=2)])).to(dev)
    serp_bands = place_frames(mesh, serp, spatial=True)[0]
    got, rounds = kernel_run(
        "B6 serpentine over bands",
        lambda: label_components_block_kernel_rounds(serp_bands,
                                                     outer_rounds=100),
        ("label_components_blocked", "propagate_components_blocked"))
    want, want_rounds = plain_run(
        "B6 serpentine over bands",
        lambda: label_components_block_kernel_rounds(serp_bands,
                                                     outer_rounds=100))
    got, want = gather_frames([got]), gather_frames([want])
    require_equal("B6 serpentine over bands", ("labels", "rounds"),
                  (got, rounds), (want, want_rounds))
    if len(torch.unique(got[0][serp[0] == 255])) != 1:
        raise AssertionError("B6 serpentine: the snake has more than 1 label")
    if rounds[0] <= 2 * BANDS + 2 or rounds[0] == rounds[1]:
        raise AssertionError(f"B6 serpentine: rounds {rounds.tolist()}")
    stride = serp_bands[0].shape[1] * padded_width(serp.shape[2])
    local = [label_components_blocked(t) for t in serp_bands]
    labels = [torch.where(lab == INVALID, lab, lab + j * stride)
              for j, lab in enumerate(local)]
    merged = [_with_seam_rows(lab, top, bottom) for lab, (top, bottom)
              in zip(labels, _ici_seam_min(labels, serp_bands))]
    gates = gate_checks("B6 gate serpentine", serp_bands, merged)
    print(f"B6 serpentine: a snake that crosses every seam of 4 bands and "
          f"a shorter one, labels and seam rounds bit-identical to the twins' "
          f"loop (rounds run {rounds.tolist()} of 100), the whole snake one "
          f"label; the gate on its bands: {gates} calls bit-identical, both "
          f"routes", flush=True)
    return out


def band_edge_cases(dev) -> None:
    """B6 (both entries) and B7 against their twins where the main path's
    bands do not reach: bands of 1-3 rows and of odd height, CTAs left
    without rows, widths that are no multiple of 4 or of 16, snakes
    through every CTA of a cluster, a band at the cluster budget and one
    row over it (the global-memory route, counted there); for B7 also
    no halo, halos of 0-2 rows, an input off 16-byte alignment and
    ``y_offset`` at the 13-bit limit. Labels handed to the propagate entry
    and to B7 are random (``INVALID`` on skip pixels)."""
    import torch

    from chalkydri_tpu_torch.detector.segment import INVALID
    from chalkydri_tpu_torch.ops.extract_blocked import (
        extract_candidates_band,
        extract_candidates_band_plain,
    )
    from chalkydri_tpu_torch.ops.propagate import (
        band_cluster_size,
        label_components_blocked,
        label_components_blocked_plain,
        propagate_components_blocked,
        propagate_components_blocked_plain,
    )
    from chalkydri_tpu_torch.tools.scenes import blob_tern

    gen = torch.Generator(dev).manual_seed(5)

    def random_labels(tern):
        lab = torch.randint(0, 1 << 30, tern.shape, generator=gen,
                            device=dev, dtype=torch.int32)
        return torch.where(tern == 127, INVALID, lab)

    # the most rows of 1600 px the cluster route takes
    fit = max(h for h in range(1, 1024) if band_cluster_size(1, h, 1600))
    terns = [torch.from_numpy(blob_tern(s, i)).to(dev) for i, s in enumerate(
        ((1, 1, 1600), (2, 2, 800), (1, 3, 37), (2, 17, 800), (1, 50, 1600),
         (2, 41, 36), (3, 329, 1601), (1, fit, 1600), (1, fit + 1, 1600)))]
    terns += [torch.from_numpy(serpentine(64, 128, 20)[None]).to(dev),
              torch.from_numpy(serpentine(328, 1600, 200)[None]).to(dev)]
    routes = []
    for tern in terns:
        shape = tuple(tern.shape)
        c = band_cluster_size(*shape)
        before = (label_components_blocked.global_launches,
                  propagate_components_blocked.global_launches)
        require_equal(f"B6 label {shape}", ("labels",),
                      (label_components_blocked(tern),),
                      (label_components_blocked_plain(tern),))
        lab = random_labels(tern)
        require_equal(f"B6 propagate {shape}", ("labels",),
                      (propagate_components_blocked(tern, lab),),
                      (propagate_components_blocked_plain(tern, lab),))
        after = (label_components_blocked.global_launches,
                 propagate_components_blocked.global_launches)
        if after != tuple(n + (c is None) for n in before):
            raise AssertionError(f"B6 {shape}: route {c}, but global-route "
                                 f"launches went {before} -> {after}")
        routes.append(f"{list(shape)}: {c or 'global'}")
    if band_cluster_size(1, fit, 1600) != 16 or band_cluster_size(
            1, fit + 1, 1600) is not None:
        raise AssertionError(f"B6: {fit} rows of 1600 px are not the "
                             f"cluster route's last")
    snake = terns[-1]
    if len(torch.unique(label_components_blocked(snake)[snake == 255])) != 1:
        raise AssertionError("B6 serpentine: the snake has more than 1 label")
    print(f"B6 edge cases bit-identical (both entries; shape: CTAs a "
          f"cluster): {', '.join(routes)}; the 200-stripe snake one label",
          flush=True)

    cases = []
    for i, (shape, top, bottom, y_off) in enumerate((
            ((2, 331, 1600), 1, 2, 984), ((1, 20, 37), 1, 2, 5),
            ((2, 13, 201), 0, 0, 0), ((1, 11, 36), 1, 1, 7),
            ((1, 9, 130), 0, 2, 3), ((1, 11, 800), 1, 2, 4096 - 8),
            ((2, 4, 1600), 1, 2, 1), ((1, 260, 800), 2, 0, 17))):
        tern = torch.from_numpy(blob_tern(shape, 20 + i)).to(dev)
        lab = random_labels(tern)
        got = extract_candidates_band(tern, lab, top, bottom, y_off)
        require_equal(f"B7 {shape} halos {top}/{bottom}",
                      ("black", "white", "payload"), got,
                      extract_candidates_band_plain(tern, lab, top, bottom,
                                                    y_off))
        cases.append(f"{list(shape)} halos {top}/{bottom} y_offset {y_off}")
    # an input 1 byte off 16-byte alignment (the kernel stages it bytewise)
    shape = (1, 19, 800)
    store = torch.empty(19 * 800 + 1, dtype=torch.uint8, device=dev)
    tern = store[1:].view(shape)
    tern.copy_(torch.from_numpy(blob_tern(shape, 40)))
    lab = random_labels(tern)
    require_equal("B7 unaligned tern", ("black", "white", "payload"),
                  extract_candidates_band(tern, lab, 1, 2, 40),
                  extract_candidates_band_plain(tern, lab, 1, 2, 40))
    print(f"B7 edge cases bit-identical: {'; '.join(cases)}; "
          f"{list(shape)} 1 byte off alignment", flush=True)


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def check_path(label, outs, true_x, true_y) -> float:
    """All four ids in every frame of every step, finite outputs, each
    frame's pose within POSE_TOL_M of its truth; the largest error."""
    import torch

    from chalkydri_tpu_torch.tools.scenes import TAGS

    for i, out in enumerate(outs):
        for b in range(out.pose_x.shape[0]):
            ids = sorted(out.detections.ids[b][out.detections.valid[b]].tolist())
            if ids != sorted(TAGS):
                raise AssertionError(f"{label} step {i} frame {b}: ids {ids}")
        for name, v in (("pose_x", out.pose_x), ("pose_y", out.pose_y),
                        ("pose_yaw", out.pose_yaw),
                        ("std_devs", out.std_devs),
                        ("corners", out.detections.corners)):
            if not torch.isfinite(v).all():
                raise AssertionError(f"{label} step {i}: non-finite {name}")
        err = torch.hypot(out.pose_x - true_x, out.pose_y - true_y)
        if not (out.pose_valid.all() and (err <= POSE_TOL_M).all()):
            raise AssertionError(f"{label} step {i}: pose error "
                                 f"{err.tolist()} m, valid "
                                 f"{out.pose_valid.tolist()}")
    return max(float(torch.hypot(out.pose_x - true_x,
                                 out.pose_y - true_y).max()) for out in outs)


def compare_outputs(label, ref, other, exact_pose: bool = False) -> None:
    """Integer outputs equal, floats within the CPU parity tolerances, and
    the std-devs' distrust (the dtype's max) alike; with ``exact_pose``
    the solve's outputs (pose, yaw, std-devs) bit for bit. Without it the
    std-devs are not compared by value: in float32 they scale with the
    square root of the fit's energy, a sum that cancels to a residual
    below its rounding at these scenes (the planar mirror's float32
    std-devs lie 91 % from the float64 chain's), so another slot order or
    corners a few ulps off move them by tens of percent."""
    import torch

    for name in ("ids", "hammings", "valid", "dropped_points"):
        if not torch.equal(getattr(ref.detections, name),
                           getattr(other.detections, name)):
            raise AssertionError(f"{label}: {name} differs")
    for name in ("tag_count", "pose_valid"):
        if not torch.equal(getattr(ref, name), getattr(other, name)):
            raise AssertionError(f"{label}: {name} differs")
    valid = ref.detections.valid
    checks = (
        ("corners", ref.detections.corners[valid],
         other.detections.corners[valid], CORNER_TOL),
        ("pose_x", ref.pose_x, other.pose_x, POSE_TOL),
        ("pose_y", ref.pose_y, other.pose_y, POSE_TOL),
        ("pose_yaw", ref.pose_yaw, other.pose_yaw, YAW_TOL),
    )
    for name, a, b, tol in checks:
        if float((a - b).abs().max()) > tol:
            raise AssertionError(f"{label}: {name} differs")
    if not torch.equal(ref.std_devs.abs() > 1e30, other.std_devs.abs() > 1e30):
        raise AssertionError(f"{label}: std-devs distrust differs")
    if exact_pose:
        for name in ("pose_x", "pose_y", "pose_yaw", "std_devs"):
            if not torch.equal(_bits(getattr(ref, name)),
                               _bits(getattr(other, name))):
                raise AssertionError(f"{label}: {name} not bit-identical")
    m_a = ref.detections.decision_margins[valid]
    m_b = other.detections.decision_margins[valid]
    if not ((m_a - m_b).abs() <= 1e-3 * m_b.abs().clamp(min=1.0)).all():
        raise AssertionError(f"{label}: decision margins differ")


def in_slot_order_of(label, ref, out):
    """``out`` with each frame's detection slots moved to where ``ref``
    holds the same tag id, after checking that the move is one between
    tied slots only: slots are ranked by decision margin, and between
    equal margins by the order of the clusters, which follows the hash of
    their labels (flat indices on one card at ``quad_decimate=2``,
    padded-flat ones in the row bands). A slot may move only onto a slot
    whose margin is the same float, in ``ref`` and in ``out``; any other
    difference of order raises. Returns (out reordered, slots moved)."""
    import torch

    d_ref, d_out = ref.detections, out.detections
    big = torch.iinfo(torch.int32).max
    order_ref = torch.argsort(torch.where(d_ref.valid, d_ref.ids, big),
                              dim=1, stable=True)
    order_out = torch.argsort(torch.where(d_out.valid, d_out.ids, big),
                              dim=1, stable=True)
    # perm[b, s]: the slot of ``out`` that goes to slot s
    perm = torch.empty_like(order_ref).scatter_(1, order_ref, order_out)
    for name, d in (("single-card", d_ref), ("row-banded", d_out)):
        m = d.decision_margins
        if not torch.equal(m.gather(1, perm)[d_ref.valid], m[d_ref.valid]):
            raise AssertionError(
                f"{label}: slot order differs between slots whose "
                f"{name} decision margins do not tie: perm "
                f"{perm.tolist()}, margins {m.tolist()}")
    moved = int((perm != torch.arange(perm.shape[1], device=perm.device))
                [d_ref.valid].sum())

    def take(x):
        idx = perm.reshape(*perm.shape, *([1] * (x.dim() - 2)))
        return x.gather(1, idx.expand_as(x))

    return out._replace(detections=d_out._replace(
        ids=take(d_out.ids), corners=take(d_out.corners),
        hammings=take(d_out.hammings),
        decision_margins=take(d_out.decision_margins),
        valid=take(d_out.valid))), moved


def replay_launches(step, counters, replays: int) -> dict:
    """The launches that ``replays`` replays of ``step`` (a CapturedStep
    holding one graph, or a ``sharded`` step whose ``.pipes`` are such)
    make, by kernel: what the captures recorded, times the replays."""
    entries = [e for pipe in getattr(step, "pipes", [step])
               for e in pipe.graphs.values()]
    if len(entries) != len(getattr(step, "pipes", [step])):
        raise AssertionError(f"{len(entries)} graphs, one a step expected")
    return {name: replays * sum(n for entry in entries
                                for (fn, attr), n in entry.tally.items()
                                if fn is counters[name] and attr == "launches")
            for name in counters}


def sharded(step, place, dev):
    """``make_sharded_vision_pipeline``'s ``(step, place)`` as one step of
    ``(frames, gyro)``: each data group's step replayed where it is a
    CUDA graph; ``.module`` is the eager step (every group's ``.module``),
    ``.pipes`` the groups' steps."""
    from chalkydri_tpu_torch.parallel.pipeline import _concat

    def run(frames, gyro):
        return step(*place(frames, gyro))

    def eager(frames, gyro):
        bands, gyros = place(frames, gyro)
        outs = [pipe.module(*b, g)
                for pipe, b, g in zip(step.pipes, bands, gyros)]
        return outs[0] if len(outs) == 1 else _concat(outs, dev)

    run.module, run.pipes = eager, step.pipes
    return run


def reads_host(fn) -> bool:
    """Whether ``fn()`` makes a synchronizing CUDA call (a host read):
    it runs under PyTorch's sync debug mode "error", which raises at the
    first such call."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    except RuntimeError as e:
        if "synchronizing" not in str(e):
            raise
        return True
    finally:
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    return False


def drive_path(label, step, frames, true_xy_yaw, counters, expect, card,
               timed_steps, against=None, ties_may_reorder=False):
    """The path through ``step``: launch counts from 0 over STEPS checked
    steps, every expected kernel launched (and no other), ids and poses,
    the twin-only step compared (and the step ``against``, where given:
    slot for slot, or with ``ties_may_reorder`` after moving slots of
    equal decision margin only), then timed in turns (twins, kernels,
    kernels, twins). A captured step (``utils/graph.py``) captures its
    graph in an untimed first call before the counts go to 0; its STEPS
    steps are replays, each of which must launch what the capture
    recorded, and its twin-only step is its eager module's. Returns the
    launch counts."""
    import torch

    true_x, true_y, true_yaw = (torch.tensor(v, dtype=torch.float32,
                                             device=frames.device)
                                for v in zip(*true_xy_yaw))
    gyros = [true_yaw + d for d in GYRO_OFFSETS]
    eager = getattr(step, "module", step)
    if eager is not step:
        step(frames, gyros[0])
    for fn in counters.values():
        fn.launches = 0
    outs = [step(frames, g) for g in gyros[:STEPS]]
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    print(f"{label}: {STEPS} steps, kernel launches {launches}", flush=True)
    for name, n in launches.items():
        if (n > 0) != (name in expect):
            raise AssertionError(f"{label}: kernel {name} launched {n} times"
                                 f" (expected on this path: {name in expect})")
    if eager is not step and launches != replay_launches(step, counters,
                                                         STEPS):
        raise AssertionError(f"{label}: {launches} launches in {STEPS} "
                             f"replays of a graph that recorded "
                             f"{replay_launches(step, counters, 1)}")
    pose_err = check_path(label, outs, true_x, true_y)
    print(f"{label} poses: 4 ids in each of {frames.shape[0]} frames, each "
          f"frame's pose against its own truth: max position error "
          f"{pose_err:.5f} m, yaw {outs[0].pose_yaw.tolist()}", flush=True)

    plain_out = plain_run(label, lambda: eager(frames, gyros[0]))
    # one card, the same detections: the solve kernel is the twin's bits
    compare_outputs(f"{label} vs plain twins", outs[0], plain_out,
                    exact_pose=against is None)
    print(f"{label} vs plain twins: equal; no kernel launched inside "
          f"build.plain_chain(), each of the path's {len(expect)} kernels "
          f"outside it", flush=True)
    if against is not None:
        ref, got, how = against(frames, gyros[0]), outs[0], "slot for slot"
        if ties_may_reorder:
            got, moved = in_slot_order_of(label, ref, got)
            how = (f"{moved} slots moved, each onto a slot of the same "
                   f"decision margin: single-card ids "
                   f"{ref.detections.ids[ref.detections.valid].tolist()} "
                   f"margins "
                   f"{ref.detections.decision_margins[ref.detections.valid].tolist()}"
                   f", row-banded ids "
                   f"{outs[0].detections.ids[outs[0].detections.valid].tolist()}")
        compare_outputs(f"{label} vs single-card step", ref, got)
        print(f"{label}: integer outputs equal to the single-card step's "
              f"({how}), floats within {CORNER_TOL}", flush=True)

    def step_times(plain: bool) -> list[float]:
        times = []
        for i in range(timed_steps + 1):
            torch.cuda.synchronize()
            t = time.perf_counter()
            if plain:
                plain_run(label, lambda: eager(frames, gyros[i % STEPS]))
            else:
                step(frames, gyros[i % STEPS])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return times[1:]

    plain_a, kern_a = step_times(True), step_times(False)
    kern_b, plain_b = step_times(False), step_times(True)
    b, h, w = frames.shape[:3]
    kernels = "kernels" if eager is step else "kernels, replayed"
    for kind, times in ((kernels, kern_a + kern_b),
                        ("plain twins", plain_a + plain_b)):
        med = statistics.median(times)
        p75 = statistics.quantiles(times, n=4)[2]
        print(f"{label} step {b}x{h}x{w} {kind}: median {med:.3f} ms "
              f"({b / med * 1e3:.1f} frames/s), p75 {p75:.3f} ms, "
              f"{len(times)} host-clock steps [{card}]", flush=True)
    return launches


def differing(a, b) -> list[str]:
    """The fields of two VisionOutputs that differ in any bit."""
    import torch

    def bits(x):
        return x.contiguous().view(-1).view(torch.uint8)

    names = [*a._fields[:-1], *a.detections._fields]
    return [n for n, x, y in zip(names, [*a[:-1], *a.detections],
                                 [*b[:-1], *b.detections])
            if x.shape != y.shape or not torch.equal(bits(x), bits(y))]


def graph_path(label, step, eager, frames, gyro, wrappers, counters,
               card) -> None:
    """A captured step (``utils/graph.py``) against its eager module on
    two inputs (``frames`` and its LSB-toggled copy, ``gyro`` and gyro +
    0.01): the eager step run twice must be bit-identical to itself; the
    first call captures (unless the step already holds its graph);
    GRAPH_REPLAYS replays on the inputs in turn must each equal the eager
    output of their input bit for bit, and so must the first call's
    output after the last replay; each replay must launch the kernels
    that the captures of ``wrappers`` (the CapturedSteps that ``step``
    calls, one graph each) recorded. Then eager and replayed steps on the
    host clock around a synced call (in turns: eager, replay, replay,
    eager), and the profiler over replays."""
    import torch

    from chalkydri_tpu_torch.tools.perfprobe import device_share, share_line
    from chalkydri_tpu_torch.utils.graph import WARMUP_STEPS

    inputs = [(frames, gyro), (frames ^ 1, gyro + 0.01)]
    want = [eager(*x) for x in inputs]
    nondet = differing(want[0], eager(*inputs[0]))
    if nondet:  # a float op whose order varies between runs; none known
        raise AssertionError(f"{label}: two eager steps on one input differ "
                             f"in {nondet}")
    first = step(*inputs[0])
    per_replay = {k: sum(replay_launches(w, counters, 1)[k] for w in wrappers)
                  for k in counters}
    per_replay = {k: n for k, n in per_replay.items() if n}
    graphs = [g for w in wrappers for g in w.graphs.values()]
    for fn in counters.values():
        fn.launches = 0
    outs = [step(*inputs[i % 2]) for i in range(GRAPH_REPLAYS)]
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    if launches != {k: GRAPH_REPLAYS * per_replay.get(k, 0)
                    for k in launches}:
        raise AssertionError(f"{label}: launches {launches} in "
                             f"{GRAPH_REPLAYS} replays of {per_replay} each")
    for i, out in enumerate(outs):
        if differing(want[i % 2], out):
            raise AssertionError(f"{label}: replay {i} differs from the eager "
                                 f"step in {differing(want[i % 2], out)}")
    if differing(want[0], first):
        raise AssertionError(f"{label}: the first output changed under later "
                             f"replays: {differing(want[0], first)}")

    def host_ms(fn, n):
        times = []
        for i in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn(*inputs[i % 2])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return times

    eager_ms = host_ms(eager, GRAPH_TIMED)
    replay_ms = host_ms(step, GRAPH_TIMED) + host_ms(step, GRAPH_TIMED)
    eager_ms += host_ms(eager, GRAPH_TIMED)
    share = device_share(step, frames, gyro)
    b = frames.shape[0]

    def stats(times):
        med = statistics.median(times)
        return (f"median {med:.3f} ms ({b / med * 1e3:.1f} frames/s), p75 "
                f"{statistics.quantiles(times, n=4)[2]:.3f} ms")

    print(f"graph {label} {'x'.join(map(str, frames.shape))}: replay = "
          f"eager bit for bit over {GRAPH_REPLAYS} replays on alternating "
          f"inputs, the first output unchanged after the last, eager "
          f"bit-identical to itself; launches "
          f"{ {k: n for k, n in launches.items() if n} } "
          f"({per_replay} a replay); "
          f"{len(graphs)} graph(s), warm-up "
          f"{sum(g.warmup_ms for g in graphs):.1f} ms ({WARMUP_STEPS} eager "
          f"steps a graph), capture + instantiate "
          f"{sum(g.capture_ms for g in graphs):.1f} ms [{card}]", flush=True)
    print(f"graph {label} step, host clock around a synced call: eager "
          f"{stats(eager_ms)}; replayed {stats(replay_ms)}; "
          f"{len(eager_ms)} + {len(replay_ms)} steps; profiler over 3 "
          f"replays: {share_line(share)} [{card}]", flush=True)


def kernel_entry(name, source, replaces, launches, err, ms, plain_ms,
                 bytes_moved, ops):
    bound_ms, bound_by = bound(bytes_moved, ops)
    return {"name": name, "route": "cuda",
            "source": f"chalkydri_tpu_torch/csrc/{source}",
            "replaces": f"chalkydri_tpu/ops/pallas/{replaces}",
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}  # no single PyTorch call computes these


def time_kernel(label, shape, card, kernel, plain, wrapper, per_call):
    """``time_pair`` with the kernel's device time a call (the sum of the
    kernels ``torch.profiler`` sees) and its device launches a call, on
    the same line. ``wrapper`` is the kernel's wrapper, which ``kernel``
    calls once; every call must show ``per_call`` device launches in the
    profiler's window (``device_times`` profiles again when launches went
    missing, and fails after five windows)."""
    from chalkydri_tpu_torch.tools.perfprobe import device_times

    ms = statistics.median(cuda_times_ms(kernel))
    plain_ms = statistics.median(cuda_times_ms(plain))
    kernels = device_times(kernel, per_call=per_call, wrapper=wrapper)
    device_ms = sum(k["us_per_call"] for k in kernels.values()) / 1e3
    launches = sum(k["launches_per_call"] for k in kernels.values())
    print(f"{label} {tuple(shape)}: kernel {ms:.4f} ms (device {device_ms:.4f}"
          f" ms, {launches:g} device launches a call), plain {plain_ms:.4f} "
          f"ms, bit-identical [{card}]", flush=True)
    return ms, plain_ms, device_ms, launches


def time_pair(label, shape, card, kernel, plain):
    """Median CUDA-event ms of the kernel's wrapper and of its twin."""
    ms = statistics.median(cuda_times_ms(kernel))
    plain_ms = statistics.median(cuda_times_ms(plain))
    print(f"{label} {tuple(shape)}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bit-identical [{card}]", flush=True)
    return ms, plain_ms


def b5_edge_cases(dev, serp, shape) -> None:
    """B5 against its twin on serpentines, whose snake crosses every
    border of B5's rectangles and must get one label (64x128 and the
    deployed shape), and at shapes direct callers may send: one tile, a
    4096-row strip, widths no multiple of 128 or 16, three frames, and
    gray off 4-byte alignment."""
    import torch

    from chalkydri_tpu_torch.ops.threshold_ccl import (
        threshold_ccl_exact,
        threshold_ccl_exact_plain,
    )
    from chalkydri_tpu_torch.tools.perfprobe import B5_STRIPES

    snake = torch.from_numpy(np.stack(
        [serpentine(*shape[1:], B5_STRIPES)] * shape[0])).to(dev)
    for label, gray in (("B5 serpentine", serp),
                        ("B5 deployed serpentine", snake)):
        got = threshold_ccl_exact(gray)
        require_equal(label, ("tern", "labels"), got,
                      threshold_ccl_exact_plain(gray))
        for j in range(len(gray)):
            if len(torch.unique(got[1][j][gray[j] == 255])) != 1:
                raise AssertionError(f"{label}: the snake has more than 1 "
                                     f"label")
    rng = np.random.default_rng(17)
    odd = ((1, 4, 4), (1, 4096, 8), (1, 68, 200), (2, 100, 36),
           (3, 132, 264))
    for s in odd:
        gray = torch.from_numpy(
            rng.integers(0, 256, s, dtype=np.uint8)).to(dev)
        require_equal(f"B5 {s}", ("tern", "labels"),
                      threshold_ccl_exact(gray),
                      threshold_ccl_exact_plain(gray))
    flat = torch.from_numpy(
        rng.integers(0, 256, 1 + 68 * 200, dtype=np.uint8)).to(dev)
    off = flat[1:].view(1, 68, 200)  # gray 1 byte off 4-byte alignment
    require_equal("B5 gray off alignment", ("tern", "labels"),
                  threshold_ccl_exact(off), threshold_ccl_exact_plain(off))
    print(f"B5 serpentines [1, 64, 128] and {list(shape)} "
          f"({B5_STRIPES} stripes): bit-identical, each snake one label; "
          f"noise bit-identical at {[list(s) for s in odd]} and with gray "
          f"1 byte off alignment", flush=True)


class FrameFeed:
    """A capture put in through ``camera._cap``: ``latest()`` gives the
    same frame each poll, stamped now, except on every ``gap_every``-th
    poll after ``gap_from``, which has no fresh frame."""

    def __init__(self, frame, gap_every=0, gap_from=0):
        self.frame, self.gap_every, self.gap_from = frame, gap_every, gap_from
        self.polls = self.given = self.gaps = 0
        self.last_fresh = False

    def latest(self):
        n, self.polls = self.polls, self.polls + 1
        self.last_fresh = not (self.gap_every and n >= self.gap_from
                               and n % self.gap_every == 0)
        if not self.last_fresh:
            self.gaps += 1
            return None
        self.given += 1
        return self.frame, time.monotonic_ns() // 1000

    def close(self):
        pass


def app_graph(calib, cams):
    """The App's task graph: one CamPipeline -> AprilTags chain per entry
    of ``cams`` (calib and mount JSON), cameras absent (frames are put in
    through ``camera._cap``), and the whacknet comm bundle."""
    from chalkydri_tpu_torch.runtime import TaskGraph

    tasks, cnx = [], []
    for i, cam in enumerate(cams):
        tasks += [
            {"id": f"camera_{i}", "type": "CamPipeline",
             "config": {"id": f"absent-{i}", "name": f"cam{i}",
                        "width": calib["width"], "height": calib["height"]}},
            {"id": f"apriltags_{i}", "type": "chalkydri_apriltags::AprilTags",
             "config": {"cam_id": i, "calib": cam["calib"],
                        "robot_to_cam": cam["robot_to_cam"]}}]
        cnx.append({"src": f"camera_{i}", "dst": f"apriltags_{i}",
                    "msg": "frame"})
    return TaskGraph.from_dict(
        {"tasks": tasks, "cnx": cnx,
         "resources": [{"id": "comm", "provider": "whacknet::CommBundle"}]})


def recv_all(sock) -> list:
    """Every datagram waiting on ``sock`` (its timeout ends the wait)."""
    import socket

    out = []
    while True:
        try:
            out.append(sock.recvfrom(64)[0])
        except socket.timeout:
            return out


def app_phase(dev, card, counters) -> None:
    """The runtime App at the deployed rig: two 1600x1304 cameras on
    mounts 0.3 m apart seeing tags 28-31 from one robot pose, the gyro
    from a robot socket, packets read from a loopback socket, at
    ``pipeline_depth`` 1 and 0. Checks every packet, the heartbeats, one
    B1 and one B2 launch per dispatched step and the outputs against a
    direct step; prints the App's rate, span times, packet latencies and
    the upload time of one staged batch."""
    import socket
    import struct

    import torch

    from chalkydri_tpu_torch.geometry.field_layout import load_field_layout
    from chalkydri_tpu_torch.io.whacknet import Comm, decode_measurement
    from chalkydri_tpu_torch.pipeline import (
        build_rig_from_config,
        make_vision_pipeline,
    )
    from chalkydri_tpu_torch.runtime import App
    from chalkydri_tpu_torch.tools.scenes import FIELD_JSON, SCENES, render_scene
    from chalkydri_tpu_torch.utils.tracing import SPANS

    calib, _, mount = SCENES["deployed"]
    cams = [{"calib": json.dumps({"OpenCVModel5": calib}),
             "robot_to_cam": json.dumps(dict(mount, y=y))}
            for y in APP_MOUNT_Y]
    layout = load_field_layout(FIELD_JSON, dtype=torch.float32, device=dev)
    frames = []
    for cam in cams:
        _, rc_one = build_rig_from_config([cam], layout, device="cpu")
        frames.append(render_scene(layout, rc_one, *APP_POSE, calib))
    params, rc = build_rig_from_config(cams, layout, device=dev)
    # the rig's eager step: the App's replayed outputs must equal it
    want = make_vision_pipeline(layout, params, rc, device=dev).module(
        torch.from_numpy(np.stack(frames)).to(dev),
        torch.full((len(cams),), APP_POSE[2], dtype=torch.float32,
                   device=dev))

    rio = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rio.bind(("127.0.0.1", 0))
    rio.settimeout(0.5)
    probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    probe.bind(("127.0.0.1", 0))
    gyro_port = probe.getsockname()[1]
    probe.close()
    comm = Comm(remote_addr="127.0.0.1", remote_port=rio.getsockname()[1],
                gyro_port=gyro_port)
    robot = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        deadline = time.monotonic() + 5.0
        while comm.gyro_angle() != APP_POSE[2]:  # the roboRIO's 8-byte double
            if time.monotonic() > deadline:
                raise AssertionError("app: the gyro datagram never arrived")
            robot.sendto(struct.pack("<d", APP_POSE[2]),
                         ("127.0.0.1", gyro_port))
            time.sleep(0.01)
        comm_path = "native" if comm._native is not None else "Python"
        graph = app_graph(calib, cams)
        for depth in (1, 0):
            label = f"app deployed path, pipeline_depth {depth}"
            app = App(graph, field_layout=layout, comm=comm,
                      pipeline_depth=depth, device=dev)
            app.start_all_tasks()
            g = app.groups[0]
            if not (len(app.groups) == 1 and g.frames_host.is_pinned()
                    and tuple(g.frames_host.shape) == (2, 1304, 1600)):
                raise AssertionError(f"{label}: staging "
                                     f"{tuple(g.frames_host.shape)}")
            feeds = [FrameFeed(frames[0]),
                     FrameFeed(frames[1], APP_GAP_EVERY, APP_WARMUP)]
            for ch, feed in zip(app.fused_chains, feeds):
                ch.camera._cap = feed
            outs = [app.run_one_iteration() for _ in range(APP_WARMUP)]
            torch.cuda.synchronize()
            recv_all(rio)
            in_flight = [depth == 1 and f.last_fresh for f in feeds]
            given = [f.given for f in feeds]
            gaps = [f.gaps for f in feeds]
            for fn in counters.values():
                fn.launches = 0
            SPANS.reset()
            t0 = time.perf_counter()
            outs = [app.run_one_iteration() for _ in range(APP_ITERS)]
            app.stop_all_tasks()  # publishes the batch still in flight
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            launches = {name: fn.launches for name, fn in counters.items()}
            packets = [decode_measurement(d) for d in recv_all(rio)]
            expect = dict.fromkeys(("threshold_ccl_extract", "segment_stats",
                                    "solve_frames", *TAIL_KERNELS),
                                   APP_ITERS)
            if launches != {k: expect.get(k, 0) for k in launches}:
                raise AssertionError(f"{label}: kernel launches {launches} "
                                     f"for {APP_ITERS} dispatched steps")
            for i, out in enumerate(o for o in outs if o is not None):
                if differing(want, out):
                    raise AssertionError(
                        f"{label} iteration {i}: {differing(want, out)} "
                        f"differ from the eager step's")
            n_out = sum(o is not None for o in outs)
            for pose, _, ts, cam, n in packets:
                if n and not (n == 4 and cam in (0, 1)
                              and math.hypot(pose.x - APP_POSE[0],
                                             pose.y - APP_POSE[1])
                              <= POSE_TOL_M):
                    raise AssertionError(f"{label}: packet cam {cam}, "
                                         f"{n} tags, {pose}")
            for c, feed in enumerate(feeds):
                valid = sum(1 for p in packets if p[3] == c and p[4])
                beats = sum(1 for p in packets if p[3] == c and not p[4])
                frames_seen = feed.given - given[c] + in_flight[c]
                if valid != frames_seen or beats != feed.gaps - gaps[c]:
                    raise AssertionError(
                        f"{label}: camera {c} sent {valid} poses and {beats} "
                        f"heartbeats for {frames_seen} frames and "
                        f"{feed.gaps - gaps[c]} polls without one")
            err = max(math.hypot(p[0].x - APP_POSE[0], p[0].y - APP_POSE[1])
                      for p in packets if p[4])
            # latency of the frames polled in the window: at depth 1 the
            # first packets carry the batch in flight from before it,
            # whose frames waited out the socket drain above
            lat = sorted(p[2] for p in packets[sum(in_flight):] if p[4])
            spans = SPANS.summary()
            print(f"{label}: {APP_ITERS} iterations, {APP_ITERS / wall:.2f} "
                  f"iterations/s, launches {launches} (one B1, one B2 and "
                  f"one solve a step); {len(packets)} packets: "
                  f"{sum(1 for p in packets if p[4])} poses, all 4 tags, "
                  f"max position error {err:.5f} m, "
                  f"{sum(1 for p in packets if not p[4])} heartbeats for "
                  f"{feeds[1].gaps - gaps[1]} polls without a frame; "
                  f"{n_out} outputs (replays) equal to the eager step's bit "
                  f"for bit", flush=True)
            print(f"{label} host ms p50/p90: " + ", ".join(
                f"{k} {spans[k]['p50_ms']:.3f}/{spans[k]['p90_ms']:.3f}"
                for k in ("app.capture", "app.dispatch", "app.fetch_publish"))
                + f"; packet latency field us p50 "
                f"{statistics.median(lat):.0f}, p99 "
                f"{lat[min(len(lat) - 1, len(lat) * 99 // 100)]} (the "
                f"{sum(in_flight)} packets of the batch in flight before "
                f"the window left out); comm path "
                f"{comm_path} [{card}]", flush=True)
            if depth == 0:
                h2d = statistics.median(cuda_times_ms(
                    lambda: g.frames_host.to(dev, non_blocking=True)))
                nbytes = g.frames_host.numel()
                print(f"app staged batch upload (pinned, non_blocking) "
                      f"{tuple(g.frames_host.shape)} u8, {nbytes} bytes: "
                      f"{h2d:.4f} ms ({nbytes / h2d / 1e6:.2f} GB/s) "
                      f"[{card}]", flush=True)

        # capacity_fallback: the 2x-budget step warms up in a thread on a
        # stream of its own while the loop runs its first steps, then
        # takes every batch that overflows the standard budget (4,096
        # candidates: the two views need about 4,300 each).
        label = "app capacity_fallback"
        dk = {"max_edge_points": 4096}
        want_big = make_vision_pipeline(
            layout, params, rc, device=dev,
            detector_kwargs={"max_edge_points": 8192}).module(
            torch.from_numpy(np.stack(frames)).to(dev),
            torch.full((len(cams),), APP_POSE[2], dtype=torch.float32,
                       device=dev))
        app = App(graph, field_layout=layout, comm=comm, device=dev,
                  detector_kwargs=dict(dk, capacity_fallback=True))
        g = app.groups[0]
        app.start_all_tasks()  # starts the warm-up thread
        for ch, f in zip(app.fused_chains, frames):
            ch.camera._cap = FrameFeed(f)
        SPANS.reset()
        for _ in range(3):
            app.run_one_iteration()
        if not g.step_big_ready.wait(timeout=120):
            raise AssertionError(f"{label}: the warm-up never finished")
        outs = [app.run_one_iteration() for _ in range(3)]
        app.stop_all_tasks()
        torch.cuda.synchronize()
        recv_all(rio)
        redispatched = SPANS.summary().get("app.capacity_redispatch",
                                           {}).get("n", 0)
        if redispatched < len(outs):
            raise AssertionError(f"{label}: {redispatched} redispatches")
        for i, out in enumerate(outs):
            if differing(want_big, out):
                raise AssertionError(
                    f"{label} iteration {i}: {differing(want_big, out)} "
                    f"differ from the eager 2x-budget step's")
        print(f"{label}: warm-up thread ready, {redispatched} overflowing "
              f"batches re-run on the 8,192-point step (points dropped "
              f"after: {app.dropped_points_total}), outputs equal to the "
              f"eager 8,192-point step's bit for bit, tag counts "
              f"{outs[-1].tag_count.tolist()} [{card}]", flush=True)
    finally:
        comm.close()
        rio.close()
        robot.close()


def main_phase(card) -> None:
    """``python -m chalkydri_tpu_torch.main`` on the example graph (two
    absent 1280x800 cameras, so synthetic scenes), packets to a loopback
    socket: it must exit 0 and log frames of both cameras."""
    import socket

    from chalkydri_tpu_torch.runtime import read_log

    out_dir = os.path.join(ROOT, "chalkydri_tpu_torch", "_build", "smoke")
    os.makedirs(out_dir, exist_ok=True)
    log = os.path.join(out_dir, "main.ctlog")
    config = os.path.join(out_dir, "chalkydri.toml")
    with open(config, "w") as f:
        f.write("team_number = 4533\n")
    rio = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rio.bind(("127.0.0.1", 0))
    rio.settimeout(0.5)
    try:
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "chalkydri_tpu_torch.main", "--graph",
             "examples/chalkydri.ron", "--field", "examples/field_2026.json",
             "--iters", str(MAIN_ITERS), "--rate", str(MAIN_RATE_HZ),
             "--log", log, "--config", config,
             "--robot-addr", f"127.0.0.1:{rio.getsockname()[1]}"],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        wall = time.perf_counter() - t0
        if r.returncode != 0:
            raise AssertionError(f"main exited {r.returncode}:\n"
                                 f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
        packets = recv_all(rio)
    finally:
        rio.close()
    per_cam = {}
    for rec in read_log(log):
        if rec["kind"] == "frame":
            per_cam[rec["cam_id"]] = per_cam.get(rec["cam_id"], 0) + 1
    if sorted(per_cam) != [0, 1]:
        raise AssertionError(f"main: frame records per camera {per_cam}")
    print(f"main: python -m chalkydri_tpu_torch.main --graph "
          f"examples/chalkydri.ron --iters {MAIN_ITERS} --rate "
          f"{MAIN_RATE_HZ} exited 0 in "
          f"{wall:.1f} s; log frame records per camera {per_cam}, "
          f"{len(packets)} packets [{card}]", flush=True)


def bench_phase(dev, card, counters) -> None:
    """``bench.py``'s twin (``chalkydri_tpu_torch/bench.py``) at
    ``BENCH_ITERS`` x ``BENCH_REPS``: its CPU denominator, then
    ``bench_gpu`` on the card with the launch counts set to 0 just before
    and read just after (one B1 and one B2 a step, on B1's cluster route,
    and no other kernel); the card's and the CPU's outputs held to the
    JAX outputs stored in ``tools/bench_scene.npz`` as the twin's ``main``
    holds them; prints the twin's JSON line."""
    from chalkydri_tpu_torch import bench as twin
    from chalkydri_tpu_torch.utils.graph import WARMUP_STEPS

    ref = twin.load_reference()
    frames = np.broadcast_to(ref["frame"], (twin.BATCH, twin.H, twin.W)).copy()
    cpu_fps, cpu_samples, cpu_out, cpu_ref = twin.bench_cpu_reference(frames)
    twin.check_outputs(cpu_out, ref, "bench path, cpu step")
    for fn in counters.values():
        fn.launches = 0
    counters["threshold_ccl_extract"].chain_launches = 0
    res = twin.bench_gpu(frames, BENCH_ITERS, BENCH_REPS, device=dev)
    launches = {name: fn.launches for name, fn in counters.items()}
    # the first call's eager warm-up steps and its replay, the eager
    # round, the replayed rounds
    replays = 1 + BENCH_ITERS * BENCH_REPS
    steps = WARMUP_STEPS + BENCH_ITERS + replays
    want = {name: steps if name in ("threshold_ccl_extract", "segment_stats",
                                    "solve_frames", *TAIL_KERNELS)
            else 0 for name in counters}
    if launches != want or counters["threshold_ccl_extract"].chain_launches:
        raise AssertionError(f"bench path: kernel launches {launches} over "
                             f"{steps} steps, expected {want} on B1's cluster "
                             f"route")
    twin.check_outputs(res.out, ref, "bench path, card step")
    print(f"bench path (bench.py's scene, {twin.BATCH} x {twin.W}x{twin.H}, "
          f"tags 1/5/9/13): {steps} steps ({replays} replays, "
          f"{WARMUP_STEPS + BENCH_ITERS} eager), kernel launches {launches}; "
          f"ids "
          f"{res.out.detections.ids[0][res.out.detections.valid[0]].tolist()}"
          f", pose ({float(res.out.pose_x[0]):.6f}, "
          f"{float(res.out.pose_y[0]):.6f}), card (replayed) and CPU outputs "
          f"equal to the stored JAX outputs within {CORNER_TOL}; replayed "
          f"step ms per round {[round(t, 3) for t in res.step_ms]}, eager "
          f"{res.eager_step_ms:.3f} [{card}]", flush=True)
    print(json.dumps(twin.result_line(res, cpu_fps, cpu_samples, cpu_ref,
                                      card)), flush=True)


class BoardFeed:
    """The calibration views put in through ``camera._cap``: each poll
    gives the next view once, stamped now, then nothing."""

    def __init__(self, frames):
        self.frames, self.given = frames, 0

    def latest(self):
        if self.given >= len(self.frames):
            return None
        self.given += 1
        return self.frames[self.given - 1], time.monotonic_ns() // 1000

    def close(self):
        pass


def calibration_phase(dev, card, counters) -> None:
    """A camera calibrated through the configurator's ``calibrate``
    command in-process, on the card, from 12 rendered aprilgrid views put
    in through the camera's ``_cap``; then the detect and the solve timed
    alone, and the solve held to the CPU's on the same features."""
    import contextlib
    import io
    import re

    import torch

    from chalkydri_tpu_torch.geometry.camera import OpenCVModel5
    from chalkydri_tpu_torch.io.camera import CamPipeline
    from chalkydri_tpu_torch.tools import calibration, configurator
    from chalkydri_tpu_torch.tools.scenes import CALIB_LENS, board_views
    from chalkydri_tpu_torch.utils.graph import WARMUP_STEPS

    frames, _, _ = board_views()
    truth = np.array([CALIB_LENS[k] for k in ("fx", "fy", "cx", "cy", "k1",
                                              "k2", "p1", "p2", "k3")])
    out_dir = os.path.join(ROOT, "chalkydri_tpu_torch", "_build", "smoke")
    os.makedirs(out_dir, exist_ok=True)
    state = os.path.join(out_dir, "configurator.json")
    if os.path.exists(state):
        os.remove(state)
    h, w = frames.shape[1:]
    with contextlib.redirect_stdout(io.StringIO()):
        rc = configurator.main(["--state", state, "configure", "--name",
                                "calib", "--device", "absent-calib",
                                "--width", str(w), "--height", str(h)])
    if rc != 0:
        raise AssertionError(f"calibration path: configure exited {rc}")

    feed = BoardFeed(frames)
    start = CamPipeline.start
    CamPipeline.start = lambda self, clock: setattr(self, "_cap", feed)
    log = io.StringIO()
    try:
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            rc = configurator.main(["--state", state, "calibrate",
                                    str(len(frames)), "--name", "calib",
                                    "--timeout", "60"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        CamPipeline.start = start
    launches = {name: fn.launches for name, fn in counters.items()}
    label = "calibration path"
    got = re.search(r"rms=([0-9.]+)px over (\d+) frames", log.getvalue())
    if rc != 0 or got is None or int(got.group(2)) != len(frames):
        raise AssertionError(f"{label}: calibrate exited {rc}, "
                             f"{feed.given} views given:\n{log.getvalue()}")
    # a replay a view, after the first view's eager warm-up steps
    expect = dict.fromkeys(("threshold_ccl_extract", "segment_stats",
                            *TAIL_KERNELS), len(frames) + WARMUP_STEPS)
    if launches != {k: expect.get(k, 0) for k in launches}:
        raise AssertionError(f"{label}: kernel launches {launches} for "
                             f"{len(frames)} views")
    entry = configurator.ConfiguratorState.load(state).entry("calib")
    stored = OpenCVModel5.from_json(entry.calib).params.numpy()
    err = np.abs(stored[:4] - truth[:4]) / truth[:4]
    if not (err <= CALIB_TOL_REL).all():
        raise AssertionError(f"{label}: fx fy cx cy {stored[:4]} against "
                             f"{truth[:4]}: relative {err}")

    # The same views again, timed: the detect a view (CUDA events around
    # Calibrator.process_frame, its one copy to the host included), then
    # the solve on the card and on the CPU from the same features.
    cal = calibration.Calibrator(device=dev)
    cal.process_frame(frames[0])
    cal.features.clear()
    det_ms, dropped = [], 0
    for f in frames:
        start_ev = torch.cuda.Event(enable_timing=True)
        end_ev = torch.cuda.Event(enable_timing=True)
        start_ev.record()
        if not cal.process_frame(f):
            raise AssertionError(f"{label}: a view was rejected when timed")
        end_ev.record()
        end_ev.synchronize()
        det_ms.append(start_ev.elapsed_time(end_ev))
    views = [torch.from_numpy(f)[None].to(dev) for f in frames]
    det_alone = {
        kind: statistics.median(cuda_times_ms(
            lambda fn=fn: [fn(x) for x in views], runs=3)) / len(views)
        for kind, fn in (("replayed", cal._detector),
                         ("eager", cal._detector.module))}
    dropped = int(cal._detector(torch.from_numpy(frames).to(dev))
                  .dropped_points.max())
    if dropped:
        raise AssertionError(f"{label}: {dropped} candidates dropped")
    # the solve's host init alone: Zhang's K, then each view's pose
    t0 = time.perf_counter()
    feats = cal.features
    k0 = calibration._zhang_init(feats)
    kmat = np.array([[k0[0], 0, k0[2]], [0, k0[1], k0[3]], [0, 0, 1]])
    for feat in feats:
        r, _ = calibration._pose_from_homography(
            kmat, calibration._homography(feat.points_3d, feat.points_2d))
        calibration._rvec_from_matrix(r)
    init_ms = (time.perf_counter() - t0) * 1e3
    solve_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = calibration.calibrate_camera(feats, device=dev)
        torch.cuda.synchronize()
        solve_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    res_cpu = calibration.calibrate_camera(feats, device="cpu")
    cpu_ms = (time.perf_counter() - t0) * 1e3
    rel = (np.abs(res.params - res_cpu.params)
           / np.maximum(np.abs(res_cpu.params), 1e-3))
    if not (rel.max() <= CALIB_SOLVE_REL
            and abs(res.rms_px - res_cpu.rms_px)
            <= CALIB_SOLVE_REL * max(res_cpu.rms_px, 1e-3)):
        raise AssertionError(f"{label}: card solve {res.params} "
                             f"(rms {res.rms_px}) against the CPU's "
                             f"{res_cpu.params} (rms {res_cpu.rms_px})")
    if not (res.rms_px < CALIB_RMS_PX and np.array_equal(
            np.abs(res.params[:4] - truth[:4]) / truth[:4] <= CALIB_TOL_REL,
            [True] * 4)):
        raise AssertionError(f"{label}: rms {res.rms_px}, params "
                             f"{res.params}")
    names = ("fx", "fy", "cx", "cy", "k1", "k2", "p1", "p2", "k3")
    print(f"{label}: configurator calibrate on {len(frames)} views of the "
          f"6x6 aprilgrid ({w}x{h}) exited 0 in {wall:.2f} s, "
          f"{got.group(2)} views accepted, rms {res.rms_px:.4f} px, "
          f"launches {launches} (one B1, one B2 a view: a replay each, "
          f"after {WARMUP_STEPS} eager warm-up steps), candidates "
          f"dropped 0; stored calib JSON loads back [{card}]", flush=True)
    print(f"{label}: detect a view (CUDA events, one copy back) median "
          f"{statistics.median(det_ms):.3f} ms (min {min(det_ms):.3f}, max "
          f"{max(det_ms):.3f}); the detector alone a view (CUDA events over "
          f"the 12 views, median of 3) replayed "
          f"{det_alone['replayed']:.3f} ms, eager {det_alone['eager']:.3f} "
          f"ms; calibrate_camera on the card (F = "
          f"{res.n_frames}, Jacobian {2 * 144 * res.n_frames} x "
          f"{9 + 6 * res.n_frames}, 30 iterations, {res.steps_accepted} "
          f"steps accepted) {solve_ms[0]:.1f} / {solve_ms[1]:.1f} / "
          f"{solve_ms[2]:.1f} ms, of which the host init (Zhang, the "
          f"views' poses) takes {init_ms:.1f} ms alone; on the CPU "
          f"{cpu_ms:.1f} ms; "
          f"card equals CPU within {rel.max():.2e} relative [{card}]",
          flush=True)
    print(f"{label}: recovered / truth: " + ", ".join(
        f"{n} {g:.5g} / {t:.5g}" for n, g, t in zip(names, res.params,
                                                    truth))
          + f"; Zhang init fx {k0[0]:.5g}", flush=True)


def logread_phase(card) -> None:
    """``python -m chalkydri_tpu_torch.tools.logread replay`` on the log
    ``main`` wrote: one JSON line per frame record, the first two frames'
    ids equal the CPU detector's."""
    import torch

    from chalkydri_tpu_torch.detector.pipeline import make_detector
    from chalkydri_tpu_torch.runtime import replay_frames

    log = os.path.join(ROOT, "chalkydri_tpu_torch", "_build", "smoke",
                       "main.ctlog")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "chalkydri_tpu_torch.tools.logread",
         "replay", log], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"logread replay exited {r.returncode}:\n"
                             f"{r.stderr[-4000:]}")
    lines = [json.loads(x) for x in r.stdout.splitlines() if x.strip()]
    per_cam = {}
    for rec in lines:
        per_cam[rec["cam"]] = per_cam.get(rec["cam"], 0) + 1
    if per_cam != {0: MAIN_ITERS, 1: MAIN_ITERS}:
        raise AssertionError(f"logread replay: lines per camera {per_cam}")
    detect = make_detector(device="cpu")
    for i, (_, _, frame) in zip(range(2), replay_frames(log)):
        h = (frame.shape[0] + 7) // 8 * 8
        w = (frame.shape[1] + 7) // 8 * 8
        buf = np.full((h, w), 127, np.uint8)
        buf[: frame.shape[0], : frame.shape[1]] = frame
        ids = [int(x) for x in detect(torch.from_numpy(buf)[None]).ids[0]
               if x >= 0]
        if ids != lines[i]["ids"]:
            raise AssertionError(f"logread replay: frame {i} ids "
                                 f"{lines[i]['ids']}, CPU detector {ids}")
    rate = r.stderr.strip().splitlines()[-1]
    print(f"logread replay: python -m chalkydri_tpu_torch.tools.logread "
          f"replay main.ctlog exited 0 in {wall:.1f} s, lines per camera "
          f"{per_cam}, first two frames' ids {lines[0]['ids']} "
          f"{lines[1]['ids']} equal the CPU detector's; {rate} [{card}]",
          flush=True)


def soak_phase(card) -> None:
    """``python -m chalkydri_tpu_torch.tools.soak`` on 2 synthetic
    1280x800 cameras for SOAK_SECONDS: its report's gates and numbers."""
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "chalkydri_tpu_torch.tools.soak", "--seconds",
         str(SOAK_SECONDS), "--cams", "2", "--width", "1280", "--height",
         "800", "--json"], cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"soak exited {r.returncode}:\n"
                             f"{r.stderr[-4000:]}")
    rep = json.loads(r.stdout.strip().splitlines()[-1])
    spans = rep["latency_spans"]
    missing = [k for k in SOAK_SPANS if k not in spans]
    parts = (spans.get("host_capture_ms", 0) + spans.get("h2d_deploy_ms", 0)
             + spans.get("device_step_ms", 0) + spans.get("d2h_fetch_ms", 0)
             + spans.get("host_publish_ms", 0))
    if (rep["iterations"] < 10 or rep["packets_rx"] < 1 or missing
            or abs(spans["projection_p50_ms"] - parts) >= 0.01
            or spans["h2d_bytes"] != 2 * 800 * 1280):
        raise AssertionError(f"soak: report {json.dumps(rep)}")
    print(f"soak: python -m chalkydri_tpu_torch.tools.soak --seconds "
          f"{SOAK_SECONDS} --cams 2 --width 1280 --height 800 exited 0 in "
          f"{wall:.1f} s: {rep['iterations']} iterations, sustained_hz "
          f"{rep['sustained_hz']}, iteration ms p50/p99 {rep['iter_ms_p50']}"
          f"/{rep['iter_ms_p99']}, capture_to_udp_ms p50/p99 "
          f"{rep['capture_to_udp_ms_p50']}/{rep['capture_to_udp_ms_p99']}, "
          f"packets {rep['packets_rx']}, rss drift {rep['rss_drift_mb']} MB, "
          f"device memory drift {rep['device_mb_drift']} MB [{card}]",
          flush=True)
    print("soak latency spans: " + ", ".join(
        f"{k} {v}" for k, v in spans.items()) + f" [{card}]", flush=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    if torch.cuda.device_count() != 1:
        raise SystemExit("chip_smoke: needs exactly one visible card, found "
                         f"{torch.cuda.device_count()}")
    card = card_line()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")

    from chalkydri_tpu_torch.detector.cluster import (
        MAX_EDGE_POINTS,
        compact_candidates,
        sort_candidates,
    )
    from chalkydri_tpu_torch.detector.pipeline import decimate2, make_detector
    from chalkydri_tpu_torch.ops import build
    from chalkydri_tpu_torch.ops.ccl_extract import (
        threshold_ccl_extract,
        threshold_ccl_extract_plain,
    )
    from chalkydri_tpu_torch.ops.propagate import (
        label_components_blocked,
        propagate_components_blocked,
    )
    from chalkydri_tpu_torch.ops.segment_stats import (
        segment_stats,
        segment_stats_plain,
    )
    from chalkydri_tpu_torch.ops.threshold_ccl import (
        label_components_ccl,
        threshold_ccl,
        threshold_ccl_exact,
        threshold_ccl_exact_plain,
        threshold_ccl_plain,
    )
    from chalkydri_tpu_torch.detector.segment import (
        label_components,
        rounds_needed,
    )
    from chalkydri_tpu_torch.detector.threshold import adaptive_threshold
    from chalkydri_tpu_torch.parallel.mesh import make_mesh
    from chalkydri_tpu_torch.parallel.pipeline import (
        make_sharded_vision_pipeline,
    )
    from chalkydri_tpu_torch import bench as twin
    from chalkydri_tpu_torch.pipeline import make_vision_pipeline
    from chalkydri_tpu_torch.tools.scenes import TAGS, load_scene
    from chalkydri_tpu_torch.utils import graph

    t0 = time.perf_counter()
    build.kernel_library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{os.path.relpath(build.library_path(), ROOT)}", flush=True)

    layout, params, rc, frames, poses = load_scene("bench", dev)
    _, dep_params, dep_rc, dep_frames, dep_poses = load_scene("deployed", dev)
    _, sp_params, sp_rc, sp_frames, sp_poses = load_scene("spatial", dev)
    for label, f, p in (("scene", frames, poses),
                        ("deployed scene", dep_frames, dep_poses),
                        ("spatial scene", sp_frames, sp_poses)):
        print(f"{label}: {f.shape[0]} x {f.shape[1]}x{f.shape[2]} u8, tags "
              f"{list(TAGS)}, robot poses (x, y, yaw) {list(p)}", flush=True)

    # -- kernel phases: each kernel against its plain twin, same tensors --
    small = decimate2(frames)
    got = threshold_ccl_extract(small, iters=12)
    want = threshold_ccl_extract_plain(small, iters=12)
    require_equal("B1", ("black", "white", "payload"), got, want)
    b1_err = max_abs_err(got, want)
    b1_ms, b1_plain_ms, b1_dev_ms, b1_dev_launches = time_kernel(
        "B1 threshold_ccl_extract", small.shape, card,
        lambda: threshold_ccl_extract(small, iters=12),
        lambda: threshold_ccl_extract_plain(small, iters=12),
        threshold_ccl_extract, 1)
    b1_px = small.numel()
    b1_rounds = int(rounds_needed(adaptive_threshold(small), 12).max())

    black, white, payload, _ = compact_candidates(
        *got, width=small.shape[2], max_points=MAX_EDGE_POINTS)
    s_key, s_payload = sort_candidates(black, white, payload, MAX_EDGE_POINTS)
    got2 = segment_stats(s_key, s_payload)
    want2 = segment_stats_plain(s_key, s_payload)
    require_equal("B2", ("t", "cand_len", "cand_pos"), got2, want2)
    b2_err = max_abs_err(got2, want2)
    b2_ms, b2_plain_ms, b2_dev_ms, b2_dev_launches = time_kernel(
        "B2 segment_stats", s_key.shape, card,
        lambda: segment_stats(s_key, s_payload),
        lambda: segment_stats_plain(s_key, s_payload), segment_stats, 1)
    b2_n = s_key.numel()

    routes(dev, card, decimate2(dep_frames), frames[:1])
    edge_cases(dev, tuple(small.shape))
    print("edge cases: B1 and B2 bit-identical to their twins where the CCL "
          "round cap binds, on noise, on adversarial run layouts, at "
          "n = 256 and 200 rows, and at [4, 65536], 65152 and 5000 rows with "
          "a run over three 1024-row tiles", flush=True)

    # B3 and B4 at the qd=1 bench shape, and where the round cap binds.
    got3 = threshold_ccl(frames, iters=12)
    want3 = threshold_ccl_plain(frames, iters=12)
    require_equal("B3", ("tern", "labels"), got3, want3)
    b3_err = max_abs_err(got3, want3)
    tern3 = got3[0]
    got4 = label_components_ccl(tern3, iters=12)
    want4 = label_components(tern3, iters=12)
    require_equal("B4", ("labels",), (got4,), (want4,))
    b4_err = max_abs_err((got4,), (want4,))
    serp = torch.from_numpy(serpentine()[None]).to(dev)
    require_equal("B3 serpentine", ("tern", "labels"),
                  threshold_ccl(serp, iters=12),
                  threshold_ccl_plain(serp, iters=12))
    require_equal("B4 serpentine", ("labels",),
                  (label_components_ccl(serp, iters=12),),
                  (label_components(serp, iters=12),))
    b3_ms, b3_plain_ms = time_pair(
        "B3 threshold_ccl", frames.shape, card,
        lambda: threshold_ccl(frames, iters=12),
        lambda: threshold_ccl_plain(frames, iters=12))
    b4_ms, b4_plain_ms = time_pair(
        "B4 label_components_ccl", tern3.shape, card,
        lambda: label_components_ccl(tern3, iters=12),
        lambda: label_components(tern3, iters=12))
    b3_px = frames.numel()
    b3_rounds = int(rounds_needed(tern3, 12).max())
    print(f"B3/B4 serpentine: bit-identical where the 12-round cap binds; "
          f"bench scene needs {b3_rounds} of 12 rounds (B1's decimated "
          f"frames {b1_rounds})", flush=True)
    ccl_round_checks(dev, card, tern3[0])

    # B5 at the deployed shape, on serpentines and off its shapes.
    got5 = threshold_ccl_exact(dep_frames)
    want5 = threshold_ccl_exact_plain(dep_frames)
    require_equal("B5", ("tern", "labels"), got5, want5)
    b5_err = max_abs_err(got5, want5)
    b5_ms, b5_plain_ms, b5_dev_ms, b5_dev_launches = time_kernel(
        "B5 threshold_ccl_exact", dep_frames.shape, card,
        lambda: threshold_ccl_exact(dep_frames),
        lambda: threshold_ccl_exact_plain(dep_frames), threshold_ccl_exact, 3)
    b5_px = dep_frames.numel()
    b5_edge_cases(dev, serp, dep_frames.shape)

    # X1-X3 after B5 and B3, and off their shapes.
    x_report = front_phase(dev, card, got5, got3)

    # B6 and B7 at the spatial path's band shapes, and off them.
    band = band_phases(dev, card, sp_frames)
    band_edge_cases(dev)

    # The solve stage's kernel against the plain chain.
    solve = solve_phase(dev, card)

    # The tail's three kernels against the plain chain.
    tail_report = tail_phase(dev, card)

    # -- the paths through the entry points, kernels counted --------------
    counters = kernel_counters()
    step = make_vision_pipeline(layout, params, rc, device=dev)
    threshold_ccl_extract.chain_launches = 0
    qd2 = drive_path("qd2 main path", step, frames, poses, counters,
                     ("threshold_ccl_extract", "segment_stats",
                      "solve_frames", *TAIL_KERNELS), card,
                     TIMED_STEPS["qd2"])
    if threshold_ccl_extract.chain_launches:
        raise AssertionError("qd2 main path: B1 took the chain route")
    step_qd1 = make_vision_pipeline(layout, params, rc, device=dev,
                                    detector_kwargs={"quad_decimate": 1})
    step_dep = make_vision_pipeline(layout, dep_params, dep_rc, device=dev,
                                    detector_kwargs={"quad_decimate": 1})
    qd1 = drive_path("qd1 bench path", step_qd1, frames, poses, counters,
                     ("threshold_ccl", "label_components_ccl",
                      "extract_compact", "segment_stats", "solve_frames",
                      *TAIL_KERNELS), card, TIMED_STEPS["qd1"])
    dep = drive_path("qd1 deployed path", step_dep, dep_frames, dep_poses,
                     counters, ("threshold_ccl_exact", "extract_compact",
                                "segment_stats", "solve_frames",
                                *TAIL_KERNELS), card, TIMED_STEPS["qd1"])
    x_launches = (qd1["extract_compact"], dep["extract_compact"])
    if x_launches != (STEPS, STEPS):
        raise AssertionError(f"qd1 paths: X1-X3 launched {x_launches} times "
                             f"in {STEPS} replays each")
    for label, qd1_step, f, x in (
            ("qd1 deployed", step_dep, dep_frames, x_report),
            ("qd1 bench", step_qd1, frames, x_report["bench"])):
        gyro = torch.zeros(f.shape[0], device=dev)  # not a node of its own
        with torch.no_grad():
            nodes = graph_nodes(lambda: qd1_step.module(f, gyro))
        print(f"{label} step graph nodes: {nodes} with X1-X3; "
              f"{nodes - x['nodes'] + x['plain_nodes']} with the plain "
              f"extraction and compaction in their place (X1-X3 "
              f"capture {x['nodes']} nodes a call, the plain chain "
              f"{x['plain_nodes']}); X1-X3 once a step", flush=True)

    # The row-banded step: four bands of the one card, kernel CCL, one
    # CUDA graph replay a step.
    mesh = make_mesh([dev] * BANDS, space=BANDS)
    spatial, sp_steps = {}, {}
    seam_rounds = 2 * BANDS + 2  # the band CCL's default outer_rounds
    per_replay = {"label_components_blocked": BANDS,
                  "propagate_components_blocked": seam_rounds * BANDS,
                  "extract_candidates_band": BANDS, "segment_stats": 1,
                  "solve_frames": 1, **dict.fromkeys(TAIL_KERNELS, 1)}
    sp_gyro = torch.tensor([p[2] for p in sp_poses], dtype=torch.float32,
                           device=dev)
    probe = torch.ones(1, device=dev)
    if not reads_host(lambda: bool(probe.any())):
        raise AssertionError("reads_host does not see a host read")
    label_components_blocked.global_launches = 0
    propagate_components_blocked.global_launches = 0
    for qd in (2, 1):
        dk = {"quad_decimate": qd, "ccl_impl": "pallas"}
        sp_step, sp_place = make_sharded_vision_pipeline(
            layout, sp_params, sp_rc, mesh, spatial=True, detector_kwargs=dk)
        if not isinstance(sp_step.pipes[0], graph.CapturedStep):
            raise AssertionError("the row-banded step on one card is not "
                                 "a captured step")
        banded = sp_steps[qd] = sharded(sp_step, sp_place, dev)
        single = make_vision_pipeline(layout, sp_params, sp_rc, device=dev,
                                      detector_kwargs={"quad_decimate": qd})
        label = f"spatial deployed qd{qd} path"
        spatial[qd] = drive_path(
            label, banded, sp_frames, sp_poses,
            counters, ("label_components_blocked",
                       "propagate_components_blocked",
                       "extract_candidates_band", "segment_stats",
                       "solve_frames", *TAIL_KERNELS), card,
            TIMED_STEPS["spatial"], against=single,
            ties_may_reorder=(qd == 2))
        if spatial[qd] != {k: STEPS * per_replay.get(k, 0) for k in counters}:
            raise AssertionError(f"{label}: launches {spatial[qd]} in {STEPS}"
                                 f" replays, {per_replay} a replay expected")
        if (label_components_blocked.global_launches
                or propagate_components_blocked.global_launches):
            raise AssertionError(f"{label}: B6 took the global-memory route")
        reads = (reads_host(lambda: banded.module(sp_frames, sp_gyro)),
                 reads_host(lambda: banded(sp_frames, sp_gyro)))
        rounds = sp_step.ccl_rounds().tolist()
        if any(reads) or not all(1 <= r <= seam_rounds for r in rounds):
            raise AssertionError(f"{label}: host reads (eager, replayed) "
                                 f"{reads}, rounds {rounds}")
        print(f"{label}: 0 host reads a step, eager and replayed (each "
              f"step ran under torch.cuda.set_sync_debug_mode('error'), "
              f"which raises on bool(x.any())); seam rounds each frame ran "
              f"{rounds} of {seam_rounds}; a replay launches {per_replay}",
              flush=True)

    # -- the captured step against its eager module ------------------------
    t_graph = time.perf_counter()
    gyro0 = torch.tensor([p[2] for p in poses], dtype=torch.float32,
                         device=dev)
    dep_gyro = torch.tensor([p[2] for p in dep_poses], dtype=torch.float32,
                            device=dev)
    twin_step = twin.make_step(dev)
    twin_frames = torch.from_numpy(np.broadcast_to(
        twin.build_scene(), (twin.BATCH, twin.H, twin.W)).copy()).to(dev)
    grid = sharded(*make_sharded_vision_pipeline(
        layout, params, rc, make_mesh([dev] * 2), spatial=False), dev)
    for label, s, e, f, g, wrappers in (
            ("qd2 main path", step, step.module, frames, gyro0, [step]),
            ("qd1 bench path", step_qd1, step_qd1.module, frames, gyro0,
             [step_qd1]),
            ("qd1 deployed path", step_dep, step_dep.module, dep_frames,
             dep_gyro, [step_dep]),
            ("bench twin's scene", twin_step, twin_step.module, twin_frames,
             torch.zeros(twin.BATCH, device=dev), [twin_step]),
            ("data-parallel grid, 2 groups on one card", grid, grid.module,
             frames, gyro0, grid.pipes),
            *((f"spatial deployed qd{qd} path, {BANDS} bands on one card",
               sp_steps[qd], sp_steps[qd].module, sp_frames, sp_gyro,
               sp_steps[qd].pipes) for qd in (2, 1))):
        graph_path(label, s, e, f, g, wrappers, counters, card)
    stats = torch.cuda.memory_stats(dev)
    print(f"graph pool: {graph.pool_bytes(dev)} bytes in the card's shared "
          f"pool after every capture so far (torch.cuda.memory_snapshot); "
          f"reserved {stats['reserved_bytes.all.current']} bytes, peak "
          f"allocated {stats['allocated_bytes.all.peak']} bytes "
          f"(torch.cuda.memory_stats) [{card}]", flush=True)
    print(f"graph phase: {time.perf_counter() - t_graph:.1f} s", flush=True)

    # -- options -----------------------------------------------------------
    chroma = torch.randint(0, 256, frames.shape, dtype=torch.uint8,
                           device=dev,
                           generator=torch.Generator(dev).manual_seed(3))
    b, h, w = frames.shape
    yuyv = torch.stack([frames, chroma], dim=-1).reshape(b, h, 2 * w)
    step_yuyv = make_vision_pipeline(layout, params, rc, device=dev,
                                     input_format="YUYV")
    compare_outputs("YUYV step vs GREY step", step(frames, gyro0),
                    step_yuyv(yuyv, gyro0))
    rng = np.random.default_rng(11)
    flood = np.clip(frames[:1].cpu().numpy()
                    + rng.normal(0, 6, (1, h, w)), 0, 255).astype(np.uint8)
    det = make_detector(max_edge_points=4096, capacity_fallback=True,
                        device=dev)
    flood = torch.from_numpy(flood).to(dev)
    first = det.detect(flood)
    out = det(flood)
    torch.cuda.synchronize()
    if not (int(first.dropped_points.max()) > 0 and det.wide is not None
            and det.wide.edge_cap == 8192
            and torch.isfinite(out.corners).all()):
        raise AssertionError("capacity_fallback did not run its second "
                             "program on the flooded frame")
    if not (det._captured_detect.replays == det.wide._captured_detect.replays
            == 1 and all(torch.equal(x, y) for x, y in
                         zip(out, det.wide.detect(flood)))):
        raise AssertionError("capacity_fallback: the second program's replay "
                             "is not its eager output")
    print(f"options: YUYV step gives the GREY step's ids and poses; "
          f"flooded frame dropped {int(first.dropped_points.max())} of "
          f"4,096 -> second program (8,192) dropped "
          f"{int(out.dropped_points.max())}, ids "
          f"{out.ids[0][out.valid[0]].tolist()}; each program replayed "
          f"from a graph of its own, the second equal to its eager output "
          f"bit for bit", flush=True)

    # -- bench.py's twin -----------------------------------------------------
    t_bench = time.perf_counter()
    bench_phase(dev, card, counters)
    print(f"bench phase: {time.perf_counter() - t_bench:.1f} s", flush=True)

    # -- the runtime App and main ------------------------------------------
    t_app = time.perf_counter()
    app_phase(dev, card, counters)
    main_phase(card)
    print(f"app and main phases: {time.perf_counter() - t_app:.1f} s",
          flush=True)

    # -- calibration, logread replay, soak ----------------------------------
    t_tools = time.perf_counter()
    calibration_phase(dev, card, counters)
    for fn in counters.values():
        fn.launches = 0
    logread_phase(card)
    for fn in counters.values():
        fn.launches = 0
    soak_phase(card)
    print(f"calibration, logread and soak phases: "
          f"{time.perf_counter() - t_tools:.1f} s", flush=True)

    pages = 3 * 4 * 2  # three int32 candidate pages per direction pair
    report = [
        dict(kernel_entry("threshold_ccl_extract", "ccl_extract.cu",
                          "ccl_kernel.py:572",
                          qd2["threshold_ccl_extract"], b1_err, b1_ms,
                          b1_plain_ms, b1_px * (1 + pages),
                          b1_px * (THRESH_OPS + b1_rounds * ROUND_OPS
                                   + EXTRACT_OPS)),
             device_ms=b1_dev_ms, launches_per_call=b1_dev_launches),
        dict(kernel_entry("segment_stats", "segment_stats.cu",
                          "segment_kernel.py:182",
                          qd2["segment_stats"], b2_err, b2_ms, b2_plain_ms,
                          b2_n * 12 + 2 * (2 * b2_n // 128) * 4,
                          b2_n * SEGMENT_OPS),
             device_ms=b2_dev_ms, launches_per_call=b2_dev_launches),
        kernel_entry("threshold_ccl", "threshold_ccl.cu", "ccl_kernel.py:770",
                     qd1["threshold_ccl"], b3_err, b3_ms, b3_plain_ms,
                     b3_px * (1 + 1 + 4),
                     b3_px * (THRESH_OPS + b3_rounds * ROUND_OPS)),
        kernel_entry("label_components_ccl", "threshold_ccl.cu",
                     "ccl_kernel.py:745",
                     qd1["label_components_ccl"], b4_err, b4_ms, b4_plain_ms,
                     b3_px * (1 + 4), b3_px * b3_rounds * ROUND_OPS),
        dict(kernel_entry("threshold_ccl_exact", "threshold_ccl.cu",
                          "ccl_kernel.py:1544",
                          dep["threshold_ccl_exact"], b5_err, b5_ms,
                          b5_plain_ms, b5_px * (1 + 1 + 4),
                          b5_px * (THRESH_OPS + UNION_FIND_OPS)),
             device_ms=b5_dev_ms, launches_per_call=b5_dev_launches),
        dict(kernel_entry("extract_compact", "front.cu", None,
                          dep["extract_compact"], 0.0, x_report["ms"],
                          x_report["plain_ms"], x_report["bytes"],
                          x_report["ops"]),
             replaces=None, device_ms=x_report["device_ms"],
             launches_per_call=x_report["launches_per_call"],
             graph_ms=x_report["graph_ms"],
             plain_device_ms=x_report["plain_graph_ms"]),
        *(dict(kernel_entry(name, source, replaces, spatial[1][name],
                            *band[name][:5]),
               device_ms=band[name][5], launches_per_call=band[name][6],
               **({"inactive_ms": band["propagate inactive"][0],
                   "inactive_device_ms": band["propagate inactive"][2]}
                  if name == "propagate_components_blocked" else {}))
          for name, source, replaces in (
              ("label_components_blocked", "propagate.cu",
               "ccl_kernel.py:1244"),
              ("propagate_components_blocked", "propagate.cu",
               "ccl_kernel.py:1244"),
              ("extract_candidates_band", "extract_blocked.cu",
               "ccl_kernel.py:698"))),
        dict(kernel_entry("solve_frames", "solve.cu", None,
                          qd2["solve_frames"], solve["max_abs_err"],
                          solve["ms"], solve["plain_ms"], solve["bytes"],
                          solve["ops"]),
             replaces=None, device_ms=solve["device_ms"],
             counted_launches_per_call=solve["counted_launches_per_call"]),
        *(dict(kernel_entry(name, "tail.cu", None, qd2[name], 0.0,
                            tail_report[name]["ms"],
                            tail_report[name]["plain_ms"],
                            tail_report[name]["bytes"],
                            tail_report[name]["ops"]),
               replaces=None, device_ms=tail_report[name]["device_ms"],
               plain_device_ms=tail_report[name]["plain_device_ms"],
               counted_launches_per_call=tail_report[name][
                   "counted_launches_per_call"])
          for name in TAIL_KERNELS),
    ]
    print(json.dumps({"kernels": report}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))  # 1, checked above


if __name__ == "__main__":
    main()
