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
   of four bands; and off those shapes
   (bands of 1-3 rows and of odd height, CTAs of B6's cluster left
   without rows, widths that are no multiple of 4 or 16, snakes through
   every CTA, the last band of the cluster route and one row over it,
   which takes B6's global-memory route; B7 with halos of 0-2 rows, an
   input off 16-byte alignment, ``y_offset`` at the 13-bit limit);
5. drives four paths through the entry points (``build_rig_from_config``
   -> ``make_vision_pipeline`` / ``make_sharded_vision_pipeline``), each
   with the launch counts set to 0 just before it and read just after:
   ``quad_decimate=2`` at 4 x 1280x800 (B1, B2), ``quad_decimate=1`` at
   4 x 1280x800 (B3, B4, B2), ``quad_decimate=1`` at 2 x 1600x1304 (B5,
   B2), and the row-banded step (``spatial=True``) at 2 x 1600x1312 over a
   grid of four bands on the one card, at ``quad_decimate=2`` and ``1``
   (B6 on its cluster route only, B7, B2). Each checks the ids and each
   frame's pose against its own truth and that every kernel of the path
   launched, compares the step with the same step run on the plain twins
   only, and times both; the
   row-banded step is also held against the single-card step on the same
   frames;
6. checks the options: the bench scene as YUYV gives the GREY step's ids
   and poses, and a flooded frame with a small ``max_edge_points`` drives
   ``capacity_fallback`` to its second program;
7. runs ``bench.py``'s twin (``chalkydri_tpu_torch/bench.py``) on
   ``bench.py``'s scene and rig (4 x 1280x800, tags 1/5/9/13, stored in
   ``tools/bench_scene.npz`` with the JAX package's outputs): its CPU
   denominator, then ``bench_gpu`` at ``BENCH_ITERS`` x ``BENCH_REPS``
   with the launch counts set to 0 just before (exactly one B1 and one B2
   a step, no other kernel), the card's output held to the stored JAX
   outputs; prints the twin's JSON line;
8. drives the runtime App (``runtime.app.App``) at the deployed rig: two
   1600x1304 cameras on mounts 0.3 m apart seeing tags 28-31 from one
   robot pose, frames put in through each chain's ``camera._cap``, the
   gyro sent to the App's whacknet ``Comm`` as the roboRIO's 8-byte
   double, packets read from a loopback socket; at ``pipeline_depth`` 1
   and 0 every packet must carry 4 tags and a position within 0.02 m,
   every frame a pose packet, every poll without a frame a heartbeat, and
   every dispatched step exactly one B1 and one B2 launch (counts set to
   0 just before); the App's outputs equal a direct step's; it prints
   the App's rate, the host p50/p90 of its spans, the packets' latency
   field and the upload time of one staged batch; then
   ``capacity_fallback`` in the App (the 2x-budget step warmed up in a
   thread while the loop runs); and runs ``python -m
   chalkydri_tpu_torch.main`` on ``examples/chalkydri.ron`` (synthetic
   cameras, packets to loopback), which must exit 0 and log frames of
   both cameras;
9. calibrates a camera on the card through the configurator
   (``tools/configurator.py calibrate``, in-process): 12 views of the 6x6
   aprilgrid rendered at 1280x800 through a lens with distortion
   (``tools/scenes.py::board_views``), put in through the camera's
   ``_cap``; every view must be accepted, the views must launch exactly
   12 B1 and 12 B2 and no other kernel (counts set to 0 just before),
   the recovered fx, fy, cx, cy must lie within ``CALIB_TOL_REL`` of the
   truth, the RMS under ``CALIB_RMS_PX``, the stored calib JSON must
   load back, and the card's solve must equal the CPU's on the same
   features within ``CALIB_SOLVE_REL``; it prints the detect time a view
   (CUDA events), the solve's time and accepted steps and the parameters
   beside the truth;
10. runs ``python -m chalkydri_tpu_torch.tools.logread replay`` on the
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
APP_WARMUP, APP_ITERS = 3, 30  # App iterations per pipeline depth
# The App's rig: the deployed lens on two mounts 0.3 m apart, one robot pose.
APP_MOUNT_Y = (0.15, -0.15)  # m
APP_POSE = (12.9, 3.99, 0.015)  # x m, y m, yaw rad (the gyro the robot sends)
APP_GAP_EVERY = 7  # camera 1 has no fresh frame every 7th poll
MAIN_ITERS = 20  # iterations of the ``main`` subprocess
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


class plain_twins:
    """Within this context the detector calls the kernels' plain twins on
    CUDA tensors (the module attributes its functions look up per call)."""

    def __enter__(self):
        import chalkydri_tpu_torch.detector.cluster as cluster
        import chalkydri_tpu_torch.detector.pipeline as det
        import chalkydri_tpu_torch.parallel.pipeline as par
        import chalkydri_tpu_torch.parallel.sharded_stages as stages
        from chalkydri_tpu_torch.ops.ccl_extract import threshold_ccl_extract_plain
        from chalkydri_tpu_torch.ops.extract_blocked import (
            extract_candidates_band_plain,
        )
        from chalkydri_tpu_torch.ops.propagate import (
            label_components_blocked_plain,
            propagate_components_blocked_plain,
        )
        from chalkydri_tpu_torch.ops.segment_stats import segment_stats_plain
        from chalkydri_tpu_torch.ops.threshold_ccl import (
            threshold_ccl_exact_plain,
            threshold_ccl_plain,
        )

        self._saved = [(det, "threshold_ccl_extract", det.threshold_ccl_extract),
                       (det, "threshold_ccl", det.threshold_ccl),
                       (det, "threshold_ccl_exact", det.threshold_ccl_exact),
                       (cluster, "segment_stats", cluster.segment_stats),
                       (stages, "label_components_blocked",
                        stages.label_components_blocked),
                       (stages, "propagate_components_blocked",
                        stages.propagate_components_blocked),
                       (par, "extract_candidates_band",
                        par.extract_candidates_band)]
        det.threshold_ccl_extract = threshold_ccl_extract_plain
        det.threshold_ccl = threshold_ccl_plain
        det.threshold_ccl_exact = threshold_ccl_exact_plain
        cluster.segment_stats = segment_stats_plain
        stages.label_components_blocked = label_components_blocked_plain
        stages.propagate_components_blocked = propagate_components_blocked_plain
        par.extract_candidates_band = extract_candidates_band_plain
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        return False


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


def band_phases(dev, card, frames_sp):
    """B6 and B7 against their plain twins on the spatial scene's row bands
    (full resolution and decimated), on a whole frame, and on a snake that
    crosses every seam of four bands. Times them at the full-resolution
    band shape, with their device time and device launches a call.
    Returns {kernel: (err, ms, plain_ms, bytes, ops, device_ms,
    device launches a call)}."""
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

    # a snake through every seam of four 16-row bands
    serp = torch.from_numpy(serpentine(stripes=6)).to(dev)[None]
    serp_bands = place_frames(mesh, serp, spatial=True)[0]
    got = gather_frames([label_components_block_kernel(
        serp_bands, outer_rounds=100)])
    with plain_twins():
        want = gather_frames([label_components_block_kernel(
            serp_bands, outer_rounds=100)])
    require_equal("B6 serpentine over bands", ("labels",), (got,), (want,))
    if len(torch.unique(got[serp == 255])) != 1:
        raise AssertionError("B6 serpentine: the snake has more than 1 label")
    print("B6 serpentine: the snake crosses every seam of 4 bands, labels "
          "bit-identical to the twins' loop, the whole snake one label",
          flush=True)
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


def compare_outputs(label, ref, other) -> None:
    """Integer outputs equal, floats within the CPU parity tolerances."""
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


def drive_path(label, step, frames, true_xy_yaw, counters, expect, card,
               timed_steps, against=None, ties_may_reorder=False):
    """The path through ``step``: launch counts from 0 over STEPS checked
    steps, every expected kernel launched (and no other), ids and poses,
    the twin-only step compared (and the step ``against``, where given:
    slot for slot, or with ``ties_may_reorder`` after moving slots of
    equal decision margin only), then timed in turns (twins, kernels,
    kernels, twins). Returns the launch counts."""
    import torch

    true_x, true_y, true_yaw = (torch.tensor(v, dtype=torch.float32,
                                             device=frames.device)
                                for v in zip(*true_xy_yaw))
    gyros = [true_yaw + d for d in GYRO_OFFSETS]
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
    pose_err = check_path(label, outs, true_x, true_y)
    print(f"{label} poses: 4 ids in each of {frames.shape[0]} frames, each "
          f"frame's pose against its own truth: max position error "
          f"{pose_err:.5f} m, yaw {outs[0].pose_yaw.tolist()}", flush=True)

    with plain_twins():
        plain_out = step(frames, gyros[0])
    compare_outputs(f"{label} vs plain twins", outs[0], plain_out)
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
                with plain_twins():
                    step(frames, gyros[i % STEPS])
            else:
                step(frames, gyros[i % STEPS])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        return times[1:]

    plain_a, kern_a = step_times(True), step_times(False)
    kern_b, plain_b = step_times(False), step_times(True)
    b, h, w = frames.shape[:3]
    for kind, times in (("kernels", kern_a + kern_b),
                        ("plain twins", plain_a + plain_b)):
        med = statistics.median(times)
        p75 = statistics.quantiles(times, n=4)[2]
        print(f"{label} step {b}x{h}x{w} {kind}: median {med:.3f} ms "
              f"({b / med * 1e3:.1f} frames/s), p75 {p75:.3f} ms, "
              f"{len(times)} host-clock steps [{card}]", flush=True)
    return launches


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
    want = make_vision_pipeline(layout, params, rc, device=dev)(
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
            expect = {"threshold_ccl_extract": APP_ITERS,
                      "segment_stats": APP_ITERS}
            if launches != {k: expect.get(k, 0) for k in launches}:
                raise AssertionError(f"{label}: kernel launches {launches} "
                                     f"for {APP_ITERS} dispatched steps")
            for i, out in enumerate(o for o in outs if o is not None):
                compare_outputs(f"{label} iteration {i} vs a direct step",
                                want, out)
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
            lat = sorted(p[2] for p in packets if p[4])
            spans = SPANS.summary()
            print(f"{label}: {APP_ITERS} iterations, {APP_ITERS / wall:.2f} "
                  f"iterations/s, launches {launches} (one B1, one B2 a "
                  f"step); {len(packets)} packets: "
                  f"{sum(1 for p in packets if p[4])} poses, all 4 tags, "
                  f"max position error {err:.5f} m, "
                  f"{sum(1 for p in packets if not p[4])} heartbeats for "
                  f"{feeds[1].gaps - gaps[1]} polls without a frame; "
                  f"{n_out} outputs equal to a direct step's", flush=True)
            print(f"{label} host ms p50/p90: " + ", ".join(
                f"{k} {spans[k]['p50_ms']:.3f}/{spans[k]['p90_ms']:.3f}"
                for k in ("app.capture", "app.dispatch", "app.fetch_publish"))
                + f"; packet latency field us p50 "
                f"{statistics.median(lat):.0f}, p99 "
                f"{lat[min(len(lat) - 1, len(lat) * 99 // 100)]}; comm path "
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
            detector_kwargs={"max_edge_points": 8192})(
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
            compare_outputs(f"{label} iteration {i} vs the 2x-budget step",
                            want_big, out)
        print(f"{label}: warm-up thread ready, {redispatched} overflowing "
              f"batches re-run on the 8,192-point step (points dropped "
              f"after: {app.dropped_points_total}), outputs equal to a "
              f"direct 8,192-point step's, tag counts "
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
             "--iters", str(MAIN_ITERS), "--log", log, "--config", config,
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
          f"examples/chalkydri.ron --iters {MAIN_ITERS} exited 0 in "
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

    ref = twin.load_reference()
    frames = np.broadcast_to(ref["frame"], (twin.BATCH, twin.H, twin.W)).copy()
    cpu_fps, cpu_samples, cpu_out, cpu_ref = twin.bench_cpu_reference(frames)
    twin.check_outputs(cpu_out, ref, "bench path, cpu step")
    for fn in counters.values():
        fn.launches = 0
    counters["threshold_ccl_extract"].chain_launches = 0
    res = twin.bench_gpu(frames, BENCH_ITERS, BENCH_REPS, device=dev)
    launches = {name: fn.launches for name, fn in counters.items()}
    steps = 1 + BENCH_ITERS * BENCH_REPS
    want = {name: steps if name in ("threshold_ccl_extract", "segment_stats")
            else 0 for name in counters}
    if launches != want or counters["threshold_ccl_extract"].chain_launches:
        raise AssertionError(f"bench path: kernel launches {launches} over "
                             f"{steps} steps, expected {want} on B1's cluster "
                             f"route")
    twin.check_outputs(res.out, ref, "bench path, card step")
    print(f"bench path (bench.py's scene, {twin.BATCH} x {twin.W}x{twin.H}, "
          f"tags 1/5/9/13): {steps} steps, kernel launches {launches}; ids "
          f"{res.out.detections.ids[0][res.out.detections.valid[0]].tolist()}"
          f", pose ({float(res.out.pose_x[0]):.6f}, "
          f"{float(res.out.pose_y[0]):.6f}), card and CPU outputs equal to "
          f"the stored JAX outputs within {CORNER_TOL}; step ms per round "
          f"{[round(t, 3) for t in res.step_ms]} [{card}]", flush=True)
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
    expect = {"threshold_ccl_extract": len(frames),
              "segment_stats": len(frames)}
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
          f"launches {launches} (one B1, one B2 a view), candidates "
          f"dropped 0; stored calib JSON loads back [{card}]", flush=True)
    print(f"{label}: detect a view (CUDA events, one copy back) median "
          f"{statistics.median(det_ms):.3f} ms (min {min(det_ms):.3f}, max "
          f"{max(det_ms):.3f}); calibrate_camera on the card (F = "
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
    from chalkydri_tpu_torch.ops.extract_blocked import extract_candidates_band
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
    from chalkydri_tpu_torch.parallel.sharded_stages import (
        label_components_block_kernel,
    )
    from chalkydri_tpu_torch.pipeline import make_vision_pipeline
    from chalkydri_tpu_torch.tools.scenes import TAGS, load_scene

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

    # B6 and B7 at the spatial path's band shapes, and off them.
    band = band_phases(dev, card, sp_frames)
    band_edge_cases(dev)

    # -- the paths through the entry points, kernels counted --------------
    counters = {"threshold_ccl_extract": threshold_ccl_extract,
                "segment_stats": segment_stats,
                "threshold_ccl": threshold_ccl,
                "label_components_ccl": label_components_ccl,
                "threshold_ccl_exact": threshold_ccl_exact,
                "label_components_blocked": label_components_blocked,
                "propagate_components_blocked": propagate_components_blocked,
                "extract_candidates_band": extract_candidates_band}
    step = make_vision_pipeline(layout, params, rc, device=dev)
    threshold_ccl_extract.chain_launches = 0
    qd2 = drive_path("qd2 main path", step, frames, poses, counters,
                     ("threshold_ccl_extract", "segment_stats"), card,
                     TIMED_STEPS["qd2"])
    if threshold_ccl_extract.chain_launches:
        raise AssertionError("qd2 main path: B1 took the chain route")
    step_qd1 = make_vision_pipeline(layout, params, rc, device=dev,
                                    detector_kwargs={"quad_decimate": 1})
    qd1 = drive_path("qd1 bench path", step_qd1, frames, poses, counters,
                     ("threshold_ccl", "label_components_ccl",
                      "segment_stats"), card, TIMED_STEPS["qd1"])
    step_dep = make_vision_pipeline(layout, dep_params, dep_rc, device=dev,
                                    detector_kwargs={"quad_decimate": 1})
    dep = drive_path("qd1 deployed path", step_dep, dep_frames, dep_poses,
                     counters, ("threshold_ccl_exact", "segment_stats"), card,
                     TIMED_STEPS["qd1"])

    # The row-banded step: four bands of the one card, kernel CCL.
    mesh = make_mesh([dev] * BANDS, space=BANDS)
    spatial = {}
    label_components_blocked.global_launches = 0
    propagate_components_blocked.global_launches = 0
    for qd in (2, 1):
        dk = {"quad_decimate": qd, "ccl_impl": "pallas"}
        sp_step, sp_place = make_sharded_vision_pipeline(
            layout, sp_params, sp_rc, mesh, spatial=True, detector_kwargs=dk)
        single = make_vision_pipeline(layout, sp_params, sp_rc, device=dev,
                                      detector_kwargs={"quad_decimate": qd})
        spatial[qd] = drive_path(
            f"spatial deployed qd{qd} path",
            lambda f, g: sp_step(*sp_place(f, g)), sp_frames, sp_poses,
            counters, ("label_components_blocked",
                       "propagate_components_blocked",
                       "extract_candidates_band", "segment_stats"), card,
            TIMED_STEPS["spatial"], against=single,
            ties_may_reorder=(qd == 2))
        if (label_components_blocked.global_launches
                or propagate_components_blocked.global_launches):
            raise AssertionError(f"spatial deployed qd{qd} path: B6 took "
                                 f"the global-memory route")
        label_components_block_kernel.host_reads = 0
        sp_step(*sp_place(sp_frames, torch.zeros(len(sp_poses), device=dev)))
        print(f"spatial deployed qd{qd} path: "
              f"{label_components_block_kernel.host_reads} host reads a step "
              f"(the band CCL's exit test)", flush=True)

    # -- options -----------------------------------------------------------
    gyro0 = torch.tensor([p[2] for p in poses], dtype=torch.float32,
                         device=dev)
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
    first = det.detect(torch.from_numpy(flood).to(dev))
    out = det(torch.from_numpy(flood).to(dev))
    torch.cuda.synchronize()
    if not (int(first.dropped_points.max()) > 0 and det.wide is not None
            and det.wide.edge_cap == 8192
            and torch.isfinite(out.corners).all()):
        raise AssertionError("capacity_fallback did not run its second "
                             "program on the flooded frame")
    print(f"options: YUYV step gives the GREY step's ids and poses; "
          f"flooded frame dropped {int(first.dropped_points.max())} of "
          f"4,096 -> second program (8,192) dropped "
          f"{int(out.dropped_points.max())}, ids "
          f"{out.ids[0][out.valid[0]].tolist()}", flush=True)

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
        *(dict(kernel_entry(name, source, replaces, spatial[1][name],
                            *band[name][:5]),
               device_ms=band[name][5], launches_per_call=band[name][6])
          for name, source, replaces in (
              ("label_components_blocked", "propagate.cu",
               "ccl_kernel.py:1244"),
              ("propagate_components_blocked", "propagate.cu",
               "ccl_kernel.py:1244"),
              ("extract_candidates_band", "extract_blocked.cu",
               "ccl_kernel.py:698"))),
    ]
    print(json.dumps({"kernels": report}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))  # 1, checked above


if __name__ == "__main__":
    main()
