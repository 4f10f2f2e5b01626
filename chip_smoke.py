"""GPU smoke run of the PyTorch/CUDA port: frames -> robot poses on one card.

    python3 chip_smoke.py

1. prints the card (``nvidia-smi`` name and power limit) and fails without
   CUDA;
2. builds the hand-written CUDA kernels from ``chalkydri_tpu_torch/csrc``;
3. renders four 1280x800 frames of four tag36h11 tags of the 2026 field
   layout (``examples/field_2026.json``) through the bench camera
   (fx = fy = 1100, camera 1 m up, no tilt), one known robot pose per
   frame, as a batch of 4 cameras;
4. runs each kernel on the card at the main path's shapes against its
   plain PyTorch twin on the same CUDA tensors (bit-identical required),
   times both with CUDA events, and checks both again on edge cases (a
   scene where the CCL round cap binds, noise, adversarial run layouts,
   row counts under one tile and off the 128-row chunk);
5. drives the port's main path (``build_rig_from_config`` ->
   ``make_vision_pipeline(device="cuda")``) for a few steps with varying
   gyro, checks the ids and each frame's pose against its own truth and
   that every kernel of the path launched, and compares it with the same
   step run on the plain twins only.

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

H, W, BATCH = 800, 1280, 4
CALIB = {"fx": 1100.0, "fy": 1100.0, "cx": W / 2, "cy": H / 2, "k1": 0.0,
         "k2": 0.0, "p1": 0.0, "p2": 0.0, "k3": 0.0, "width": W, "height": H}
MOUNT = {"roll": 0, "pitch": 0, "yaw": 0, "x": 0, "y": 0, "z": 1.0}
TAGS = (28, 29, 30, 31)  # blue wall, x = 16.518 m, facing -x
# One robot pose (x, y, yaw) per batch slot, so a slot mix-up shows.
POSES = ((13.0, 4.0215, 0.0), (12.9, 3.99, 0.015), (13.1, 4.06, -0.015),
         (12.8, 3.95, 0.04))
GYRO_OFFSETS = (0.0, 0.01, -0.01, 0.02, -0.02)  # rad, one per step
POSE_TOL_M = 0.02
CORNER_TOL, POSE_TOL, YAW_TOL = 1e-3, 1e-3, 1e-3  # as the CPU parity tests
TIMED_RUNS = 20
STEPS = 5


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def homography(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """3x3 homography mapping 4 src points onto 4 dst points (DLT)."""
    a, b = [], []
    for (x, y), (u, v) in zip(src, dst):
        a.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        a.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        b += [u, v]
    h = np.linalg.solve(np.asarray(a, np.float64), np.asarray(b, np.float64))
    return np.append(h, 1.0).reshape(3, 3)


def place_tag(canvas: np.ndarray, tag: np.ndarray, cell_px: int,
              corners: np.ndarray) -> None:
    """Warp a rendered tag (white border of one cell) onto the canvas so its
    outer black-border corners (BL, BR, TR, TL) land on ``corners``:
    inverse mapping with bilinear sampling; pixels that map outside the
    tag image are left as they are."""
    side = tag.shape[0]
    b = cell_px
    src = np.array([[b, side - b], [side - b, side - b], [side - b, b],
                    [b, b]], np.float64) - 0.5
    hinv = np.linalg.inv(homography(src, corners.astype(np.float64)))
    x0, y0 = np.floor(corners.min(axis=0) - 2 * cell_px).astype(int)
    x1, y1 = np.ceil(corners.max(axis=0) + 2 * cell_px).astype(int)
    x0, y0 = max(x0, 0), max(y0, 0)
    x1, y1 = min(x1, canvas.shape[1] - 1), min(y1, canvas.shape[0] - 1)
    ys, xs = np.mgrid[y0:y1 + 1, x0:x1 + 1].astype(np.float64)
    p = hinv @ np.stack([xs.ravel(), ys.ravel(), np.ones(xs.size)])
    sx, sy = p[0] / p[2], p[1] / p[2]
    inside = (sx >= 0) & (sx <= side - 1) & (sy >= 0) & (sy <= side - 1)
    sx, sy = sx[inside], sy[inside]
    ix = np.minimum(np.floor(sx).astype(int), side - 2)
    iy = np.minimum(np.floor(sy).astype(int), side - 2)
    fx, fy = sx - ix, sy - iy
    t = tag.astype(np.float64)
    val = ((t[iy, ix] * (1 - fx) + t[iy, ix + 1] * fx) * (1 - fy)
           + (t[iy + 1, ix] * (1 - fx) + t[iy + 1, ix + 1] * fx) * fy)
    rows = ys.ravel()[inside].astype(int)
    cols = xs.ravel()[inside].astype(int)
    canvas[rows, cols] = np.clip(np.rint(val), 0, 255).astype(np.uint8)


def render_scene(layout, rig_rc, robot_x, robot_y, robot_yaw):
    """The camera's view of TAGS from a robot pose, float64 geometry."""
    import torch

    from chalkydri_tpu_torch.detector.families import load_family, render_tag
    from chalkydri_tpu_torch.geometry.tags import corners_world

    fam = load_family("tag36h11")
    c, s = math.cos(robot_yaw), math.sin(robot_yaw)
    w2r_rot = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]])
    w2r_t = -w2r_rot @ np.array([robot_x, robot_y, 0.0])
    rc_rot = rig_rc.rotation[0].double().cpu().numpy()
    rc_t = rig_rc.translation[0].double().cpu().numpy()
    canvas = np.full((H, W), 150, np.uint8)
    cell_px = 16
    for tid in TAGS:
        pose = layout.tag_pose(torch.tensor(tid))
        pose = type(pose)(pose.rotation.double().cpu(),
                          pose.translation.double().cpu())
        cw = corners_world(pose).numpy()  # [4, 3]
        pc = (rc_rot @ (w2r_rot @ cw.T + w2r_t[:, None])) + rc_t[:, None]
        if not (pc[2] > 0.5).all():
            raise AssertionError(f"tag {tid} is not in front of the camera")
        pix = np.stack([CALIB["fx"] * pc[0] / pc[2] + CALIB["cx"],
                        CALIB["fy"] * pc[1] / pc[2] + CALIB["cy"]], axis=1)
        if not ((pix > 16).all() and (pix[:, 0] < W - 16).all()
                and (pix[:, 1] < H - 16).all()):
            raise AssertionError(f"tag {tid} is not inside the frame: {pix}")
        place_tag(canvas, render_tag(fam, tid, cell_px=cell_px), cell_px, pix)
    return canvas


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


class plain_twins:
    """Within this context the detector calls the kernels' plain twins on
    CUDA tensors (the module attributes its functions look up per call)."""

    def __enter__(self):
        import chalkydri_tpu_torch.detector.cluster as cluster
        import chalkydri_tpu_torch.detector.pipeline as det
        from chalkydri_tpu_torch.ops.ccl_extract import threshold_ccl_extract_plain
        from chalkydri_tpu_torch.ops.segment_stats import segment_stats_plain

        self._saved = [(det, "threshold_ccl_extract", det.threshold_ccl_extract),
                       (cluster, "segment_stats", cluster.segment_stats)]
        det.threshold_ccl_extract = threshold_ccl_extract_plain
        cluster.segment_stats = segment_stats_plain
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        return False


def serpentine(h: int = 64, w: int = 128, stripes: int = 20) -> np.ndarray:
    """A white snake on black (vertical 1-px stripes joined alternately at
    the top and bottom row): 12 CCL rounds do not converge on it."""
    g = np.zeros((h, w), np.uint8)
    cols = np.linspace(2, w - 3, stripes).astype(int)
    g[:, cols] = 255
    for i in range(len(cols) - 1):
        g[0 if i % 2 == 0 else h - 1, cols[i]:cols[i + 1] + 1] = 255
    return g


def edge_cases(dev) -> None:
    """Both kernels against their twins on inputs the bench scene does not
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
             rng.integers(0, 256, (BATCH, H // 2, W // 2), dtype=np.uint8)]
    for i, g in enumerate(grays):
        x = torch.from_numpy(g).to(dev)
        for name, a, b in zip(("black", "white", "payload"),
                              threshold_ccl_extract(x, iters=12),
                              threshold_ccl_extract_plain(x, iters=12)):
            if not torch.equal(a, b):
                raise AssertionError(f"B1 case {i}: {name} differs")
    n, int_max = 2048, 2 ** 31 - 1
    runs = np.sort(np.repeat(rng.integers(0, 1 << 30, 40), 45)[:n - 100])
    keys = np.stack([
        np.full(n, 7), np.full(n, int_max), np.arange(n),
        np.concatenate([runs, np.full(n - len(runs), int_max)]),
    ]).astype(np.int32)
    payloads = rng.integers(0, 1 << 29, keys.shape, dtype=np.int32)
    k = torch.from_numpy(keys).to(dev)
    p = torch.from_numpy(payloads).to(dev)
    for name, a, b in zip(("t", "cand_len", "cand_pos"), segment_stats(k, p),
                          segment_stats_plain(k, p)):
        if not torch.equal(a, b):
            raise AssertionError(f"B2 adversarial layouts: {name} differs")
    for m in (256, 200):  # under one 1024-row tile, and off the 128 chunk
        km, pm = k[:, :m].contiguous(), p[:, :m].contiguous()
        for name, a, b in zip(("t", "cand_len", "cand_pos"),
                              segment_stats(km, pm),
                              segment_stats_plain(km, pm)):
            if not torch.equal(a, b):
                raise AssertionError(f"B2 at n = {m}: {name} differs")


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
    from chalkydri_tpu_torch.detector.pipeline import decimate2
    from chalkydri_tpu_torch.geometry.field_layout import load_field_layout
    from chalkydri_tpu_torch.ops import build
    from chalkydri_tpu_torch.ops.ccl_extract import (
        threshold_ccl_extract,
        threshold_ccl_extract_plain,
    )
    from chalkydri_tpu_torch.ops.segment_stats import (
        segment_stats,
        segment_stats_plain,
    )
    from chalkydri_tpu_torch.pipeline import (
        build_rig_from_config,
        make_vision_pipeline,
    )

    t0 = time.perf_counter()
    build.kernel_library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{os.path.relpath(build.library_path(), ROOT)}", flush=True)

    layout = load_field_layout(os.path.join(ROOT, "examples", "field_2026.json"),
                               dtype=torch.float32)
    cams = [{"calib": json.dumps({"OpenCVModel5": CALIB}),
             "robot_to_cam": json.dumps(MOUNT)}] * BATCH
    params, rc = build_rig_from_config(cams, layout)
    frames = torch.from_numpy(np.stack(
        [render_scene(layout, rc, *pose) for pose in POSES])).to(dev)
    true_x, true_y, true_yaw = (torch.tensor(v, dtype=torch.float32,
                                             device=dev) for v in zip(*POSES))
    print(f"scene: {BATCH} x {H}x{W} u8, tags {list(TAGS)}, robot poses "
          f"(x, y, yaw) {list(POSES)}", flush=True)

    # -- kernel phases: each kernel against its plain twin, same tensors --
    small = decimate2(frames)
    got = threshold_ccl_extract(small, iters=12)
    want = threshold_ccl_extract_plain(small, iters=12)
    torch.cuda.synchronize()
    for name, g, w in zip(("black", "white", "payload"), got, want):
        if not torch.equal(g, w):
            raise AssertionError(f"B1 {name} differs from its plain twin")
    b1_err = max_abs_err(got, want)
    b1_ms = statistics.median(cuda_times_ms(
        lambda: threshold_ccl_extract(small, iters=12)))
    b1_plain_ms = statistics.median(cuda_times_ms(
        lambda: threshold_ccl_extract_plain(small, iters=12)))
    print(f"B1 threshold_ccl_extract {tuple(small.shape)}: kernel "
          f"{b1_ms:.4f} ms, plain {b1_plain_ms:.4f} ms, bit-identical "
          f"[{card}]", flush=True)

    black, white, payload, _ = compact_candidates(
        *got, width=small.shape[2], max_points=MAX_EDGE_POINTS)
    s_key, s_payload = sort_candidates(black, white, payload, MAX_EDGE_POINTS)
    got2 = segment_stats(s_key, s_payload)
    want2 = segment_stats_plain(s_key, s_payload)
    torch.cuda.synchronize()
    for name, g, w in zip(("t", "cand_len", "cand_pos"), got2, want2):
        if not torch.equal(g, w):
            raise AssertionError(f"B2 {name} differs from its plain twin")
    b2_err = max_abs_err(got2, want2)
    b2_ms = statistics.median(cuda_times_ms(
        lambda: segment_stats(s_key, s_payload)))
    b2_plain_ms = statistics.median(cuda_times_ms(
        lambda: segment_stats_plain(s_key, s_payload)))
    print(f"B2 segment_stats {tuple(s_key.shape)}: kernel {b2_ms:.4f} ms, "
          f"plain {b2_plain_ms:.4f} ms, bit-identical [{card}]", flush=True)

    edge_cases(dev)
    print("edge cases: B1 and B2 bit-identical to their twins where the CCL "
          "round cap binds, on noise, on adversarial run layouts, and at "
          "n = 256 and 200 rows",
          flush=True)

    # -- main path through the entry points, kernels counted --------------
    step = make_vision_pipeline(layout, params, rc, device=dev)
    gyros = [true_yaw + d for d in GYRO_OFFSETS]
    threshold_ccl_extract.launches = 0
    segment_stats.launches = 0
    outs = [step(frames, g) for g in gyros[:STEPS]]
    torch.cuda.synchronize()
    launches = {"threshold_ccl_extract": threshold_ccl_extract.launches,
                "segment_stats": segment_stats.launches}
    print(f"main path: {STEPS} steps, kernel launches {launches}", flush=True)
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the main path")

    for i, out in enumerate(outs):
        for b in range(BATCH):
            ids = sorted(out.detections.ids[b][out.detections.valid[b]].tolist())
            if ids != sorted(TAGS):
                raise AssertionError(f"step {i} frame {b}: ids {ids}")
        for name, v in (("pose_x", out.pose_x), ("pose_y", out.pose_y),
                        ("pose_yaw", out.pose_yaw),
                        ("std_devs", out.std_devs),
                        ("corners", out.detections.corners)):
            if not torch.isfinite(v).all():
                raise AssertionError(f"step {i}: non-finite {name}")
        err = torch.hypot(out.pose_x - true_x, out.pose_y - true_y)
        if not (out.pose_valid.all() and (err <= POSE_TOL_M).all()):
            raise AssertionError(f"step {i}: pose error {err.tolist()} m, "
                                 f"valid {out.pose_valid.tolist()}")
    pose_err = max(float(torch.hypot(out.pose_x - true_x,
                                     out.pose_y - true_y).max())
                   for out in outs)
    print(f"poses: 4 ids in each of {BATCH} frames, each frame's pose "
          f"against its own truth: max position error {pose_err:.5f} m, "
          f"yaw {outs[0].pose_yaw.tolist()}", flush=True)

    with plain_twins():
        plain_out = step(frames, gyros[0])
    ref = outs[0]
    for name in ("ids", "hammings", "valid", "dropped_points"):
        if not torch.equal(getattr(ref.detections, name),
                           getattr(plain_out.detections, name)):
            raise AssertionError(f"main path {name} differs from plain twins")
    for name in ("tag_count", "pose_valid"):
        if not torch.equal(getattr(ref, name), getattr(plain_out, name)):
            raise AssertionError(f"main path {name} differs from plain twins")
    valid = ref.detections.valid
    checks = (
        ("corners", ref.detections.corners[valid],
         plain_out.detections.corners[valid], CORNER_TOL),
        ("pose_x", ref.pose_x, plain_out.pose_x, POSE_TOL),
        ("pose_y", ref.pose_y, plain_out.pose_y, POSE_TOL),
        ("pose_yaw", ref.pose_yaw, plain_out.pose_yaw, YAW_TOL),
    )
    for name, a, b, tol in checks:
        if float((a - b).abs().max()) > tol:
            raise AssertionError(f"main path {name} differs from plain twins")
    m_a = ref.detections.decision_margins[valid]
    m_b = plain_out.detections.decision_margins[valid]
    if not ((m_a - m_b).abs() <= 1e-3 * m_b.abs().clamp(min=1.0)).all():
        raise AssertionError("main path decision margins differ from plain twins")

    def step_times(plain: bool) -> list[float]:
        times = []
        for i in range(TIMED_RUNS + 1):
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
    for label, times in (("kernels", kern_a + kern_b),
                         ("plain twins", plain_a + plain_b)):
        med = statistics.median(times)
        p75 = statistics.quantiles(times, n=4)[2]
        print(f"step {BATCH}x{H}x{W} {label}: median {med:.3f} ms "
              f"({BATCH / med * 1e3:.1f} frames/s), p75 {p75:.3f} ms, "
              f"{len(times)} host-clock steps [{card}]", flush=True)

    report = [
        {"name": "threshold_ccl_extract", "route": "cuda",
         "source": "chalkydri_tpu_torch/csrc/ccl_extract.cu",
         "replaces": "chalkydri_tpu/ops/pallas/ccl_kernel.py:572",
         "launches": launches["threshold_ccl_extract"],
         "max_abs_err": b1_err, "ms": b1_ms, "plain_ms": b1_plain_ms},
        {"name": "segment_stats", "route": "cuda",
         "source": "chalkydri_tpu_torch/csrc/segment_stats.cu",
         "replaces": "chalkydri_tpu/ops/pallas/segment_kernel.py:182",
         "launches": launches["segment_stats"],
         "max_abs_err": b2_err, "ms": b2_ms, "plain_ms": b2_plain_ms},
    ]
    print(json.dumps({"kernels": report}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))  # 1, checked above


if __name__ == "__main__":
    main()
