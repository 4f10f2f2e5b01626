"""Benchmark: fused batched detect + pose throughput on one card (the
port's twin of the repository's ``bench.py``).

    python -m chalkydri_tpu_torch.bench

Measures ``bench.py``'s scene and rig: a 4-camera batch of the same
1280x800 grayscale frame (tag36h11 tags 1, 5, 9 and 13 at varied poses)
through the port's whole step (threshold -> CCL -> cluster -> quad ->
refine -> decode -> unproject -> SQPnP) at ``quad_decimate=2``, steady
state, on the card. The frame and the JAX package's outputs of the same
step on it are stored in ``tools/bench_scene.npz`` (the card machine has
neither OpenCV, which renders ``bench.py``'s scene, nor JAX); before it
prints anything the run holds the card's output to those outputs and
raises on a mismatch.

Denominator: OpenCV's detector, ``bench.py``'s denominator, is not
installed on the card machine, and no figure taken on another host may
stand in. So ``vs_baseline`` is the card's frames/s over the port's own
step on this host's CPU (``device="cpu"``, the same frames), measured
first, before CUDA is touched; ``cpu_ref`` names it. It is not
comparable with the ``vs_baseline`` of ``bench.py``'s records.

Prints ONE JSON line: ``bench.py``'s keys ("metric", "value", "unit",
"vs_baseline", "cpu_ref_fps", "cpu_ref_cv") plus "cpu_ref",
"step_ms_median", "step_ms_max" and "card" (``nvidia-smi``'s name and
power limit), and a comment line on stderr.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from chalkydri_tpu_torch.geometry.field_layout import parse_field_layout
from chalkydri_tpu_torch.pipeline import build_rig_from_config, make_vision_pipeline
from chalkydri_tpu_torch.utils.platform import resolve_device

H, W = 800, 1280
BATCH = 4
# Rounds of timed steps; the best round's step time gives the rate.
WARMUP = 3
# Eager steps a round, enqueued back to back with one fetch at the end:
# they average the host's launch jitter, which moves single steps by tens
# of ms on a shared host.
ITERS = 400
CPU_REF_RUNS = 5  # single CPU steps of the denominator, after one warm step
SCENE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                     "bench_scene.npz")
# The port's CPU parity tolerances (tests/test_torch_pipeline.py):
# corners px, position m, yaw rad; decision margins relative.
CORNER_TOL, POSE_TOL, YAW_TOL, MARGIN_RTOL = 1e-3, 1e-3, 1e-3, 1e-3
# std-devs are the solver's covariance diagonal, relative.
STD_RTOL = 1e-2
INT_FIELDS = ("ids", "hammings", "valid", "dropped_points", "pose_valid",
              "tag_count")


class BenchResult(NamedTuple):
    fps: float  # BATCH / best round's step time
    step_ms: list  # step ms of each round (round wall / iters)
    n_det: int  # valid detections in frame 0
    card: str  # the device's name
    out: object  # the first (untimed) step's VisionOutput


def load_reference() -> dict:
    """The stored arrays: ``frame`` [H, W] u8 and the JAX package's
    outputs of the step on the 4-frame batch with gyro 0."""
    with np.load(SCENE) as z:
        return {k: z[k] for k in z.files}


def build_scene() -> np.ndarray:
    """``bench.py``'s 1280x800 frame, [H, W] uint8."""
    return load_reference()["frame"]


def build_rig(device):
    """``bench.py``'s rig on ``device``: tags 1, 5, 9, 13 at x = 10 + 0.5 t,
    y = 4, z = 1 facing -x on a 16.5 x 8.0 field; BATCH cameras with
    fx = fy = 1100 at the frame's centre, no distortion, 1 m up. Returns
    ``(layout, params [B, 9], robot->camera SE3 [B])``."""
    calib = {
        "fx": 1100.0, "fy": 1100.0, "cx": W / 2, "cy": H / 2,
        "k1": 0.0, "k2": 0.0, "p1": 0.0, "p2": 0.0, "k3": 0.0,
        "width": W, "height": H,
    }
    tags = [
        {
            "ID": t,
            "pose": {
                "translation": {"x": 10.0 + 0.5 * t, "y": 4.0, "z": 1.0},
                "rotation": {"quaternion": {"W": 0.0, "X": 0.0, "Y": 0.0, "Z": 1.0}},
            },
        }
        for t in (1, 5, 9, 13)
    ]
    layout = parse_field_layout(
        {"tags": tags, "field": {"length": 16.5, "width": 8.0}},
        dtype=torch.float32, device=device)
    cams = [
        {
            "calib": json.dumps({"OpenCVModel5": calib}),
            "robot_to_cam": json.dumps(
                {"roll": 0, "pitch": 0, "yaw": 0, "x": 0, "y": 0, "z": 1.0}
            ),
        }
    ] * BATCH
    params, rc = build_rig_from_config(cams, layout, device=device)
    return layout, params, rc


def make_step(device):
    """The step of ``bench.py``'s rig on ``device``."""
    return make_vision_pipeline(*build_rig(device), device=device)


def _leaves(out) -> list:
    return [*out[:-1], *out.detections]


def check_outputs(out, ref: dict, label: str) -> None:
    """Raise unless ``out`` (a VisionOutput) is the stored JAX output:
    integers equal, floats within the parity tolerances."""
    got = {name: t.cpu().numpy() for name, t in
           (*zip(out._fields[:-1], out[:-1]),
            *zip(out.detections._fields, out.detections))}
    for name in INT_FIELDS:
        if not np.array_equal(got[name], ref[name]):
            raise AssertionError(f"{label}: {name} {got[name].tolist()} is not "
                                 f"JAX's {ref[name].tolist()}")
    valid = ref["valid"]
    for name, tol, keep in (("corners", CORNER_TOL, valid),
                            ("pose_x", POSE_TOL, None),
                            ("pose_y", POSE_TOL, None),
                            ("pose_yaw", YAW_TOL, None)):
        g, w = (got[name], ref[name]) if keep is None else (
            got[name][keep], ref[name][keep])
        err = float(np.abs(g.astype(np.float64) - w).max())
        if not err <= tol:
            raise AssertionError(f"{label}: {name} differs from JAX's by "
                                 f"{err} (tolerance {tol})")
    for name, rtol, keep in (("decision_margins", MARGIN_RTOL, valid),
                             ("std_devs", STD_RTOL, None)):
        g, w = (got[name], ref[name]) if keep is None else (
            got[name][keep], ref[name][keep])
        w = w.astype(np.float64)
        if not (np.abs(g - w) <= rtol * np.maximum(1.0, np.abs(w))).all():
            raise AssertionError(f"{label}: {name} {g.tolist()} differs from "
                                 f"JAX's {w.tolist()} (relative {rtol})")


def bench_gpu(frames: np.ndarray, iters: int = ITERS, reps: int = WARMUP,
              device="cuda") -> BenchResult:
    """Steady-state rate of the step on ``frames`` [BATCH, H, W] u8.

    The frames and their LSB-toggled copy go to the device first; one
    untimed step warms up (it builds the kernels at first use) and drains
    the queue. Then ``reps`` rounds of ``iters`` eager steps run back to
    back, alternating the two batches so that no step repeats its input;
    each round sums its output leaves on the device and fetches the sum
    once, at the end: the fetch is the round's completion barrier."""
    dev = resolve_device(device)
    step = make_step(dev)
    batches = (torch.from_numpy(frames).to(dev),
               torch.from_numpy(frames ^ 1).to(dev))
    gyro = torch.zeros(BATCH, dtype=torch.float32, device=dev)

    out = step(batches[0], gyro)
    n_det = int(out.detections.valid[0].sum())  # drains the queue
    step_ms = []
    for _ in range(reps):
        t0 = time.perf_counter()
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(iters):
            o = step(batches[i % 2], gyro)
            acc = acc + torch.stack([x.sum(dtype=torch.float32)
                                     for x in _leaves(o)]).sum()
        float(acc)  # the fetch forces completion
        step_ms.append((time.perf_counter() - t0) / iters * 1e3)
    card = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else str(dev))
    return BenchResult(BATCH / min(step_ms) * 1e3, step_ms, n_det, card, out)


def bench_cpu_reference(frames: np.ndarray, runs: int = CPU_REF_RUNS):
    """The port's step on this host's CPU on the same frames: one warm
    step, then the best of ``runs`` single steps. Returns (best fps,
    [per-step fps], the step's output, what the denominator is)."""
    step = make_step("cpu")
    x = torch.from_numpy(frames)
    gyro = torch.zeros(BATCH, dtype=torch.float32)
    out = step(x, gyro)
    fps = []
    for _ in range(runs):
        t0 = time.perf_counter()
        step(x, gyro)
        fps.append(BATCH / (time.perf_counter() - t0))
    what = (f"chalkydri_tpu_torch step, device=cpu, torch {torch.__version__}, "
            f"{torch.get_num_threads()} threads")
    return max(fps), fps, out, what


def card_line(device) -> str:
    """``nvidia-smi``'s name and power limit of a CUDA device, else the
    device's name."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return str(dev)
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[dev.index or 0]


def result_line(res: BenchResult, cpu_fps: float, cpu_samples, cpu_ref: str,
                card: str) -> dict:
    """The JSON line: ``bench.py``'s keys plus the twin's own."""
    mean = sum(cpu_samples) / len(cpu_samples)
    var = sum((s - mean) ** 2 for s in cpu_samples) / len(cpu_samples)
    cpu_cv = (var ** 0.5) / mean if mean else 0.0
    return {
        "metric": "fps_per_gpu_1280x800_batch4_detect_pose",
        "value": round(res.fps, 2),
        "unit": "frames/sec",
        "vs_baseline": round(res.fps / cpu_fps, 3),
        "cpu_ref_fps": round(cpu_fps, 2),
        "cpu_ref_cv": round(cpu_cv, 4),
        "cpu_ref": cpu_ref,
        "step_ms_median": round(statistics.median(res.step_ms), 3),
        "step_ms_max": round(max(res.step_ms), 3),
        "card": card,
    }


def main(device="cuda") -> None:
    dev = resolve_device(device)  # no card: raise before any work
    ref = load_reference()
    frames = np.broadcast_to(ref["frame"], (BATCH, H, W)).copy()

    # Denominator first: CUDA init and the kernel builds load the host;
    # the CPU reference must see a quiet machine.
    cpu_fps, cpu_samples, cpu_out, cpu_ref = bench_cpu_reference(frames)
    check_outputs(cpu_out, ref, "cpu step")
    res = bench_gpu(frames, ITERS, WARMUP, device=dev)
    check_outputs(res.out, ref, f"{dev} step")
    line = result_line(res, cpu_fps, cpu_samples, cpu_ref, card_line(dev))
    print(json.dumps(line))
    print(
        f"# device={res.card} cpu_ref={cpu_fps:.1f} fps (cv "
        f"{line['cpu_ref_cv']:.3f}, best-of-{CPU_REF_RUNS}: {cpu_ref}) "
        f"detections_frame0={res.n_det}/4 batch={BATCH}; {ITERS} steps a "
        f"round, {WARMUP} rounds, step ms per round "
        f"{[round(t, 3) for t in res.step_ms]}; the per-round sum adds "
        f"{len(_leaves(res.out)) + 3} small launches a step (a sum a leaf, "
        f"stack, sum, add)",
        file=sys.stderr)


if __name__ == "__main__":
    main()
