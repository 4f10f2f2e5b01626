"""Stage cost map of the port's step on the card.

    python -m chalkydri_tpu_torch.tools.perfprobe [--runs N]

For each path of ``chip_smoke.py`` (``quad_decimate=2`` on the bench scene,
``quad_decimate=1`` on the bench and the deployed scene, and the row-banded
step over four bands on the spatial scene at both, ``tools/scenes``) it
prints, one line each:

- on the single-card paths, the device ms of each stage of the replayed
  step, from the step's own stamps (``utils/tracing.py``: ``step.front``,
  ``step.cluster``, ``step.quad``, ``step.refine``, ``step.decode``,
  ``step.solve`` and ``step.span``), median of N replays after a warm-up;
  the row-banded step has no stamps, so there each front-end stage alone,
  between two ``torch.cuda.synchronize()``: host ms, median of N runs
  (placement, decimation + halo threshold, band CCL, band extraction,
  compaction over bands, and the whole eager step); on every path the
  whole replayed step on the host clock;
- a ``torch.profiler`` window over 3 steps: wall ms, the device kernel
  time, the device's busy share and the host's launches per step
  (kernels, CUDA graphs, copies), for the eager step (the captured
  step's ``.module``, as the stages above; on the row-banded paths each
  data group's) and for the replayed step (``utils/graph.py``), whose
  whole step is also timed on the host clock; on the row-banded paths
  also the seam rounds each frame ran.

Before the paths it prints where the capped CCL rounds spend their time
(``ccl rounds ...`` lines): the device time of each CUDA kernel inside B4
on the bench scene at [4, 800, 1280], on a page where all 12 rounds bind,
and inside B1 at [4, 400, 640] and at the deployed rig's [2, 652, 800]
(one cluster launch each), with the launches that ran and the
CUDA-event time of the whole call (the difference is host and launch
time); then ``B5 ...`` lines of the same form for B5 on the deployed
scene, [2, 1304, 1600], and on a serpentine of that shape whose snake
crosses every tile border (``B5_STRIPES``); then a ``B2 ...`` line of the
same form for B2 on the bench scene's sorted candidates, [4, 65536]; then
a line of the same form for each of B6's two entries and B7 at the
full-resolution band shapes of the row-banded step ([2, 328, 1600], B7
with its halo rows [2, 331, 1600]).

To set two trees side by side in one call, run this file as a script
with ``PYTHONPATH`` at the other tree's root: it then measures that
tree's package.

The last line is a JSON object of the same numbers. Fails without CUDA.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import time

import torch


def _host_ms(fn, runs: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def replayed_stage_ms(step, frames, gyro, runs: int) -> dict[str, float]:
    """Device ms of each stage of the replayed step (a ``CapturedStep`` of
    ``VisionPipeline``), by its own stamps: the median of each ``step.*``
    record over ``runs`` replays after a warm-up."""
    from chalkydri_tpu_torch.utils import tracing

    step(frames, gyro)
    spans = tracing.SpanStats()
    for _ in range(runs):
        step(frames, gyro)
        stamps = tracing.take_stamps()
        tracing.record_stages(stamps.cpu(), stamps.device, spans)
    return {name: statistics.median(v) * 1e3
            for name, v in spans.samples.items()}


def band_stage_times(step, place, frames, gyro, qd: int, edge_cap: int,
                     runs: int) -> dict[str, float]:
    """Host ms of each front-end stage of the row-banded step alone, and
    of the whole eager step (each data group's ``.module``)."""
    from chalkydri_tpu_torch.detector.pipeline import decimate2
    from chalkydri_tpu_torch.detector.threshold import MIN_WHITE_BLACK_DIFF
    from chalkydri_tpu_torch.parallel import pipeline as par
    from chalkydri_tpu_torch.parallel.sharded_stages import (
        _exchange_halo,
        _threshold_block,
        label_components_block_kernel,
    )

    out = {"placement (frames into bands)": _host_ms(
        lambda: place(frames, gyro), runs)}
    bands = place(frames, gyro)[0][0]

    def threshold():
        small = [decimate2(b) if qd == 2 else b for b in bands]
        return [_threshold_block(ext, MIN_WHITE_BLACK_DIFF)
                for ext in _exchange_halo(small)]

    out["decimate + halo threshold"] = _host_ms(threshold, runs)
    terns = threshold()
    out["band CCL (B6 + seam exchanges)"] = _host_ms(
        lambda: label_components_block_kernel(terns), runs)
    labels = label_components_block_kernel(terns)
    out["band extraction (B7 + halo rows)"] = _host_ms(
        lambda: par._band_candidates(terns, labels), runs)
    pages = par._band_candidates(terns, labels)
    hl, w = terns[0].shape[1:]
    out["compaction over bands"] = _host_ms(
        lambda: par._compact_over_bands(pages, hl, w, edge_cap,
                                        terns[0].device), runs)
    out["whole step"] = _host_ms(lambda: banded_eager(step, place)(
        frames, gyro), runs)
    return out


def banded_eager(step, place):
    """The eager form of ``make_sharded_vision_pipeline``'s one-group
    step: its group's ``.module`` on the placed bands."""
    (pipe,) = step.pipes

    def run(frames, gyro):
        bands, gyros = place(frames, gyro)
        return getattr(pipe, "module", pipe)(*bands[0], gyros[0])

    return run


def device_times(fn, calls: int = 10, per_call: int | None = None,
                 wrapper=None, tries: int = 5) -> dict[str, dict]:
    """The device time of every CUDA kernel that ``calls`` calls of ``fn``
    launch, by ``torch.profiler``: {kernel name: {"launches_per_call",
    "us_per_call"}}, after one warm-up call.

    The profiler's window sometimes loses launches. A window in which a
    kernel's launches are not a whole number a call, or, with
    ``per_call``, that did not see ``per_call`` device launches for each
    call it added to ``wrapper.launches`` (the kernel wrapper's own count,
    which must grow by ``calls``), is profiled again, ``tries`` times at
    most; then this raises."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(tries):
        before = wrapper.launches if wrapper is not None else 0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        added = wrapper.launches - before if wrapper is not None else calls
        counts, us = {}, {}
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total",
                        getattr(e, "self_cuda_time_total", 0))
            if t > 0:
                # "void ccl::(anonymous namespace)::name<16>(int*, ..."
                m = re.search(r"(\w+(<[^>]*>)?)\(", e.key)
                key = m.group(1) if m else e.key
                # the profiler may split one kernel over several entries
                counts[key] = counts.get(key, 0) + e.count
                us[key] = us.get(key, 0.0) + t
        whole = all(n % calls == 0 for n in counts.values())
        if (whole and added == calls
                and (per_call is None
                     or sum(counts.values()) == per_call * added)):
            return {k: {"launches_per_call": counts[k] // calls,
                        "us_per_call": us[k] / calls} for k in counts}
        seen.append((added, counts))
        print(f"device_times: the profiler's window saw {counts} in {added} "
              f"calls; profiling again", flush=True)
    raise RuntimeError(
        f"torch.profiler lost launches in {tries} windows of {calls} calls "
        f"(wanted {per_call} device launches a call): (wrapper calls, "
        f"device launches by kernel) {seen}")


def event_us(fn, calls: int = 10) -> float:
    """Median CUDA-event us of one call of ``fn``."""
    times = []
    for _ in range(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3)
    return statistics.median(times)


# Stripes of the serpentine B5 is timed on at the deployed shape: 5.3 px
# apart at W = 1600, so every 3x3 tile neighborhood has contrast and the
# page thresholds to itself; the snake crosses every tile border.
B5_STRIPES = 300


def ccl_round_times(frames, deployed, calls: int = 10) -> dict[str, dict]:
    """Device us of every CUDA kernel inside one call of B4 (bench scene
    and a page on which all rounds bind), of B5 (``deployed`` scene and a
    serpentine of its shape), of B1 (bench and ``deployed`` scene,
    decimated) and of B2, by kernel name, with its launches a call, and
    the whole call's CUDA-event us."""
    import numpy as np

    from chalkydri_tpu_torch.detector.cluster import (
        MAX_EDGE_POINTS,
        compact_candidates,
        sort_candidates,
    )
    from chalkydri_tpu_torch.detector.pipeline import decimate2
    from chalkydri_tpu_torch.detector.threshold import adaptive_threshold
    from chalkydri_tpu_torch.ops.ccl_extract import threshold_ccl_extract
    from chalkydri_tpu_torch.ops.segment_stats import segment_stats
    from chalkydri_tpu_torch.ops.threshold_ccl import (
        label_components_ccl,
        threshold_ccl_exact,
    )
    from chalkydri_tpu_torch.tools.scenes import serpentine

    tern = adaptive_threshold(frames)
    b, h, w = tern.shape
    worst = torch.from_numpy(np.stack([serpentine(h, w, 200)] * b)).to(
        frames.device)
    snake = torch.from_numpy(np.stack(
        [serpentine(*deployed.shape[1:], B5_STRIPES)] * len(deployed))).to(
        frames.device)
    small, dep_small = decimate2(frames), decimate2(deployed)
    black, white, payload, _ = compact_candidates(
        *threshold_ccl_extract(small, 12), width=small.shape[2],
        max_points=MAX_EDGE_POINTS)
    s_key, s_payload = sort_candidates(black, white, payload, MAX_EDGE_POINTS)
    cases = {f"B4 bench scene {list(tern.shape)}":
             lambda: label_components_ccl(tern, 12),
             f"B4 all 12 rounds bind {list(worst.shape)}":
             lambda: label_components_ccl(worst, 12),
             f"B5 deployed scene {list(deployed.shape)}":
             lambda: threshold_ccl_exact(deployed),
             f"B5 serpentine {list(snake.shape)}":
             lambda: threshold_ccl_exact(snake),
             f"B1 bench scene {list(small.shape)}":
             lambda: threshold_ccl_extract(small, 12),
             f"B1 deployed scene {list(dep_small.shape)}":
             lambda: threshold_ccl_extract(dep_small, 12),
             f"B2 bench scene {list(s_key.shape)}":
             lambda: segment_stats(s_key, s_payload)}
    out = {}
    for name, fn in cases.items():
        kernels = device_times(fn, calls)
        out[name] = {"kernels": kernels,
                     "kernel_us_per_call": sum(k["us_per_call"]
                                               for k in kernels.values()),
                     "event_us_per_call": event_us(fn, calls)}
    return out


def band_kernel_inputs(frames, n_bands: int = 4):
    """The inputs kernels B6 and B7 get at the band that holds the tags'
    upper halves (band ``n_bands // 2 - 1``) when the row-banded step cuts
    ``frames`` into ``n_bands`` bands at full resolution: (tern band
    [B, hl, W], its globally offset labels after one seam exchange, the
    band extended by one row above and two below [B, hl + 3, W] in tern
    and in whole-frame labels, the band's first frame row)."""
    import torch.nn.functional as F

    from chalkydri_tpu_torch.detector.segment import INVALID, padded_width
    from chalkydri_tpu_torch.detector.threshold import adaptive_threshold
    from chalkydri_tpu_torch.ops.propagate import label_components_blocked
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

    tern = adaptive_threshold(frames)
    bands = place_frames(make_mesh([frames.device] * n_bands, space=n_bands),
                         tern, spatial=True)[0]
    hl, w = bands[0].shape[1:]
    j = n_bands // 2 - 1
    labels = [label_components_blocked(t) for t in bands]
    labels = [torch.where(lab == INVALID, lab, lab + i * hl * padded_width(w))
              for i, lab in enumerate(labels)]
    merged = _with_seam_rows(labels[j], *_ici_seam_min(labels, bands)[j])
    whole = gather_frames([label_components_block_kernel(bands)])
    rows = slice(j * hl, (j + 1) * hl + 3)
    t_ext = F.pad(tern, (0, 0, 1, 2), value=127)[:, rows].contiguous()
    l_ext = F.pad(whole, (0, 0, 1, 2), value=INVALID)[:, rows].contiguous()
    return bands[j], merged, t_ext, l_ext, j * hl


def band_kernel_times(spatial, calls: int = 10) -> dict[str, dict]:
    """Device us of every CUDA kernel inside one call of B6 (both entries)
    and B7 at the full-resolution band shapes of the row-banded step on
    the ``spatial`` scene (``band_kernel_inputs``), with its launches a
    call, and the whole call's CUDA-event us."""
    from chalkydri_tpu_torch.ops.extract_blocked import extract_candidates_band
    from chalkydri_tpu_torch.ops.propagate import (
        label_components_blocked,
        propagate_components_blocked,
    )

    t, m, t_ext, l_ext, y0 = band_kernel_inputs(spatial)
    cases = {f"B6 label_components_blocked {list(t.shape)}":
             lambda: label_components_blocked(t),
             f"B6 propagate_components_blocked {list(t.shape)}":
             lambda: propagate_components_blocked(t, m),
             f"B7 extract_candidates_band {list(t_ext.shape)}":
             lambda: extract_candidates_band(t_ext, l_ext, 1, 2, y0)}
    out = {}
    for name, fn in cases.items():
        kernels = device_times(fn, calls)
        out[name] = {"kernels": kernels,
                     "kernel_us_per_call": sum(k["us_per_call"]
                                               for k in kernels.values()),
                     "launches_per_call": sum(k["launches_per_call"]
                                              for k in kernels.values()),
                     "event_us_per_call": event_us(fn, calls)}
    return out


def device_share(step, frames, gyro, steps: int = 3) -> dict[str, float]:
    """Wall ms, device kernel ms (the kernels inside a CUDA graph's replay
    included) and the host's launches per step under the profiler: kernel
    launches (``cudaLaunchKernel``), graph launches (``cudaGraphLaunch``)
    and copies (``cudaMemcpyAsync``)."""
    from torch.profiler import ProfilerActivity, profile

    step(frames, gyro)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(steps):
            step(frames, gyro)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    events = prof.key_averages()
    device_us = sum(getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0))
                    for e in events if str(e.device_type).endswith("CUDA"))

    def host_calls(prefix):
        return sum(e.count for e in events if e.key.startswith(prefix)) / steps

    return {"wall_ms_per_step": wall_ms / steps,
            "device_ms_per_step": device_us / 1e3 / steps,
            "busy_share": device_us / 1e3 / wall_ms,
            "launches_per_step": host_calls("cudaLaunchKernel"),
            "graph_launches_per_step": host_calls("cudaGraphLaunch"),
            "copies_per_step": host_calls("cudaMemcpyAsync")}


def share_line(share: dict) -> str:
    return (f"{share['wall_ms_per_step']:.3f} ms wall, "
            f"{share['device_ms_per_step']:.3f} ms device kernels, busy "
            f"{100 * share['busy_share']:.2f} %, host launches per step: "
            f"{share['launches_per_step']:.0f} kernels, "
            f"{share['graph_launches_per_step']:.0f} graphs, "
            f"{share['copies_per_step']:.0f} copies")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", type=int, default=10)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("perfprobe: CUDA is not available")
    import subprocess

    from chalkydri_tpu_torch.detector.cluster import MAX_EDGE_POINTS
    from chalkydri_tpu_torch.parallel.mesh import make_mesh
    from chalkydri_tpu_torch.parallel.pipeline import (
        make_sharded_vision_pipeline,
    )
    from chalkydri_tpu_torch.pipeline import make_vision_pipeline
    from chalkydri_tpu_torch.tools.scenes import load_scene

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    report = {"card": card}
    rounds = ccl_round_times(
        load_scene("bench", dev)[3], load_scene("deployed", dev)[3])
    band = band_kernel_times(load_scene("spatial", dev)[3])
    for name, r in {**rounds, **band}.items():
        parts = ", ".join(f"{k} {v['launches_per_call']:.0f} x "
                          f"{v['us_per_call'] / v['launches_per_call']:.2f}"
                          for k, v in r["kernels"].items())
        print(f"{'ccl rounds ' if name.startswith(('B1', 'B4')) else ''}"
              f"{name}: "
              f"{parts} us; kernels "
              f"{r['kernel_us_per_call']:.1f} us, whole call "
              f"{r['event_us_per_call']:.1f} us [{card}]", flush=True)
    report["ccl rounds"] = rounds
    report["band kernels"] = band
    paths = (("qd2 bench", "bench", 2), ("qd1 bench", "bench", 1),
             ("qd1 deployed", "deployed", 1), ("spatial qd2", "spatial", 2),
             ("spatial qd1", "spatial", 1))
    for path, scene, qd in paths:
        layout, params, rc, frames, poses = load_scene(scene, dev)
        gyro = torch.tensor([p[2] for p in poses], dtype=torch.float32,
                            device=dev)
        if scene == "spatial":  # four row bands, all on this card
            banded, place = make_sharded_vision_pipeline(
                layout, params, rc, make_mesh([dev] * 4, space=4),
                spatial=True, detector_kwargs={"quad_decimate": qd})
            stages = band_stage_times(banded, place, frames, gyro, qd,
                                      MAX_EDGE_POINTS, args.runs)
            share = device_share(banded_eager(banded, place), frames, gyro)

            def replayed(f, g, banded=banded, place=place):
                return banded(*place(f, g))

            stages["whole step, replayed"] = _host_ms(
                lambda: replayed(frames, gyro), args.runs)
            replay = device_share(replayed, frames, gyro)
            rounds = banded.ccl_rounds().tolist()
            print(f"{path} seam rounds each frame ran: {rounds}", flush=True)
        else:
            step = make_vision_pipeline(layout, params, rc, device=dev,
                                        detector_kwargs={"quad_decimate": qd})
            stages = replayed_stage_ms(step, frames, gyro, args.runs)
            share = device_share(step.module, frames, gyro)
            stages["whole step, replayed"] = _host_ms(
                lambda: step(frames, gyro), args.runs)
            replay = device_share(step, frames, gyro)
        shape = "x".join(str(d) for d in frames.shape)
        for name, ms in stages.items():
            print(f"{path} {shape} {name}: {ms:.3f} ms", flush=True)
        print(f"{path} profiler, eager: {share_line(share)} [{card}]",
              flush=True)
        print(f"{path} profiler, replayed: {share_line(replay)} [{card}]",
              flush=True)
        report[path] = {"shape": shape, "stages_ms": stages, **share,
                        "replayed": replay}
    print(json.dumps(report))


if __name__ == "__main__":
    main()
