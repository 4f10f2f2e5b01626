"""One run of one cell, from ``BENCHMARK.json``'s entry to the result line's
fields: everything a cell needs is found by name (its configuration in
``configs/``, its traffic mix in ``traffic/``, its limits in ``limits/``,
its per-layer readers in ``metrics/``)."""

from __future__ import annotations

import os
import sys

from benchmark import compare, harness
from benchmark.guard import check_no_jax
from benchmark.scene import make_scene
from benchmark.trace import Context, TraceData, load_module

# The traced stretch: the window's last TRACE_S seconds (the device runs
# ~6,300 kernels a step). Stopping the profiler stalls the host for
# seconds, so it stops after the window's last iteration, not inside it.
TRACE_S = 1.0


def load_cell(name: str, bench: dict | None = None) -> tuple:
    """(workload entry, configuration, traffic mix, limits) of cell
    ``name``."""
    bench = bench or harness.load_json(os.path.join(harness.ROOT,
                                                    "BENCHMARK.json"))
    cell = harness.find_cell(bench, name)
    cfg = harness.load_json(harness.find_file("configs", cell["config"]))
    traffic = harness.load_traffic(cell["traffic"], cell["config"])
    limits = harness.load_json(harness.find_file("limits", cell["config"]))
    return bench, cell, cfg, traffic, limits


def metrics_of(bench: dict, cell: dict, section: str) -> list:
    """The metrics of ``section`` that this cell reports."""
    out = []
    for m in bench[section]:
        cells = m.get("workloads")
        if cells is None or cell["name"] in cells:
            out.append(m)
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", bench: dict | None = None,
             log=sys.stderr) -> dict:
    """One run; returns the result line's fields (and ``_extra`` for the
    callers that calibrate limits)."""
    import torch

    bench, cell, cfg, traffic, limits = load_cell(name, bench)
    layout = os.path.join(harness.ROOT, cfg["field"])
    receiver = harness.Receiver()
    try:
        scene = make_scene(cfg, traffic, layout, seed)
        app, comm = harness.build_app(cfg, layout, device, receiver.port)
        cams = [harness.StandInCamera(scene.frames[i], cfg["width"],
                                      cfg["height"])
                for i in range(len(app.fused_chains))]
        for ch, cam in zip(app.fused_chains, cams):
            ch.camera = cam
        harness.gyro_handshake(comm, scene.heading)
        recorder = harness.Recorder(app, cams)
        tracer = None
        if trace:
            clock = harness.StepClock() if device != "cpu" else None
            harness.Instrument.install(app, cams, clock)
            tracer = harness.Tracer(device, clock)
        from chalkydri_tpu_torch.utils.tracing import SPANS

        if device != "cpu":
            torch.cuda.reset_peak_memory_stats()

        def arm_trace(t0):
            if tracer is not None:
                tracer.start_ns = t0 + round(max(0.0, seconds - TRACE_S)
                                             * 1e9)

        obs = harness.drive(app, cams, traffic, seconds, recorder,
                            tracer=tracer, spans=SPANS if trace else None,
                            on_window=arm_trace)
        setup_s = (obs.t0 / 1e9) - t_start
        steps = (tracer.clock.times()
                 if tracer is not None and tracer.clock is not None else None)
        from chalkydri_tpu_torch.io.whacknet import RobotPose, VisionUncertainty

        comm.publish(harness.STOP_ID, harness.STOP_ID, 0, RobotPose(),
                     VisionUncertainty())
        obs.packets = receiver.collect()
        peak = (int(torch.cuda.max_memory_allocated()) if device != "cpu"
                else 0)
        events = None
        if tracer is not None and tracer.prof is not None:
            events = tracer.events(os.path.join(
                os.environ.get("TMPDIR", "/tmp"),
                f"bench_trace_{os.getpid()}.json"))
        harness.release(app, comm)
        del app
    finally:
        receiver.close()
    check_no_jax("after the window")

    m = harness.match_packets(obs)
    matched = m["matched"]
    attempted, failed = harness.offered_counts(obs, matched)
    ref = compare.reference_outputs(cfg, scene, layout, device)
    gaps = compare.program_gaps(obs, matched, m["unmatched"], ref, scene)
    correct, checks = compare.judge(gaps.v, limits)
    if gaps.frames == 0:
        correct = False  # nothing was compared
    truth = compare.truth_gap_m(obs, matched, scene)
    lat = sorted(harness.latency_samples(obs, matched))
    in_app = sorted(m[6] / 1e3 for m in matched.values())

    def deciles(v):
        return [round(harness.percentile(v, q / 10), 3) for q in range(1, 10)]

    transit = sorted(m[-1] // 1000 - m[6] - p.due_ns // 1000
                     for c, cam in enumerate(obs.cams) for p in cam.polled
                     for m in [matched.get((c, p.n))] if m is not None)

    metrics = {}
    e2e = harness.end_to_end(obs, matched, seconds)
    print(f"# pose latency p50 {e2e['pose_latency_p50_ms']:.4f} ms, p95 "
          f"{e2e['pose_latency_p95_ms']:.4f} ms; frames/s "
          f"{e2e['frames_per_s']:.2f}", file=log, flush=True)
    if not trace:
        e2e["setup_s"] = setup_s
        for spec in metrics_of(bench, cell, "end_to_end"):
            metrics[spec["name"]] = {"value": e2e[spec["name"]],
                                     "unit": spec["unit"]}
    device_info = {"platform": "gpu" if device != "cpu" else "cpu",
                   "kind": (torch.cuda.get_device_name() if device != "cpu"
                            else "cpu"),
                   "count": 1, "memory_peak_bytes": peak}
    breakdown = None
    if trace:
        td = (TraceData.from_events(events, obs.steps_traced)
              if events is not None else None)
        ctx = Context(workload=cell, config=cfg, traffic=traffic, trace=td,
                      steps=steps, dispatch_ms=obs.dispatch_ms, scene=scene,
                      device=device)
        for spec in metrics_of(bench, cell, "per_layer"):
            value = load_module("metrics", spec["name"]).read(ctx)
            if value is not None:
                metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
        if td is not None:
            own = sorted({k[0] for k in td.kernels
                          if k[0].startswith(("(anonymous namespace)::",
                                              "void (anonymous namespace)::"))})
            print(f"# traced {td.steps} steps in {td.window_s:.3f} s; "
                  f"hand-written kernels seen: {own}", file=log, flush=True)
            device_info["busy_s"] = td.busy_s()
            device_info["window_s"] = td.window_s
            breakdown = {"device_ops": [list(x) for x in td.top_ops()],
                         "idle_gaps": ([list(x) for x in steps.idle_gaps()[:10]]
                                       if steps is not None else [])}
            print(f"# profiled stretch: device idle "
                  f"{100 * (1 - td.busy_s() / td.window_s):.2f} % (the "
                  f"profiler slows the graph's launch)", file=log, flush=True)
        if steps is not None:
            by_host: dict = {}
            for label, sec in steps.idle_gaps():
                by_host[label] = by_host.get(label, 0.0) + sec
            print(f"# untraced stretch, CUDA events: {len(steps.starts)} "
                  f"dispatches in {steps.window_ms() / 1e3:.3f} s, device idle "
                  f"{steps.idle_pct():.2f} %; a dispatch's device ms, deciles "
                  f"{deciles(sorted(steps.step_ms()))}; idle s by host range "
                  f"{by_host}", file=log, flush=True)
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    result["_extra"] = {"obs": obs, "matched": matched, "scene": scene,
                        "ref": ref, "cfg": cfg, "layout": layout,
                        "truth_gap_m": truth, "frames_compared": gaps.frames,
                        "packets": len(obs.packets)}
    print(f"# {name} seed {seed}: {attempted} frames offered, {failed} "
          f"without a pose packet, {gaps.frames} compared; largest distance "
          f"from the rendered pose {truth:.5f} m; publish to arrival us "
          f"p50 {harness.percentile(transit, 0.5) if transit else None}, "
          f"max {transit[-1] if transit else None}; latency deciles ms "
          f"{deciles(lat)}, of them in the App (packet field) "
          f"{deciles(in_app) if in_app else None}", file=log, flush=True)
    return result
