"""The sweep that sets a ``live`` cell's camera rate: one App, one window a
rate, each camera free-running at that rate, half a period apart; the
traffic's settling stretch runs once, before the first rate.

    python3 -m benchmark.sweep --workload comp2-qd2-live --rates 30,34,38 \
        --seconds 4 --seed 11

For each rate it prints, as one JSON line, the frames offered and
skipped (replaced before the App polled them), the latency p50 and p95,
and the p50 of the window's first and last quarter (by due time). A
rate is sustained when no frame is skipped, the last quarter's latency
is not above the first's by more than ``GROWTH``, and the p50 is not
above the lowest rate's by more than ``GROWTH``: past that rate a frame
no longer gets a step of its own but waits for the other camera's (the
App then batches both, which keeps up, at twice the latency). The knee
is the highest rate at which it and every lower rate are sustained; the
cell's rate is four fifths of it, rounded down, and at most the
configuration's ``max_frame_rate``. Needs a CUDA card; not part of a
benchmark run.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

GROWTH = 1.25  # a p50 over the first quarter's, or the lowest rate's


def quarter_p50s(obs, matched) -> tuple:
    from benchmark.harness import percentile

    q = (obs.t_end - obs.t0) / 4
    first, last = [], []
    for c, cam in enumerate(obs.cams):
        for n, _, due in cam.offered():
            got = matched.get((c, n))
            lat = (got[-1] - due) / 1e6 if got else math.inf
            if due < obs.t0 + q:
                first.append(lat)
            elif due >= obs.t_end - q:
                last.append(lat)
    return percentile(first, 0.5), percentile(last, 0.5)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark.sweep")
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True, help="camera fps, comma-separated")
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--seed", type=int, default=11)
    args = p.parse_args(argv)

    from benchmark import harness
    from benchmark.cell import load_cell
    from benchmark.scene import make_scene

    _, cell, cfg, traffic, _ = load_cell(args.workload)
    layout = os.path.join(harness.ROOT, cfg["field"])
    receiver = harness.Receiver()
    windows = []
    try:
        scene = make_scene(cfg, traffic, layout, args.seed)
        app, comm = harness.build_app(cfg, layout, "cuda", receiver.port)
        cams = [harness.StandInCamera(scene.frames[i], cfg["width"],
                                      cfg["height"])
                for i in range(len(app.fused_chains))]
        for ch, cam in zip(app.fused_chains, cams):
            ch.camera = cam
        harness.gyro_handshake(comm, scene.heading)
        recorder = harness.Recorder(app, cams)
        for i, rate in enumerate(float(r) for r in args.rates.split(",")):
            mix = dict(traffic, arrivals="free_running", rate_fps=rate,
                       settle_s=traffic.get("settle_s", 0.0) if i == 0 else 0)
            obs = harness.drive(app, cams, mix, args.seconds, recorder)
            windows.append((rate, obs, [list(c.offered()) for c in cams],
                            [list(c.polled) for c in cams]))
        from chalkydri_tpu_torch.io.whacknet import RobotPose, VisionUncertainty

        comm.publish(harness.STOP_ID, harness.STOP_ID, 0, RobotPose(),
                     VisionUncertainty())
        packets = receiver.collect()
        harness.release(app, comm)
    finally:
        receiver.close()
    best, base, held = None, None, True
    for rate, obs, offered, polled in windows:
        for cam, off, pol in zip(obs.cams, offered, polled):
            cam.polled = pol
            cam.offered = (lambda o=off: o)
        obs.packets = packets
        matched = harness.match_packets(obs)["matched"]
        lat = harness.latency_samples(obs, matched)
        n_off = sum(len(o) for o in offered)
        skipped = n_off - sum(len(p) for p in polled)
        first, last = quarter_p50s(obs, matched)
        p50 = harness.percentile(lat, 0.5)
        base = p50 if base is None else base
        ok = skipped == 0 and last <= GROWTH * first and p50 <= GROWTH * base
        held = held and ok
        if held:
            best = rate
        print(json.dumps({
            "workload": args.workload, "rate_fps": rate, "offered": n_off,
            "skipped": skipped,
            "p50_ms": p50,
            "p95_ms": harness.percentile(lat, 0.95),
            "first_quarter_p50_ms": first, "last_quarter_p50_ms": last,
            "sustained": ok}), flush=True)
    cap = float(cfg.get("max_frame_rate", math.inf))
    if best is not None:
        print(json.dumps({"workload": args.workload, "knee_fps": best,
                          "rate_fps": min(cap, math.floor(0.8 * best))}))
    print(f"# card: {harness.card_line()}; set-up to the first window "
          f"{windows[0][1].t0 / 1e9 - T_START:.1f} s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
