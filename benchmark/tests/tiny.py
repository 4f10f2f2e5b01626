"""One run of a tiny cell on the CPU, with an optional fault planted in the
App's step, for the tests (``python -m benchmark.tests.tiny --workload
tiny-saturate [--fault stale|half_batch|altered] --seconds 3``). Prints
the result line as ``run.py`` does, with the frames compared."""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402

FAULTS = ("stale", "half_batch", "altered", "shared_mount")


def plant(fault: str):
    """Wrap ``harness.build_app`` so every group's step carries ``fault``:
    ``stale`` returns its first output forever (its state unchanged),
    ``half_batch`` leaves camera 1 out (its outputs are camera 0's),
    ``altered`` moves every pose 1 cm in x where the step makes it;
    ``shared_mount`` swaps the cameras' mounts in the program and in the
    reference alike (``calibrate.shared_fault``)."""
    import torch

    from benchmark import compare, harness

    if fault == "shared_mount":
        from benchmark.calibrate import shared_fault

        build, reference = harness.build_app, compare.reference_outputs
        harness.build_app = lambda cfg, *a, **k: build(shared_fault(cfg),
                                                       *a, **k)
        compare.reference_outputs = lambda cfg, *a, **k: reference(
            shared_fault(cfg), *a, **k)
        return

    build = harness.build_app

    def faulty(step):
        first = []

        def stepped(frames, gyro):
            out = step(frames, gyro)
            if fault == "stale":
                if not first:
                    first.append(out)
                return first[0]
            if fault == "half_batch":
                idx = torch.zeros(frames.shape[0], dtype=torch.long)

                def take(x):
                    return x[idx.to(x.device)]
                return out._replace(
                    **{k: take(v) for k, v in out._asdict().items()
                       if k != "detections"},
                    detections=out.detections._replace(
                        **{k: take(v) for k, v in
                           out.detections._asdict().items()}))
            return out._replace(pose_x=out.pose_x + 0.01)
        return stepped

    def build_faulty(*args, **kwargs):
        app, comm = build(*args, **kwargs)
        for g in app.groups:
            g.step = faulty(g.step)
        return app, comm

    harness.build_app = build_faulty


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--trace", type=int, default=0)
    p.add_argument("--fault", choices=FAULTS)
    args = p.parse_args(argv)
    if args.fault:
        plant(args.fault)
    from benchmark.cell import run_cell

    r = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                 T_START, device="cpu")
    extra = r.pop("_extra")
    r["frames_compared"] = extra["frames_compared"]
    r["polled"] = [len(c.polled) for c in extra["obs"].cams]
    print(json.dumps(r))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
