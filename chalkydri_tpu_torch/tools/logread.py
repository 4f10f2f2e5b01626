"""logread: unified-log export CLI (port of ``chalkydri_tpu/tools/logread.py``).

Port of the reference's ``logread`` binary (``src/bin/logread.rs:1-9``:
Copper unified-log export): dump a .ctlog session as JSON lines, extract
frames to PNGs (needs cv2), or replay frames through the detector on
``--device`` (default ``cuda``).

Run:  python -m chalkydri_tpu_torch.tools.logread dump session.ctlog
      python -m chalkydri_tpu_torch.tools.logread frames session.ctlog --out dir/
      python -m chalkydri_tpu_torch.tools.logread replay session.ctlog [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def cmd_dump(args) -> int:
    from chalkydri_tpu_torch.runtime.logging import read_log

    for rec in read_log(args.log):
        out = dict(rec)
        if rec["kind"] == "frame":
            out["frame"] = f"<{rec['frame'].shape[0]}x{rec['frame'].shape[1]} u8>"
        elif rec["kind"] == "pose":
            p, s = rec["pose"], rec["std"]
            out["pose"] = {"x": p.x, "y": p.y, "rot": p.rot}
            out["std"] = {"x": s.x, "y": s.y, "rot": s.rot}
        print(json.dumps(out, default=str))
    return 0


def cmd_frames(args) -> int:
    try:
        import cv2
    except ImportError:
        print("logread frames writes PNGs with OpenCV (cv2), which is not "
              "installed", file=sys.stderr)
        return 2

    from chalkydri_tpu_torch.runtime.logging import replay_frames

    os.makedirs(args.out, exist_ok=True)
    n = 0
    for cam, tov, frame in replay_frames(args.log):
        cv2.imwrite(os.path.join(args.out, f"cam{cam}_{n:06d}.png"), frame)
        n += 1
    print(f"wrote {n} frames to {args.out}")
    return 0


def cmd_replay(args) -> int:
    """Re-run logged frames through the detector on ``--device`` (offline
    debugging, the record/replay loop of SURVEY.md section 5.4): one JSON
    line per frame record, its ids in slot order."""
    import numpy as np
    import torch

    from chalkydri_tpu_torch.detector.pipeline import make_detector
    from chalkydri_tpu_torch.runtime.logging import replay_frames
    from chalkydri_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(args.device)
    detect = make_detector(device=dev)
    n = 0
    t0 = time.perf_counter()
    for cam, tov, frame in replay_frames(args.log):
        h = (frame.shape[0] + 7) // 8 * 8
        w = (frame.shape[1] + 7) // 8 * 8
        buf = np.full((h, w), 127, np.uint8)
        buf[: frame.shape[0], : frame.shape[1]] = frame
        out = detect(torch.from_numpy(buf)[None].to(dev))
        ids = [int(i) for i in out.ids[0].cpu().numpy() if i >= 0]
        print(json.dumps({"cam": cam, "tov_us": tov, "ids": ids}))
        n += 1
    wall = time.perf_counter() - t0
    print(f"# replayed {n} frames in {wall:.3f} s "
          f"({n / max(wall, 1e-9):.1f} frames/s)", file=sys.stderr)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="logread")
    sub = p.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("dump")
    d.add_argument("log")
    d.set_defaults(fn=cmd_dump)
    f = sub.add_parser("frames")
    f.add_argument("log")
    f.add_argument("--out", default="frames")
    f.set_defaults(fn=cmd_frames)
    r = sub.add_parser("replay")
    r.add_argument("log")
    r.add_argument("--device", default="cuda",
                   help="torch device of the detector (default: cuda; cpu "
                        "without a card)")
    r.set_defaults(fn=cmd_replay)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
