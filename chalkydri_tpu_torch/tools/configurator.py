"""Configurator: camera discovery, config mapping, graph generation, and the
live calibration driver (port of ``chalkydri_tpu/tools/configurator.py``).

Rebuild of the reference's ``crates/configurator/src/main.rs``:

- ``configure``: discover cameras (hotplug provider), map device ids to
  named camera configs, pick capture settings, set cam_id / mount offsets
  (main.rs:228-304). Interactive (stdin prompts) or scriptable via flags.
- ``generate``: synthesize the RON task graph from the mapping — one
  CamPipeline -> GstToCuImage -> AprilTags chain per camera wired to the
  shared comm resource (``save_cuconfig``, main.rs:126-223). Unlike the
  reference, the generated graph is loaded at startup, no rebuild needed.
- ``calibrate N``: drive a live Copper-style loop collecting N aprilgrid
  frames through the Calibrator sink, then solve intrinsics
  (main.rs:306-417, tools/calibration.py) and store the calib JSON in the
  camera config. The detector and the solve run on ``--device`` (default
  ``cuda``; a machine without a card needs ``--device cpu``).

State lives in ``configurator.json`` like the reference (main.rs:571-592).

Run:  python -m chalkydri_tpu_torch.tools.configurator [--state F]
      [--device cuda|cpu] configure|generate|calibrate ...
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from dataclasses import asdict, dataclass, field
from typing import Optional

STATE_FILE = "configurator.json"


@dataclass
class CamConfigEntry:
    name: str = ""
    device_id: str = ""
    width: int = 1280
    height: int = 800
    cam_id: int = 0
    calib: Optional[str] = None  # embedded calib JSON
    robot_to_cam: dict = field(
        default_factory=lambda: {
            "roll": 0.0, "pitch": 0.0, "yaw": 0.0, "x": 0.0, "y": 0.0, "z": 0.0
        }
    )


@dataclass
class ConfiguratorState:
    cameras: dict = field(default_factory=dict)  # name -> CamConfigEntry dict

    @staticmethod
    def load(path: str = STATE_FILE) -> "ConfiguratorState":
        if os.path.exists(path):
            with open(path) as f:
                return ConfiguratorState(**json.load(f))
        return ConfiguratorState()

    def save(self, path: str = STATE_FILE) -> None:
        with open(path, "w") as f:
            json.dump(asdict(self), f, indent=2)

    def entry(self, name: str) -> CamConfigEntry:
        d = self.cameras.get(name, {})
        return CamConfigEntry(**d)

    def put(self, name: str, entry: CamConfigEntry) -> None:
        self.cameras[name] = asdict(entry)


def generate_graph(state: ConfiguratorState):
    """save_cuconfig parity (main.rs:126-223): per camera, nodes
    camera_{name} / gst_to_cu_{name} / apriltags_{name} + typed edges +
    the shared comm resource."""
    from chalkydri_tpu_torch.runtime.graph import Edge, ResourceDecl, TaskGraph, TaskNode

    tasks, edges = [], []
    for name, d in sorted(state.cameras.items()):
        e = CamConfigEntry(**d)
        cam = f"camera_{name}"
        cvt = f"gst_to_cu_{name}"
        apr = f"apriltags_{name}"
        tasks.append(
            TaskNode(
                id=cam, type="CamPipeline",
                config={"id": e.device_id, "name": e.name or name,
                        "width": e.width, "height": e.height},
            )
        )
        tasks.append(
            TaskNode(
                id=cvt, type="GstToCuImage",
                config={"width": e.width, "height": e.height, "fourcc": "GREY"},
            )
        )
        cfg = {
            "cam_id": e.cam_id,
            "robot_to_cam": json.dumps(e.robot_to_cam, indent=2),
        }
        if e.calib:
            cfg["calib"] = e.calib
        tasks.append(
            TaskNode(
                id=apr, type="chalkydri_apriltags::AprilTags",
                config=cfg, resources={"comm": "comm.comm"},
            )
        )
        edges.append(Edge(cam, cvt, "(CuGstBuffer, CuDuration)"))
        edges.append(Edge(cvt, apr, "(CuImage<Vec<u8>>, CuDuration)"))
    return TaskGraph(
        tasks=tasks, edges=edges,
        resources=[ResourceDecl(id="comm", provider="whacknet::CommBundle")],
    )


def _print_caps(caps: list[dict]) -> None:
    """Device caps listing like the reference's caps picker
    (configurator/src/main.rs:518-568)."""
    for j, c in enumerate(caps):
        fps = "/".join(str(f) for f in c["fps"]) or "?"
        print(f"    ({j}) {c['format']} {c['width']}x{c['height']} @ {fps} fps")


def _ask(prompt: str, default: str = "") -> str:
    """One stdin prompt with a default (shown in brackets)."""
    suffix = f" [{default}]" if default else ""
    try:
        got = input(f"{prompt}{suffix}: ").strip()
    except EOFError:
        return default
    return got or default


def _ask_num(prompt: str, default, cast):
    """Numeric prompt that RE-PROMPTS on a typo instead of aborting the
    session (the reference's dialoguer inputs validate the same way);
    EOF returns the default."""
    while True:
        got = _ask(prompt, str(default))
        try:
            return cast(got)
        except ValueError:
            print(f"  not a number: {got!r} — try again", file=sys.stderr)
            # EOF inside _ask returns the default, which always casts;
            # only a real typed line can loop here.


def _interactive_session(state: ConfiguratorState, args) -> int:
    """Guided operator flow, the reference's dialoguer session
    (configurator/src/main.rs:55-593): per camera — pick/enter a device,
    pick caps from the device's own query (main.rs:518-568), set
    cam_id/offsets, optionally calibrate inline — then optionally emit
    the RON graph. Stdlib prompts driving the SAME state/commands as the
    flag path, so both emit identical graphs (tested)."""
    from chalkydri_tpu_torch.io.camera import PROVIDER, query_caps

    PROVIDER.refresh()
    devices = PROVIDER.devices()
    dev_list = sorted(devices.items())
    if dev_list:
        print("cameras found:")
        for i, (dev_id, node) in enumerate(dev_list):
            print(f"[{i}] {dev_id} ({node})")
    else:
        print("no cameras found — enter device paths manually")

    while True:
        name = _ask("camera name (empty to finish)")
        if not name:
            break
        dev = _ask("device (index from the list, /dev/videoN, or bus id)")
        if dev.isdigit() and int(dev) < len(dev_list):
            dev_id, node = dev_list[int(dev)]
        else:
            dev_id, node = dev, devices.get(dev, dev)
        caps = query_caps(node)
        print(f"  caps of {dev_id}:")
        _print_caps(caps)
        pick = _ask("caps (index, or empty to type WxH)")
        entry = state.entry(name)
        entry.name, entry.device_id = name, dev_id
        if pick.isdigit() and int(pick) < len(caps):
            c = caps[int(pick)]
            entry.width, entry.height = int(c["width"]), int(c["height"])
        else:
            entry.width = _ask_num("width", entry.width, int)
            entry.height = _ask_num("height", entry.height, int)
        entry.cam_id = _ask_num("cam_id (wire id, 0-255)", entry.cam_id, int)
        if _ask("set robot->camera offsets? (y/N)", "n").lower().startswith("y"):
            for k in ("x", "y", "z", "roll", "pitch", "yaw"):
                entry.robot_to_cam[k] = _ask_num(
                    f"  {k} (m or deg)", entry.robot_to_cam[k], float)
        state.put(name, entry)
        state.save(args.state)
        print(f"configured camera {name!r} -> {entry.device_id} "
              f"{entry.width}x{entry.height} cam_id={entry.cam_id}")
        if _ask("calibrate this camera now? (y/N)", "n").lower().startswith("y"):
            import types

            rc = cmd_calibrate(types.SimpleNamespace(
                state=args.state, name=name, frames=20, timeout=120.0,
                allow_synthetic=False, viz_port=None,
                compute_device=args.compute_device,
            ))
            if rc != 0:
                print("calibration failed; continuing", file=sys.stderr)
            state = ConfiguratorState.load(args.state)  # pick up calib

    if state.cameras and _ask(
            "generate chalkydri.ron now? (y/N)", "n").lower().startswith("y"):
        out = _ask("output path", "chalkydri.ron")
        graph = generate_graph(state)
        with open(out, "w") as f:
            f.write(graph.dumps())
        print(f"wrote {out} ({len(graph.tasks)} tasks, "
              f"{len(graph.edges)} edges)")
    return 0


def cmd_configure(args) -> int:
    from chalkydri_tpu_torch.io.camera import PROVIDER, SYNTHETIC_CAPS, query_caps

    state = ConfiguratorState.load(args.state)
    if getattr(args, "interactive", False):
        return _interactive_session(state, args)
    PROVIDER.refresh()
    devices = PROVIDER.devices()
    if not devices:
        print("no cameras found", file=sys.stderr)
    for i, (dev_id, node) in enumerate(sorted(devices.items())):
        print(f"[{i}] {dev_id} ({node})")
        _print_caps(query_caps(node))

    if args.name and args.device is not None:
        entry = state.entry(args.name)
        entry.name = args.name
        entry.device_id = args.device
        node = devices.get(args.device, args.device)
        caps = query_caps(node) if os.path.exists(node) else list(SYNTHETIC_CAPS)
        if args.width:
            entry.width = args.width
        if args.height:
            entry.height = args.height
        # Validate the chosen geometry against the device's actual caps
        # (synthetic caps accept anything in CI / absent-device flows).
        is_synthetic = all(c["format"] == "SYNT" for c in caps)
        if not is_synthetic and not any(
            c["width"] == entry.width and c["height"] == entry.height
            for c in caps
        ):
            print(
                f"warning: {entry.width}x{entry.height} not in device caps; "
                "supported:", file=sys.stderr,
            )
            _print_caps(caps)
        if args.cam_id is not None:
            entry.cam_id = args.cam_id
        if args.offsets:
            entry.robot_to_cam = json.loads(args.offsets)
        state.put(args.name, entry)
        state.save(args.state)
        print(f"configured camera {args.name!r} -> {args.device}")
        return 0

    # interactive fallback
    try:
        name = input("camera name: ").strip()
        dev = input("device id (from the list above or /dev/videoN): ").strip()
        cam_id = int(input("cam_id (wire id, 0-255): ").strip() or "0")
    except EOFError:
        print("non-interactive and no --name/--device given", file=sys.stderr)
        return 2
    entry = state.entry(name)
    entry.name, entry.device_id, entry.cam_id = name, dev, cam_id
    state.put(name, entry)
    state.save(args.state)
    return 0


def cmd_generate(args) -> int:
    state = ConfiguratorState.load(args.state)
    graph = generate_graph(state)
    out = args.output or "chalkydri.ron"
    with open(out, "w") as f:
        f.write(graph.dumps())
    print(f"wrote {out} ({len(graph.tasks)} tasks, {len(graph.edges)} edges)")
    return 0


def cmd_calibrate(args) -> int:
    """Collect N board frames from the named camera and solve intrinsics
    (main.rs:306-417)."""
    import numpy as np

    from chalkydri_tpu_torch.io.camera import CamPipeline, PROVIDER
    from chalkydri_tpu_torch.runtime.clock import RobotClock
    from chalkydri_tpu_torch.tools.calibration import Calibrator

    state = ConfiguratorState.load(args.state)
    entry = state.entry(args.name) if args.name else None
    if entry is None or not entry.device_id:
        print("configure the camera first", file=sys.stderr)
        return 2

    PROVIDER.refresh()
    clock = RobotClock()
    cam = CamPipeline(
        {"id": entry.device_id, "name": entry.name,
         "width": entry.width, "height": entry.height},
        synthetic_ok=args.allow_synthetic,
    )
    cam.start(clock)

    # Live calibration view (corner coverage + reprojection progress) —
    # the reference's rerun stream (calibration.rs:91-98), served as MJPEG.
    monitor = viz_server = None
    if args.viz_port is not None:
        from chalkydri_tpu_torch.io.mjpeg import MjpegServer
        from chalkydri_tpu_torch.subsystems.calib_viz import CalibrationMonitor

        monitor = CalibrationMonitor()
        viz_server = MjpegServer(monitor.ring, port=args.viz_port)
        viz_server.start()
        print(f"calibration view: http://0.0.0.0:{viz_server.port}/stream",
              file=sys.stderr)
    calib = Calibrator(monitor=monitor, device=args.compute_device)
    collected = 0
    import time

    deadline = time.time() + args.timeout
    while collected < args.frames and time.time() < deadline:
        msg = cam.process(clock)
        if msg.payload is None:
            time.sleep(0.01)
            continue
        if calib.process_frame(np.asarray(msg.payload)):
            collected += 1
            print(f"\rframes: {collected}/{args.frames}", end="", flush=True)
    print()
    cam.stop(clock)
    if viz_server is not None and collected < 3:
        viz_server.stop()
    if collected < 3:
        print("not enough board views", file=sys.stderr)
        return 1
    result = calib.calibrate()
    model = result.to_model(entry.width, entry.height,
                            device=args.compute_device)
    entry.calib = model.to_json()
    state.put(args.name, entry)
    state.save(args.state)
    print(f"calibrated {args.name}: rms={result.rms_px:.3f}px over "
          f"{result.n_frames} frames")
    print(entry.calib)
    if viz_server is not None:
        viz_server.stop()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="chalkydri-configurator")
    p.add_argument("--state", default=STATE_FILE)
    p.add_argument("--device", dest="compute_device", default="cuda",
                   help="torch device of the detector and the solve "
                        "(default: cuda; cpu without a card)")
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("configure", help="map devices to camera configs")
    c.add_argument("--interactive", action="store_true",
                   help="guided session: pick camera + caps from the "
                        "device query, set offsets, optional calibration "
                        "(the reference's dialoguer flow)")
    c.add_argument("--name")
    c.add_argument("--device")
    c.add_argument("--width", type=int, default=0)
    c.add_argument("--height", type=int, default=0)
    c.add_argument("--cam-id", dest="cam_id", type=int)
    c.add_argument("--offsets", help="robot_to_cam JSON")
    c.set_defaults(fn=cmd_configure)

    g = sub.add_parser("generate", help="write the RON task graph")
    g.add_argument("--output")
    g.set_defaults(fn=cmd_generate)

    k = sub.add_parser("calibrate", help="collect board frames + solve intrinsics")
    k.add_argument("frames", type=int, nargs="?", default=20)
    k.add_argument("--name")
    k.add_argument("--timeout", type=float, default=120.0)
    k.add_argument("--allow-synthetic", action="store_true")
    k.add_argument("--viz-port", dest="viz_port", type=int, default=None,
                   help="serve live calibration coverage view (MJPEG)")
    k.add_argument("--device", dest="compute_device", default=argparse.SUPPRESS,
                   help="as the top-level --device")
    k.set_defaults(fn=cmd_calibrate)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
