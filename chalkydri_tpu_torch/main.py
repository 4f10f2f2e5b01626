"""chalkydri-tpu entrypoint on PyTorch and CUDA (port of
``chalkydri_tpu/main.py``).

Port of the reference main (``crates/chalkydri/src/main.rs:49-114``):
banner, TOML config with /boot -> /etc -> ./ fallback, graph load (RON),
unified logger, app loop. The Pi-specific kernel-module eviction and
GStreamer init have no counterpart; device init is the torch device named
by ``--device`` (the card unless the caller asks for the CPU). There is no
compile cache to configure: the CUDA kernels build once per source digest
into ``chalkydri_tpu_torch/_build/`` (``ops/build.py``).

Run:  python -m chalkydri_tpu_torch.main [--graph chalkydri.ron]
      [--config path] [--field field.json] [--iters N] [--rate HZ]
      [--log chalkydri.ctlog] [--device cuda] [--robot-addr HOST[:PORT]]
"""

from __future__ import annotations

import argparse
import sys

BANNER = r"""
        chalkydri-tpu (PyTorch/CUDA)
   multi-camera AprilTag vision on the GPU
"""


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="chalkydri-tpu-torch", description=__doc__)
    p.add_argument("--graph", default="chalkydri.ron", help="RON task graph")
    p.add_argument("--config", default=None, help="TOML config path")
    p.add_argument("--field", default=None, help="field.json path")
    p.add_argument("--iters", type=int, default=None, help="stop after N iterations")
    p.add_argument("--rate", type=float, default=None, help="iteration rate cap (Hz)")
    p.add_argument("--log", default=None, help="unified log output path")
    p.add_argument("--mjpeg-port", type=int, default=None,
                   help="serve a driver-station MJPEG preview on this port")
    p.add_argument("--no-synthetic", action="store_true",
                   help="fail instead of synthesizing frames for absent cameras")
    p.add_argument("--robot-addr", default=None,
                   help="send pose packets to HOST[:PORT] (default: the "
                        "team's roboRIO, 10.TE.AM.2:7001), e.g. a simulator")
    p.add_argument("--device", default="cuda",
                   help="torch device of the vision steps (default cuda; "
                        "raises when no card is visible)")
    args = p.parse_args(argv)

    import torch

    from chalkydri_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)

    print(BANNER, file=sys.stderr)

    from chalkydri_tpu_torch.io.camera import PROVIDER
    from chalkydri_tpu_torch.io.config import Cfg, Config
    from chalkydri_tpu_torch.io.whacknet import DEFAULT_SEND_PORT, Comm
    from chalkydri_tpu_torch.runtime.app import App
    from chalkydri_tpu_torch.runtime.graph import TaskGraph
    from chalkydri_tpu_torch.runtime.logging import UnifiedLogger

    # Config: explicit path or the reference's fallback chain (main.rs:76-87).
    config = Config.load(args.config) if args.config else Config.load_with_fallback()
    Cfg.write(config)

    graph = TaskGraph.load(args.graph)

    layout = None
    if args.field:
        from chalkydri_tpu_torch.geometry.field_layout import load_field_layout

        layout = load_field_layout(args.field, dtype=torch.float32,
                                   device=device)

    logger = UnifiedLogger(args.log, meta={"graph": args.graph}) if args.log else None

    PROVIDER.start()
    detector_kwargs = {}
    if any(
        cam.subsystems.capriltags is not None
        and getattr(cam.subsystems.capriltags, "capacity_fallback", False)
        for cam in (config.cameras or [])
    ):
        # TOML-configured texture-flood recovery (io/config.py
        # CAprilTagsSubsys.capacity_fallback -> App capacity redispatch).
        detector_kwargs["capacity_fallback"] = True
    comm = None
    if args.robot_addr:
        host, _, port = args.robot_addr.partition(":")
        comm = Comm(remote_addr=host,
                    remote_port=int(port) if port else DEFAULT_SEND_PORT)
    mjpeg_server = None
    try:
        app = App(
            graph,
            comm=comm,
            field_layout=layout,
            team_number=config.team_number,
            synthetic_cameras=not args.no_synthetic,
            logger=logger,
            detector_kwargs=detector_kwargs,
            ntables_ip=config.ntables_ip,
            device_name=config.device_name or "chalkydri-tpu",
            mesh=config.mesh,
            device=device,
        )

        # Driver-station MJPEG preview (the reference's MjpegProc/Monitor
        # role): enabled by --mjpeg-port or any camera's mjpeg subsystem
        # config.
        wants_mjpeg = args.mjpeg_port is not None or any(
            cam.subsystems.mjpeg is not None for cam in (config.cameras or [])
        )
        if wants_mjpeg:
            from chalkydri_tpu_torch.io.mjpeg import MjpegServer
            from chalkydri_tpu_torch.subsystems.field_view import FieldView
            from chalkydri_tpu_torch.subsystems.overlay import PreviewOverlay

            overlay = PreviewOverlay()
            app.add_frame_observer(overlay.on_frame)
            app.add_detection_observer(overlay.on_detections)
            # Top-down field view (tag layout + pose trace + frusta) at
            # /field — the rerun 3D-state parity surface (monitor.rs:22-31).
            field_view = FieldView(layout=layout)
            app.add_pose_observer(field_view.on_pose)
            mjpeg_server = MjpegServer(
                {"/stream": overlay.ring, "/field": field_view.ring},
                port=args.mjpeg_port or 8080,
            )
            mjpeg_server.start()
            print(
                f"MJPEG preview: http://0.0.0.0:{mjpeg_server.port}/stream | "
                f"field view: http://0.0.0.0:{mjpeg_server.port}/field",
                file=sys.stderr,
            )

        try:
            app.run(max_iters=args.iters, rate_hz=args.rate)
        except KeyboardInterrupt:
            pass
    finally:
        if logger:
            logger.close()
        if mjpeg_server is not None:
            mjpeg_server.stop()
        PROVIDER.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
