"""The application runtime: graph -> batched execution loop on the torch
step (port of ``chalkydri_tpu/runtime/app.py``).

Replaces the reference's compile-time Copper app (``#[copper_runtime]``,
``crates/chalkydri/src/main.rs:45-46``) with a runtime-loaded graph and the
batched execution model from SURVEY.md section 1: the per-camera chains
(CamPipeline -> GstToCuImage -> AprilTags) collapse into ONE batched device
step per iteration and geometry group (``pipeline.make_vision_pipeline``,
on a card one replay of its CUDA graph, ``utils/graph.py``);
remaining tasks (monitor, calibrator, adapters, custom subsystems) run as
ordinary host tasks around it.

Latency discipline parity (pipeline.rs:344-392, apriltags/src/lib.rs:293-379):
- non-blocking latest-frame polls; a camera with no fresh frame simply does
  not publish this iteration,
- every frame carries its arrival Tov; the wire packet's ts field is the
  detect-time latency ``now - tov`` in microseconds (lib.rs:351),
- cameras with no detections heartbeat a zero pose at most every >5 ms
  (lib.rs:365-376).

Host <-> card traffic per group and iteration: the staged uint8 batch goes
up once from pinned memory (``non_blocking``), and right after the step is
queued ONE packed copy of the per-camera scalars comes back into pinned
memory, followed by a CUDA event. The publish path waits on that event
only, never on the whole stream, so with ``pipeline_depth=1`` the host
publishes step N-1 while step N runs.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from chalkydri_tpu_torch.io.whacknet import Comm, RobotPose, VisionUncertainty
from chalkydri_tpu_torch.runtime.clock import RobotClock, Stamped
from chalkydri_tpu_torch.runtime.graph import TaskGraph
from chalkydri_tpu_torch.runtime.tasks import REGISTRY, ResourceManager
from chalkydri_tpu_torch.utils import tracing
from chalkydri_tpu_torch.utils.platform import resolve_device

FUSED_SINK_TYPES = {"AprilTags", "chalkydri_apriltags::AprilTags"}
CAMERA_TYPES = {"CamPipeline"}
HEARTBEAT_MS = 5  # apriltags/src/lib.rs:367
_log = logging.getLogger(__name__)


@dataclass
class FusedChain:
    """One camera chain folded into its group's batch."""

    camera: "object"  # CamPipeline (imported lazily to avoid a cycle)
    sink_cfg: dict
    cam_id: int
    batch_index: int  # index within the group's batch
    group: int = 0  # index into App.groups
    last_tov: Optional[int] = None
    fresh: bool = False
    last_heartbeat_ms: Optional[int] = None
    aaec: "object" = None  # per-camera ExposureController when AAEC is on


@dataclass
class FusedGroup:
    """One batched device step: the cameras sharing a frame geometry AND a
    detector config (family, bits_corrected) batch together.

    The reference configures family/bits per camera task
    (``crates/apriltags/src/lib.rs:227-233``); a mixed 36h11/16h5 rig must
    not decode the wrong family, and a 640x480 camera in a 1600x1304 rig
    must not pay the big camera's detect cost, so heterogeneous rigs run
    one step per group. Homogeneous rigs (the common case) collapse to a
    single group.
    """

    step: "object"
    chains: list
    frames_host: torch.Tensor  # [B_group, H, W] uint8 staging (pinned on a card)
    frames_buf: np.ndarray  # numpy view of frames_host: the capture canvas
    frame_w: int
    frame_h: int
    family: str
    bits_corrected: int
    device: torch.device  # where the step takes its frames (a grid's first)
    # Optional 2x-candidate-budget step for capacity redispatch
    # (detector_kwargs capacity_fallback=True): when an iteration's
    # standard step reports dropped_points, the SAME uploaded frames
    # re-run on this one. None = warn-only (default). ``step_big_ready``
    # is set by the background warm-up (start_all_tasks): until it is set,
    # overflowed iterations keep the standard result + warning.
    step_big: "object" = None
    step_big_ready: "object" = None  # threading.Event when step_big set
    # The CUDA event after the last upload of frames_host: the next poll
    # waits on it before writing the buffer again.
    upload_done: "object" = None


class _HostCopy(NamedTuple):
    """A step's per-camera scalars (and, with detection observers, its
    detections; on a card its stage stamps) on their way to host memory;
    ``event`` (None on the CPU) completes when they have landed."""

    small: torch.Tensor  # [B, 9] int32 (_start_fetch's packing)
    dets: Optional[tuple]  # (ids, corners, margins, valid) or None
    event: Optional[torch.cuda.Event]
    stamps: Optional[tuple] = None  # (pinned int64 stamps, their card)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class App:
    """Build from a TaskGraph (RON surface) + runtime Config.

    Mirrors ``App::new(clock, unified_logger)`` + ``run()`` /
    ``run_one_iteration()`` (main.rs:108-111; the calibration driver uses
    run_one_iteration, configurator/src/main.rs:401-406).

    ``device`` is where the steps run: the card by default; a CUDA device
    on a machine without one raises (``utils/platform.resolve_device``),
    nothing moves to the CPU unless the caller passes ``device="cpu"``.

    A ``[mesh]`` of ``data x space`` takes that many distinct CUDA cards
    (``cuda:0`` .. ``cuda:{n-1}``) for a CUDA App, and falls back to the
    single-device step with a warning when fewer are visible. A CPU App
    repeats the ``"cpu"`` device across the grid (as the row-banded tests
    do) and offers one grid slot per CPU core (``os.cpu_count()``): a
    larger grid falls back the same way.
    """

    def __init__(
        self,
        graph: TaskGraph,
        field_layout=None,
        clock: Optional[RobotClock] = None,
        comm: Optional[Comm] = None,
        synthetic_cameras: bool = True,
        team_number: Optional[int] = None,
        logger=None,
        detector_kwargs: Optional[dict] = None,
        pipeline_depth: int = 1,
        ntables_ip: Optional[str] = None,
        device_name: str = "chalkydri-tpu",
        mesh=None,
        device: str | torch.device = "cuda",
    ):
        from chalkydri_tpu_torch.geometry.field_layout import load_field_layout
        from chalkydri_tpu_torch.io.camera import CamPipeline

        self.device = resolve_device(device)
        self.graph = graph
        self.clock = clock or RobotClock()
        self.logger = logger
        self.resources = ResourceManager()
        self.resources.add("app.device", self.device)

        # -- resources (CommBundle parity, whacknet/src/lib.rs:187-202) -----
        for decl in graph.resources:
            if decl.provider.endswith("CommBundle"):
                c = comm or Comm(team_number=team_number)
                self.resources.add(f"{decl.id}.comm", c)
        self._comm = comm
        for decl in graph.resources:
            key = f"{decl.id}.comm"
            try:
                self._comm = self.resources.get(key)
                break
            except KeyError:
                pass
        if self._comm is None:
            self._comm = comm or Comm(team_number=team_number)
            self.resources.add("comm.comm", self._comm)

        # -- split chains: fused vision vs generic host tasks ----------------
        self.fused_chains: list[FusedChain] = []
        fused_task_ids: set[str] = set()
        for chain in graph.chains():
            nodes = [graph.node(i) for i in chain]
            if nodes and nodes[0].type in CAMERA_TYPES and nodes[-1].type in FUSED_SINK_TYPES:
                cam_node, sink_node = nodes[0], nodes[-1]
                cam = CamPipeline(cam_node.config, synthetic_ok=synthetic_cameras)
                self.fused_chains.append(
                    FusedChain(
                        camera=cam,
                        sink_cfg=sink_node.config,
                        cam_id=int(sink_node.config.get("cam_id", 255)),
                        batch_index=len(self.fused_chains),
                    )
                )
                fused_task_ids.update(chain)

        # -- generic tasks ----------------------------------------------------
        self.tasks: dict[str, object] = {}
        for node in graph.tasks:
            if node.id in fused_task_ids:
                continue
            try:
                cls = REGISTRY.resolve(node.type)
            except KeyError:
                continue  # unknown host task types are skipped, not fatal
            self.tasks[node.id] = cls(config=node.config, resources=self.resources)
        self._order = [t for t in graph.topo_order() if t in self.tasks]
        self._inbox: dict[str, Stamped] = {}

        # -- batched device steps (one per geometry x detector config) -------
        self.groups: list[FusedGroup] = []
        if self.fused_chains:
            if field_layout is None:
                field_layout = load_field_layout(dtype=torch.float32,
                                                 device=self.device)
        self._field_layout = field_layout
        # capacity_fallback is an APP-level behavior (two steps + host
        # redispatch), not a pipeline kwarg: pop it so the steps never see
        # it.
        dk = dict(detector_kwargs or {})
        self._capacity_fallback = bool(dk.pop("capacity_fallback", False))
        self._detector_kwargs = dk
        # Device-grid request from configuration ([mesh] data/space in the
        # TOML surface, io/config.py MeshCfg). Resolved lazily in
        # _build_groups; with too few devices the app degrades to the
        # single-device step with a warning (boot must survive a
        # misconfigured rig: the deployment story is systemd
        # Restart=always, not crash loops).
        self._mesh_req = self._normalize_mesh_req(mesh)
        self._mesh = None
        self._build_groups()

        self.pipeline_depth = pipeline_depth
        self._in_flight = None
        self._fetched_stamps: list = []  # (pinned stamps, card) to record
        self._started = False
        self._frame_observers: list = []
        self._detection_observers: list = []
        self._pose_observers: list = []
        # Cumulative boundary candidates lost to detector capacity
        # compaction (visible degradation counter; see Detections
        # .dropped_points). Health tools (soak) report it.
        self.dropped_points_total = 0

        # -- AAEC: adaptive active exposure control --------------------------
        # A graph node of type "Aaec" activates the closed loop (the
        # reference's intent, crates/aaec/README.md:2): every `period`
        # iterations, compute the batch Sobel-gradient metric on the staged
        # frames and hill-climb each camera's manual exposure toward higher
        # gradient (subsystems/aaec.py; actuator = CamPipeline.set_exposure).
        self._aaec = False
        self._aaec_period = 10
        self._aaec_tick = 0
        for node in graph.tasks:
            if node.type in ("Aaec", "aaec::Aaec") and self.fused_chains:
                from chalkydri_tpu_torch.subsystems.aaec import ExposureController

                self._aaec_period = int(node.config.get("period", 10))
                for ch in self.fused_chains:
                    ch.aaec = ExposureController(
                        initial=int(node.config.get("initial", 100)),
                        step=int(node.config.get("step", 8)),
                    )
                self._aaec = True
                break

        # Optional NetworkTables uplink: the reference's robot-visible state
        # schema (book/src/networktables.md:1-30 — Chalkydri/Robot/Position,
        # Chalkydri/Robot/Rotation, Chalkydri/Devices/{id}/Version).
        # The client owns transport resilience: it connects in the
        # background with backoff (the robot-side NT server typically
        # boots AFTER the coprocessor), reconnects on drops, re-announces
        # publishers, and drops publishes while disconnected — App never
        # sees or handles transport state.
        self._nt = None
        self._nt_device_name = device_name
        if ntables_ip:
            from chalkydri_tpu_torch.io.networktables import NT4Client

            host, _, port = ntables_ip.partition(":")
            nt = NT4Client(host, int(port) if port else 5810, reconnect=True)
            nt.start()
            from chalkydri_tpu_torch import __version__

            nt.publish(
                f"/Chalkydri/Devices/{device_name}/Version", __version__,
                retained=True,
            )
            self._nt = nt
            self.resources.add("nt.client", nt)

    # -- group construction (also used by live reconfiguration) -------------

    @staticmethod
    def _normalize_mesh_req(mesh) -> Optional[tuple]:
        """Accept a MeshCfg, a {'data': N, 'space': M} dict, or None."""
        if mesh is None:
            return None
        if isinstance(mesh, dict):
            data, space = int(mesh.get("data", 1)), int(mesh.get("space", 1))
        else:
            data, space = int(getattr(mesh, "data", 1)), int(getattr(mesh, "space", 1))
        if data < 1 or space < 1:
            # A config typo must degrade, not crash-loop the boot — same
            # policy as the too-few-devices fallback in _resolve_mesh.
            _log.warning(
                "mesh axes must be >= 1, got data=%d space=%d; "
                "running single-device", data, space,
            )
            return None
        if data == 1 and space == 1:
            return None
        return (data, space)

    def _resolve_mesh(self):
        """Build the device grid for the configured topology, or None.

        Falls back (with a warning) when the host offers fewer devices
        than data*space (class docstring) — a robot boot must degrade, not
        die.
        """
        if self._mesh_req is None:
            return None
        if self._mesh is not None:
            return self._mesh
        from chalkydri_tpu_torch.parallel.mesh import make_mesh

        data, space = self._mesh_req
        need = data * space
        if self.device.type == "cuda":
            have = torch.cuda.device_count()
            devices = [f"cuda:{i}" for i in range(min(need, have))]
        else:
            have = os.cpu_count() or 1
            devices = [self.device] * need
        if have < need:
            _log.warning(
                "mesh config wants %dx%d=%d devices but only %d present; "
                "running single-device", data, space, need, have,
            )
            self._mesh_req = None
            return None
        self._mesh = make_mesh(devices, space=space)
        return self._mesh

    @staticmethod
    def _chain_key(ch: FusedChain) -> tuple:
        """Grouping key: ORIENTED frame geometry + detector config."""
        w = int(ch.camera.width or 640)
        h = int(ch.camera.height or 480)
        if str(getattr(ch.camera, "orientation", "none")).lower() in (
            "clockwise", "counterclockwise",
        ):
            w, h = h, w  # 90-degree orientations swap the emitted geometry
        return (
            _round_up(w, 8),
            _round_up(h, 8),
            str(ch.sink_cfg.get("family", "tag36h11")),
            int(ch.sink_cfg.get("bits_corrected", 3)),
        )

    def _build_groups(self) -> None:
        from chalkydri_tpu_torch.pipeline import (
            build_rig_from_config,
            make_vision_pipeline,
        )

        self.groups = []
        if not self.fused_chains:
            return
        mesh = self._resolve_mesh()
        by_key: dict[tuple, list[FusedChain]] = {}
        for ch in self.fused_chains:
            by_key.setdefault(self._chain_key(ch), []).append(ch)
        for (w, h, family, bits), chains in by_key.items():
            cams_cfg = [
                {
                    "calib": ch.sink_cfg.get("calib"),
                    "robot_to_cam": ch.sink_cfg.get("robot_to_cam"),
                }
                for ch in chains
            ]
            b, h_pad = len(chains), h
            if mesh is not None:
                # The runtime owns the grid-shape padding: batch pads to a
                # multiple of the 'data' axis (pad slots replicate camera
                # 0's parameters and stage neutral-127 frames, thresholded
                # to 'skip', never published), and the staged frame HEIGHT
                # pads to a multiple of space*8 so each row band's
                # decimated block tiles cleanly (parallel/pipeline.py;
                # padding rows are 127 fill, also 'skip'). frame_w/frame_h
                # keep the logical camera geometry.
                n_data, n_space = mesh.shape["data"], mesh.shape["space"]
                b = _round_up(len(chains), n_data)
                cams_cfg = cams_cfg + [cams_cfg[0]] * (b - len(chains))
                h_pad = _round_up(h, n_space * 8)
            params, rc = build_rig_from_config(cams_cfg, self._field_layout,
                                               device=self.device)
            if mesh is not None:
                from chalkydri_tpu_torch.parallel.pipeline import (
                    make_sharded_vision_pipeline,
                )

                sharded_step, place = make_sharded_vision_pipeline(
                    self._field_layout, params, rc, mesh,
                    spatial=mesh.shape["space"] > 1, family=family,
                    bits_corrected=bits, detector_kwargs=self._detector_kwargs,
                )

                def step(frames, gyro, _s=sharded_step, _p=place):
                    return _s(*_p(frames, gyro))

                step_device = mesh.grid[0][0]
            else:
                step = make_vision_pipeline(
                    self._field_layout, params, rc, family=family,
                    bits_corrected=bits, detector_kwargs=self._detector_kwargs,
                    device=self.device,
                )
                step_device = self.device
            step_big = step_big_ready = None
            if self._capacity_fallback and mesh is not None:
                # Grid groups keep warn-only degradation: their step
                # closure owns device placement, and doubling a banded
                # step's footprint needs a per-deployment decision, not a
                # default. Say so instead of silently ignoring the
                # operator's flag.
                _log.warning(
                    "capacity_fallback requested but a [mesh] is "
                    "configured; the 2x-budget redispatch is single-"
                    "device only — texture floods will degrade with a "
                    "warning instead of recovering"
                )
            if self._capacity_fallback and mesh is None:
                # The texture-flood recovery step: same rig, 2x the
                # candidate compaction budget. Warmed up by a background
                # thread in start_all_tasks; until that finishes,
                # overflowed iterations keep the standard (degraded)
                # result rather than stalling publishing.
                from chalkydri_tpu_torch.detector.cluster import MAX_EDGE_POINTS

                dk = dict(self._detector_kwargs or {})
                dk["max_edge_points"] = 2 * int(
                    dk.get("max_edge_points", MAX_EDGE_POINTS))
                step_big = make_vision_pipeline(
                    self._field_layout, params, rc, family=family,
                    bits_corrected=bits, detector_kwargs=dk,
                    device=self.device,
                )
                step_big_ready = threading.Event()
            for i, ch in enumerate(chains):
                ch.batch_index = i
                ch.group = len(self.groups)
            # Neutral fill 127 thresholds to 'skip' (no contrast). Pinned
            # on a card, so the upload is an asynchronous DMA.
            host = torch.full((b, h_pad, w), 127, dtype=torch.uint8,
                              pin_memory=step_device.type == "cuda")
            self.groups.append(
                FusedGroup(
                    step=step, chains=chains, frames_host=host,
                    frames_buf=host.numpy(), frame_w=w, frame_h=h,
                    family=family, bits_corrected=bits, device=step_device,
                    step_big=step_big, step_big_ready=step_big_ready,
                )
            )

    def update_camera(
        self,
        cam_id: int,
        orientation: Optional[str] = None,
        width: Optional[int] = None,
        height: Optional[int] = None,
        exposure: Optional[int] = None,
    ) -> None:
        """Apply a live configuration change to a running camera chain —
        the reference's videoflip/valve live-update path
        (``crates/chalkydri/src/cameras/pipeline.rs:201-269``), which
        patches a running GStreamer pipeline without restarting the app.

        Orientation changes take effect on the next frame; geometry changes
        restart the one capture backend and re-stage the affected groups
        (rebuilding their steps; the kernel library is cached by source
        digest, ops/build.py, so nothing recompiles). Poses already in
        flight are flushed first so nothing is lost.
        """
        target = None
        for ch in self.fused_chains:
            if ch.cam_id == cam_id:
                target = ch
                break
        if target is None:
            raise KeyError(f"no fused chain with cam_id {cam_id}")

        if exposure is not None:
            target.camera.set_exposure(int(exposure))
        reopen = False
        if orientation is not None:
            target.camera.orientation = orientation
        if width is not None:
            target.camera.width = int(width)
            reopen = True
        if height is not None:
            target.camera.height = int(height)
            reopen = True

        old_partition = [
            (g.frame_w, g.frame_h, g.family, g.bits_corrected,
             tuple(c.cam_id for c in g.chains))
            for g in self.groups
        ]
        new_keys: dict[tuple, list[int]] = {}
        for ch in self.fused_chains:
            new_keys.setdefault(self._chain_key(ch), []).append(ch.cam_id)
        new_partition = [
            (k[0], k[1], k[2], k[3], tuple(ids)) for k, ids in new_keys.items()
        ]
        if sorted(new_partition) != sorted(old_partition):
            # Geometry regrouping: flush pipelined results, rebuild steps.
            self._flush_in_flight()
            self._build_groups()
        if reopen and self._started:
            target.camera.stop(self.clock)  # next poll re-opens at new size
            target.camera.start(self.clock)
        target.fresh = False

    # -- single-group conveniences (the common homogeneous-rig case) --------

    @property
    def step(self):
        """The batched device step (first group's; None without cameras)."""
        return self.groups[0].step if self.groups else None

    @property
    def frame_w(self) -> int:
        return self.groups[0].frame_w if self.groups else 0

    @property
    def frame_h(self) -> int:
        return self.groups[0].frame_h if self.groups else 0

    # -- lifecycle -----------------------------------------------------------

    def start_all_tasks(self) -> None:
        for ch in self.fused_chains:
            ch.camera.start(self.clock)
        for t in self.tasks.values():
            t.start(self.clock)
        # Warm up the capacity-redispatch steps off the hot path.
        for g in self.groups:
            if g.step_big is not None and g.step_big_ready is not None \
                    and not g.step_big_ready.is_set():
                threading.Thread(
                    target=self._warm_step_big, args=(g,), daemon=True,
                    name=f"capacity-warmup-g{g.chains[0].group}",
                ).start()
        self._started = True

    @staticmethod
    def _warm_step_big(g: FusedGroup) -> None:
        """One ``step_big`` call on neutral frames, then set its ready gate.
        On a card that call captures the step's CUDA graph
        (``utils/graph.py``: eager warm-up calls on a stream of the
        wrapper's own, the capture, one replay), one capture at a time in
        the process and in a capture mode that lets the loop go on
        replaying ``step`` meanwhile; the replays of one card never
        overlap. The call runs on a stream of this thread's own, which
        first waits for the work that built the step and is synchronised
        before the gate opens, so the loop's later calls on its own stream
        find everything in place. The kernel library builds under a lock
        (ops/build.py), so this thread and the loop's first step cannot
        both compile it."""
        try:
            b, h, w = g.frames_host.shape
            if g.device.type == "cuda":
                stream = torch.cuda.Stream(device=g.device)
                stream.wait_stream(torch.cuda.current_stream(g.device))
                with torch.cuda.stream(stream):
                    g.step_big(
                        torch.full((b, h, w), 127, dtype=torch.uint8,
                                   device=g.device),
                        torch.zeros(b, dtype=torch.float32, device=g.device))
                stream.synchronize()
            else:
                g.step_big(torch.full((b, h, w), 127, dtype=torch.uint8),
                           torch.zeros(b, dtype=torch.float32))
            g.step_big_ready.set()
        except Exception:  # a failed warm-up = warn-only mode
            _log.exception(
                "capacity_fallback warm-up failed; floods will degrade with "
                "a warning"
            )

    def _flush_in_flight(self) -> None:
        """Publish the pipelined in-flight batches so their poses aren't
        lost."""
        if self._in_flight is None:
            return
        in_flight, self._in_flight = self._in_flight, None
        for g, entry in zip(self.groups, in_flight):
            if entry is None:
                continue
            out, states, _, copy = entry
            host_out, _ = self._fetch_small(out, copy)
            for b, ch in enumerate(g.chains):
                fresh, tov = states[b]
                self._publish_with(ch, host_out, b, fresh, tov)
        self._record_fetched_stamps()

    def stop_all_tasks(self) -> None:
        self._flush_in_flight()
        for ch in self.fused_chains:
            ch.camera.stop(self.clock)
        for t in self.tasks.values():
            t.stop(self.clock)
        self._started = False

    # -- iteration -----------------------------------------------------------

    def _poll_cameras(self) -> None:
        for ch in self.fused_chains:
            try:
                msg = ch.camera.process(self.clock)
            except Exception:
                # A dying capture backend (device yanked mid-read, driver
                # error) must degrade like an absent camera — skip this
                # iteration and let the next poll re-open (the reference
                # tolerates absent devices the same way, pipeline.rs:274-331).
                _log.warning(
                    "camera %s poll failed; treating as absent",
                    ch.cam_id, exc_info=True,
                )
                try:
                    ch.camera.stop(self.clock)
                except Exception:
                    pass
                ch.fresh = False
                continue
            if msg.payload is None:
                ch.fresh = False
                continue
            frame = msg.payload
            g = self.groups[ch.group]
            if g.upload_done is not None:
                # The last upload of this buffer may still be queued behind
                # the step before it: let it land before overwriting.
                g.upload_done.synchronize()
                g.upload_done = None
            h = min(frame.shape[0], g.frame_h)
            w = min(frame.shape[1], g.frame_w)
            buf = g.frames_buf[ch.batch_index]
            buf[:] = 127
            buf[:h, :w] = frame[:h, :w]
            ch.last_tov = msg.tov.time_us
            ch.fresh = True
            if self.logger is not None:
                self.logger.log_frame(ch.cam_id, msg.tov.time_us, frame)
            for obs in self._frame_observers:
                obs(ch.cam_id, msg.tov.time_us, frame)

    def add_frame_observer(self, fn) -> None:
        """Register ``fn(cam_id, tov_us, frame)`` called on every fresh frame
        (drives the MJPEG preview and custom host-side consumers)."""
        self._frame_observers.append(fn)

    def add_detection_observer(self, fn) -> None:
        """Register ``fn(cam_id, ids, corners, margins)`` called with each
        published batch's detections (numpy arrays, invalid slots dropped).
        Drives the preview overlay (subsystems/overlay.py) and rerun-style
        consumers. Registering one adds a detections copy to each step's
        fetch (~16 x 11 floats per camera)."""
        self._detection_observers.append(fn)

    def add_pose_observer(self, fn) -> None:
        """Register ``fn(cam_id, pose, std, tag_count, latency_us)`` called
        for every published VALID pose (heartbeats excluded). Drives the
        field view (subsystems/field_view.py)."""
        self._pose_observers.append(fn)

    def _upload(self, g: FusedGroup) -> torch.Tensor:
        """The staged batch on the step's device: an asynchronous copy from
        pinned memory on a card (its event gates the next poll's writes),
        a copy on the CPU (the buffer is rewritten while a redispatch may
        still need these frames)."""
        if g.device.type != "cuda":
            return g.frames_host.to(g.device, copy=True)
        frames = g.frames_host.to(g.device, non_blocking=True)
        g.upload_done = torch.cuda.Event()
        g.upload_done.record(torch.cuda.current_stream(g.device))
        return frames

    def _run_aaec(self) -> None:
        """One AAEC control step over each group's staged frame batch: the
        metric on the step's device, one host read of [B] floats."""
        from chalkydri_tpu_torch.subsystems.aaec import compute_exposure_gradients

        for g in self.groups:
            if not any(ch.fresh and ch.aaec is not None for ch in g.chains):
                continue
            metrics = compute_exposure_gradients(self._upload(g)).cpu().numpy()
            for ch in g.chains:
                if not ch.fresh or ch.aaec is None:
                    continue
                ch.camera.set_exposure(
                    ch.aaec.update(float(metrics[ch.batch_index]))
                )

    def _start_fetch(self, out) -> _HostCopy:
        """Queue the step's per-camera scalars (packed into one [B, 9]
        int32 tensor: float32 bits, then valid / tag_count / dropped) and,
        with detection observers, its detections for the host, behind the
        step on its stream; on a card into pinned memory, with the step's
        stage stamps (``utils/tracing.py``) and an event after the copies."""
        stamps = tracing.take_stamps()
        floats = torch.cat([torch.stack([out.pose_x, out.pose_y,
                                         out.pose_yaw], 1),
                            out.std_devs], 1).to(torch.float32)
        ints = torch.stack([out.pose_valid.to(torch.int32),
                            out.tag_count.to(torch.int32),
                            out.detections.dropped_points.to(torch.int32)], 1)
        small = torch.cat([floats.view(torch.int32), ints], 1)
        dets = None
        if self._detection_observers:
            d = out.detections
            dets = (d.ids, d.corners, d.decision_margins, d.valid)
        if small.device.type != "cuda":
            return _HostCopy(small, dets, None)

        def pinned(x):
            h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            return h.copy_(x, non_blocking=True)

        small = pinned(small)
        if dets is not None:
            dets = tuple(pinned(x) for x in dets)
        if stamps is not None:
            stamps = (pinned(stamps), stamps.device)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(out.pose_x.device))
        return _HostCopy(small, dets, event, stamps)

    def _fetch_small(self, out, copy: Optional[_HostCopy] = None):
        """(``out`` with its per-camera scalars as numpy arrays, detections
        as numpy arrays or None). Waits on ``copy``'s event only (queued by
        ``_start_fetch`` at dispatch; made here when not given): never on
        the whole stream, so a step queued after ``out`` keeps running.
        The large detections tensors stay on the device. The step's stage
        stamps, where it has them, wait for ``_record_fetched_stamps``."""
        if copy is None:
            copy = self._start_fetch(out)
        if copy.event is not None:
            copy.event.synchronize()
        if copy.stamps is not None:
            self._fetched_stamps.append(copy.stamps)
        small = copy.small.numpy()
        f = np.ascontiguousarray(small[:, :6]).view(np.float32)
        host_out = out._replace(
            pose_x=f[:, 0], pose_y=f[:, 1], pose_yaw=f[:, 2],
            std_devs=f[:, 3:6], pose_valid=small[:, 6].astype(bool),
            tag_count=small[:, 7],
            detections=out.detections._replace(dropped_points=small[:, 8]),
        )
        dets = None
        if copy.dets is not None:
            dets = tuple(x.numpy() for x in copy.dets)
        return host_out, dets

    def _record_fetched_stamps(self) -> None:
        """Record the stage stamps fetched since the last call in ``SPANS``
        (``step.*``, ``utils/tracing.py``): after the publish, so that the
        packets do not wait for it."""
        for stamps, device in self._fetched_stamps:
            tracing.record_stages(stamps, device)
        self._fetched_stamps.clear()

    def _publish_with(self, ch: FusedChain, out, b: int, fresh: bool,
                      tov: Optional[int]) -> None:
        now_ms = self.clock.now_ms()
        latency_us = self.clock.now_us() - tov if tov is not None else 0
        valid = bool(out.pose_valid[b]) if out is not None else False
        if valid and fresh:
            pose = RobotPose(
                float(out.pose_x[b]), float(out.pose_y[b]), float(out.pose_yaw[b])
            )
            std = VisionUncertainty(
                float(out.std_devs[b][0]),
                float(out.std_devs[b][1]),
                float(out.std_devs[b][2]),
            )
            self._comm.publish(
                ch.cam_id, int(out.tag_count[b]), latency_us, pose, std
            )
            for obs in self._pose_observers:
                obs(ch.cam_id, pose, std, int(out.tag_count[b]), latency_us)
            if self.logger is not None:
                self.logger.log_pose(ch.cam_id, latency_us, pose, std)
            if self._nt is not None:
                # The client reconnects internally and drops values while
                # the link is down; never disable the uplink permanently.
                self._nt.set_many(
                    {
                        "/Chalkydri/Robot/Position/X": pose.x,
                        "/Chalkydri/Robot/Position/Y": pose.y,
                        "/Chalkydri/Robot/Rotation": pose.rot,
                    }
                )
            return
        # Heartbeat: zero pose at most every >5 ms (lib.rs:365-376).
        if ch.last_heartbeat_ms is None or now_ms - ch.last_heartbeat_ms > HEARTBEAT_MS:
            self._comm.publish(
                ch.cam_id, 0, latency_us, RobotPose(), VisionUncertainty()
            )
            ch.last_heartbeat_ms = now_ms

    def run_one_iteration(self) -> Optional[object]:
        """One scheduler tick. Returns the published VisionOutput — a
        single VisionOutput for a homogeneous rig (one group, the common
        case), a list of per-group VisionOutputs for a heterogeneous rig,
        or None when nothing was published.

        With ``pipeline_depth=1`` (default) the steps dispatched for THIS
        iteration's frames are published on the NEXT iteration: the card
        runs them while the host captures (the reference's
        producer/consumer decoupling, SURVEY.md section 2.4 item 4).
        ``pipeline_depth=0`` publishes in the same iteration. Latency
        stamps stay correct: each chain's tov is captured with its batch.
        """
        from chalkydri_tpu_torch.utils.tracing import span

        if not self._started:
            self.start_all_tasks()

        outs = []
        if self.groups:
            with span("app.capture"):
                self._poll_cameras()
            any_fresh = any(ch.fresh for ch in self.fused_chains)
            if self._aaec and any_fresh:
                self._aaec_tick += 1
                if self._aaec_tick % self._aaec_period == 0:
                    with span("app.aaec"):
                        self._run_aaec()
            gyro_val = self._comm.gyro_angle() if any_fresh else None
            # Asynchronous dispatch per group: each step is queued on the
            # device's stream and returns, the card runs all groups back to
            # back while the host loops to capture.
            dispatched: list = []
            with span("app.dispatch"):
                for g in self.groups:
                    fresh = sum(ch.fresh for ch in g.chains)
                    if not fresh:
                        dispatched.append(None)
                        continue
                    # The step's slots and those of them with a fresh frame:
                    # the step runs every slot whatever the count.
                    t_ns = time.monotonic_ns()
                    tracing.SPANS.count("app.slots_fresh", fresh, t_ns)
                    tracing.SPANS.count("app.slots", g.frames_host.shape[0],
                                        t_ns)
                    # Batch dim may exceed len(chains) (grid padding).
                    frames_dev = self._upload(g)
                    gyro_dev = torch.full(
                        (g.frames_host.shape[0],), gyro_val or 0.0,
                        dtype=torch.float32, device=g.device)
                    out = g.step(frames_dev, gyro_dev)
                    dispatched.append(
                        (
                            out,
                            [(ch.fresh, ch.last_tov) for ch in g.chains],
                            # retained for capacity redispatch (device-
                            # resident; dropped with the entry otherwise)
                            (frames_dev, gyro_dev)
                            if g.step_big is not None else None,
                            self._start_fetch(out),
                        )
                    )
            if self.pipeline_depth > 0:
                ready, self._in_flight = self._in_flight, dispatched
            else:
                ready = dispatched
            if ready is None:
                ready = [None] * len(self.groups)
            for g, entry in zip(self.groups, ready):
                if entry is None:
                    for ch in g.chains:
                        self._publish_with(ch, None, 0, False, ch.last_tov)
                    continue
                out, states, dev_inputs, copy = entry
                with span("app.fetch_publish"):
                    host_out, dets = self._fetch_small(out, copy)
                    dropped_now = int(
                        np.sum(host_out.detections.dropped_points)
                    )
                    if dropped_now and g.step_big is not None \
                            and dev_inputs is not None \
                            and g.step_big_ready is not None \
                            and g.step_big_ready.is_set():
                        # Capacity redispatch: re-run THIS batch on the
                        # 2x-budget step (the frames are still on the
                        # device). The flooded frame pays one extra step;
                        # clean iterations never enter here, and until the
                        # background warm-up finishes the standard result
                        # publishes with the drop warning.
                        with span("app.capacity_redispatch"):
                            out = g.step_big(*dev_inputs)
                            host_out, dets = self._fetch_small(out)
                            dropped_now = int(
                                np.sum(host_out.detections.dropped_points)
                            )
                    outs.append(out)
                    self.dropped_points_total += dropped_now
                    if dropped_now:
                        # Operator visibility for the capacity degradation
                        # mode (texture floods): rate-limited so a noisy
                        # stream can't spam the journal.
                        now = time.monotonic()
                        if now - getattr(self, "_last_drop_warn", 0.0) > 5.0:
                            self._last_drop_warn = now
                            _log.warning(
                                "candidate compaction dropped %d boundary "
                                "points this iteration (%d total) — scene "
                                "exceeds the detector's candidate budget; "
                                "tags may fragment. See capacity_fallback in "
                                "docs/maintenance.md.",
                                dropped_now, self.dropped_points_total,
                            )
                    for b, ch in enumerate(g.chains):
                        fresh, tov = states[b]
                        self._publish_with(ch, host_out, b, fresh, tov)
                if dets is not None:
                    ids, corners, margins, valid = dets
                    for b, ch in enumerate(g.chains):
                        if not states[b][0]:
                            continue
                        keep = valid[b]
                        for obs in self._detection_observers:
                            obs(ch.cam_id, ids[b][keep], corners[b][keep],
                                margins[b][keep])
            self._record_fetched_stamps()

        # Generic host tasks in topological order.
        from chalkydri_tpu_torch.io.camera import CamPipeline
        from chalkydri_tpu_torch.runtime.tasks import SrcTask

        for tid in self._order:
            task = self.tasks[tid]
            preds = self.graph.predecessors(tid)
            if not preds:
                if not isinstance(task, (SrcTask, CamPipeline)):
                    continue  # sink with no producer: nothing to do
                msg = task.process(self.clock)
            else:
                msg = self._inbox.get(tid)
                if msg is None:
                    continue
                msg = task.process(self.clock, msg)
                self._inbox.pop(tid, None)
            if msg is not None:
                for succ in self.graph.successors(tid):
                    self._inbox[succ] = msg
        if not outs:
            return None
        return outs[0] if len(self.groups) == 1 else outs

    def run(self, max_iters: Optional[int] = None, rate_hz: Optional[float] = None):
        """The Copper loop (main.rs:111). ``rate_hz`` caps iteration rate
        like the capriltags ``max_frame_rate`` config
        (chalkydri_core/src/config.rs:157)."""
        n = 0
        period = 1.0 / rate_hz if rate_hz else 0.0
        try:
            while max_iters is None or n < max_iters:
                t0 = time.monotonic()
                self.run_one_iteration()
                n += 1
                if period:
                    dt = time.monotonic() - t0
                    if dt < period:
                        time.sleep(period - dt)
        finally:
            self.stop_all_tasks()
