"""The port's runtime App (``chalkydri_tpu_torch.runtime.app``) and ``main``
on the CPU.

The App parity case runs JAX's ``App`` and the port's ``App(device="cpu")``
over the same two-camera 320x240 graph (``tests/test_runtime.py``'s
``_mini_graph``), with the same frames put in through each chain's
``camera._cap`` and a clock the test advances, and compares what each
publishes iteration by iteration: camera, tag count and latency equal,
poses within the tolerances of ``tests/test_torch_pipeline.py`` (1e-3 m,
1e-3 rad), std devs within 1e-2 relative (float32 residual sums in another
order). The other cases are the port's twins of the JAX App cases.

Sockets bind port 0 (ephemeral): ``tests/test_runtime.py`` runs in
another worker on fixed ports.
"""

import json
import logging
import os
import socket
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chalkydri_tpu.geometry.field_layout import parse_field_layout as jax_layout
from chalkydri_tpu.runtime import App as JaxApp
from chalkydri_tpu.runtime import TaskGraph as JaxGraph
from chalkydri_tpu_torch.geometry.field_layout import parse_field_layout
from chalkydri_tpu_torch.io.whacknet import Comm, decode_measurement
from chalkydri_tpu_torch.main import main
from chalkydri_tpu_torch.pipeline import VisionOutput, build_rig_from_config
from chalkydri_tpu_torch.runtime import App, RobotClock, TaskGraph, read_log
from chalkydri_tpu_torch.tools.scenes import render_scene
from chalkydri_tpu_torch.utils import tracing

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CALIB = {"fx": 300.0, "fy": 300.0, "cx": 160.0, "cy": 120.0, "k1": 0.0,
         "k2": 0.0, "p1": 0.0, "p2": 0.0, "k3": 0.0, "width": 320,
         "height": 240}
MOUNT = '{"roll": 0, "pitch": 0, "yaw": 0, "x": 0, "y": 0, "z": 0.5}'
DK = dict(max_edge_points=8192, max_clusters=16, cluster_points=256)
# Tags 3 and 4 side by side on a wall at x = 10 m facing -x, at the
# cameras' height; two robot poses 1-1.1 m before them.
LAYOUT = {"tags": [{"ID": t, "pose": {
    "translation": {"x": 10.0, "y": y, "z": 0.5},
    "rotation": {"quaternion": {"W": 0.0, "X": 0.0, "Y": 0.0, "Z": 1.0}}}}
    for t, y in ((3, 4.2), (4, 3.8))], "field": {"length": 16, "width": 8}}
POSES = {"A": (9.0, 4.0, 0.0), "B": (8.9, 4.05, 0.03)}
POSE_TOL, YAW_TOL, STD_RTOL = 1e-3, 1e-3, 1e-2
TICK_US = 10_000  # the test clock's step per iteration (> the 5 ms heartbeat)


def _graph_dict(n_cams=2, w=320, h=240):
    tasks, cnx = [], []
    for i in range(n_cams):
        tasks += [
            {"id": f"camera_{i}", "type": "CamPipeline",
             "config": {"id": f"missing-dev-{i}", "name": f"c{i}",
                        "width": w, "height": h}},
            {"id": f"apriltags_{i}", "type": "chalkydri_apriltags::AprilTags",
             "config": {"cam_id": i,
                        "calib": json.dumps({"OpenCVModel5": CALIB}),
                        "robot_to_cam": MOUNT}},
        ]
        cnx.append({"src": f"camera_{i}", "dst": f"apriltags_{i}",
                    "msg": "frame"})
    return {"tasks": tasks, "cnx": cnx,
            "resources": [{"id": "comm", "provider": "whacknet::CommBundle"}]}


def _graph(**kw):
    return TaskGraph.from_dict(_graph_dict(**kw))


@pytest.fixture(scope="module")
def layout():
    return parse_field_layout(LAYOUT, dtype=torch.float32)


@pytest.fixture(scope="module")
def frames(layout):
    """name -> 240x320 uint8: the view from each robot pose, and a blank."""
    cam = {"calib": json.dumps({"OpenCVModel5": CALIB}), "robot_to_cam": MOUNT}
    _, rc = build_rig_from_config([cam], layout, device="cpu")
    out = {k: render_scene(layout, rc, *p, CALIB, tags=(3, 4))
           for k, p in POSES.items()}
    out["blank"] = np.full((240, 320), 150, np.uint8)
    return out


class ManualClock(RobotClock):
    """A RobotClock the test advances."""

    def __init__(self):
        super().__init__()
        self.t = 1_000_000

    def now_us(self) -> int:
        return self.t


class Recorder:
    """A Comm stand-in that records every publish with the iteration."""

    def __init__(self, gyro=0.0):
        self.packets = []
        self.it = 0
        self.gyro = gyro

    def publish(self, cam_id, tag_count, ts_us, pose, std):
        self.packets.append((self.it, cam_id, tag_count, ts_us,
                             (pose.x, pose.y, pose.rot), (std.x, std.y, std.rot)))

    def gyro_angle(self):
        return self.gyro

    def close(self):
        pass


class ScriptedCap:
    """A capture whose ``latest()`` returns the next frame of a script
    (None: no fresh frame this poll)."""

    def __init__(self, script):
        self.script = list(script)
        self.n = 0

    def latest(self):
        item = self.script[self.n] if self.n < len(self.script) else None
        self.n += 1
        return None if item is None else (item, 0)

    def close(self):
        pass


# Per camera, per iteration: a robot pose's view, a blank frame (no tags:
# heartbeat) or no fresh frame (None: heartbeat, nothing dispatched for a
# group whose cameras all lack one).
SCRIPT = {0: ["A", "A", None, "B", "blank", "A", None, "B"],
          1: ["B", None, "B", "A", "A", None, None, "blank"]}


def _drive(app, frames, clock, rec, script=SCRIPT):
    """Run the scripted iterations, then stop (flushing the in-flight
    batch); returns the packets and the outputs of each iteration."""
    app.start_all_tasks()
    for ch in app.fused_chains:
        ch.camera._cap = ScriptedCap(
            [None if k is None else frames[k] for k in script[ch.cam_id]])
    outs = []
    for it in range(len(script[0])):
        rec.it = it
        clock.t += TICK_US
        outs.append(app.run_one_iteration())
    rec.it = len(script[0])
    clock.t += TICK_US
    app.stop_all_tasks()
    return rec.packets, outs


def _port_app(layout, clock=None, comm=None, **kw):
    kw.setdefault("detector_kwargs", DK)
    return App(kw.pop("graph", None) or _graph(), field_layout=layout,
               clock=clock, comm=comm, device="cpu", **kw)


def _assert_packets_match(got, want):
    assert [p[:4] for p in got] == [p[:4] for p in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[4][:2], w[4][:2], atol=POSE_TOL, rtol=0)
        np.testing.assert_allclose(g[4][2], w[4][2], atol=YAW_TOL, rtol=0)
        np.testing.assert_allclose(g[5], w[5], rtol=STD_RTOL, atol=1e-9)


@pytest.fixture(scope="module")
def port_depth1(layout, frames):
    clock, rec = ManualClock(), Recorder()
    return _drive(_port_app(layout, clock, rec), frames, clock, rec)


def test_app_publishes_what_jax_app_publishes(port_depth1, frames):
    """Same graph, same frames, same clock: the same packets in the same
    iterations (valid poses, heartbeats, latencies), poses within the
    pipeline parity tolerances."""
    clock, rec = ManualClock(), Recorder()
    app = JaxApp(JaxGraph.from_dict(_graph_dict()),
                 field_layout=jax_layout(LAYOUT, dtype=jnp.float32),
                 clock=clock, comm=rec, detector_kwargs=DK)
    want, _ = _drive(app, frames, clock, rec)
    got, _ = port_depth1
    _assert_packets_match(got, want)
    valid = [p for p in got if p[2] > 0]
    # every frame with tags in view publishes 2 tags, one iteration later
    n_views = sum(k in POSES for s in SCRIPT.values() for k in s)
    assert len(valid) == n_views and all(p[2] == 2 for p in valid)
    assert all(p[3] == TICK_US for p in valid)
    for it, cam, _, _, pose, _ in valid:
        x, y, _ = POSES[SCRIPT[cam][it - 1]]
        assert abs(pose[0] - x) < 0.02 and abs(pose[1] - y) < 0.02
    # heartbeats: a zero pose for each camera without a valid pose to
    # publish (nothing yet in flight, or no tags / no frame a tick earlier)
    beats = [(p[0], p[1]) for p in got if p[2] == 0]
    assert beats == [(it, cam) for it in range(len(SCRIPT[0]) + 1)
                     for cam in (0, 1)
                     if it == 0 or SCRIPT[cam][it - 1] not in POSES]
    assert all(p[4] == (0.0, 0.0, 0.0) for p in got if p[2] == 0)


def test_depth0_publishes_depth1_packets_one_iteration_earlier(
        port_depth1, layout, frames):
    clock, rec = ManualClock(), Recorder()
    app = _port_app(layout, clock, rec, pipeline_depth=0)
    got, outs = _drive(app, frames, clock, rec)
    assert app._in_flight is None
    want = [p for p in port_depth1[0] if p[2] > 0]
    valid = [p for p in got if p[2] > 0]
    assert [(p[0] + 1, p[1], p[2]) for p in valid] == \
        [(p[0], p[1], p[2]) for p in want]
    assert all(p[3] == 0 for p in valid)  # published at its capture tick
    for g, w in zip(valid, want):
        assert g[4] == w[4] and g[5] == w[5]
    assert isinstance(outs[0], VisionOutput)
    assert outs[0].pose_valid.all()


def test_capacity_redispatch(layout):
    """A batch whose standard step reports dropped candidates re-runs on
    the 2x-budget step (warmed up in the background first) and publishes
    ITS result (stub steps pin the mechanism)."""
    from chalkydri_tpu_torch.detector.pipeline import Detections

    rio = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rio.bind(("127.0.0.1", 0))
    rio.settimeout(5.0)
    comm = Comm(remote_addr="127.0.0.1", remote_port=rio.getsockname()[1],
                gyro_port=0, use_native=False)
    app = _port_app(layout, comm=comm, graph=_graph(n_cams=1),
                    pipeline_depth=0,
                    detector_kwargs=dict(DK, capacity_fallback=True))
    try:
        g = app.groups[0]
        assert g.step_big is not None
        assert "capacity_fallback" not in app._detector_kwargs
        assert g.step_big.detector.edge_cap == 2 * 8192

        def fake_out(dropped, x):
            b, nd = 1, 16
            det = Detections(
                ids=torch.full((b, nd), -1, dtype=torch.int32),
                corners=torch.zeros((b, nd, 4, 2)),
                decision_margins=torch.zeros((b, nd)),
                hammings=torch.zeros((b, nd), dtype=torch.int32),
                valid=torch.zeros((b, nd), dtype=torch.bool),
                dropped_points=torch.full((b,), dropped, dtype=torch.int32))
            return VisionOutput(
                pose_x=torch.full((b,), x), pose_y=torch.zeros(b),
                pose_yaw=torch.zeros(b), std_devs=torch.full((b, 3), 0.1),
                pose_valid=torch.ones(b, dtype=torch.bool),
                tag_count=torch.ones(b, dtype=torch.int32), detections=det)

        calls = {"std": 0, "big": 0}

        def std_step(frames, gyro):
            calls["std"] += 1
            return fake_out(dropped=777, x=1.0)

        def big_step(frames, gyro):
            calls["big"] += 1
            return fake_out(dropped=0, x=2.0)

        g.step, g.step_big = std_step, big_step
        app.start_all_tasks()
        assert g.step_big_ready.wait(timeout=10.0)
        calls["big"] = 0
        app.run_one_iteration()
        assert calls == {"std": 1, "big": 1}
        pose, _, _, _, n = decode_measurement(rio.recvfrom(64)[0])
        assert pose.x == 2.0 and n == 1
        assert app.dropped_points_total == 0
    finally:
        app.stop_all_tasks()
        comm.close()
        rio.close()


def test_two_geometry_groups(layout, frames):
    """Cameras of different sizes run as separate groups, each at its own
    geometry, and publish from both."""
    d = _graph_dict(n_cams=2)
    d["tasks"][2]["config"].update(width=256, height=192)
    # camera 1 sees the middle 256x192 of camera 0's view
    d["tasks"][3]["config"]["calib"] = json.dumps(
        {"OpenCVModel5": dict(CALIB, cx=128.0, cy=96.0)})
    clock, rec = ManualClock(), Recorder()
    app = _port_app(layout, clock, rec, graph=TaskGraph.from_dict(d))
    geoms = sorted((g.frame_h, g.frame_w) for g in app.groups)
    assert geoms == [(192, 256), (240, 320)]
    for g in app.groups:
        assert g.frames_buf.shape == (1, g.frame_h, g.frame_w)
        assert g.frames_buf.base is not None  # a view of frames_host
    small = frames["A"][24:216, 32:288]
    script = {0: ["A", "A", "A"], 1: ["small", "small", "small"]}
    packets, outs = _drive(app, dict(frames, small=small), clock, rec, script)
    assert len(outs[1]) == 2
    valid = [p for p in packets if p[2] == 2]
    assert sorted(p[:2] for p in valid) == [(1, 0), (1, 1), (2, 0), (2, 1),
                                            (3, 0), (3, 1)]
    for p in valid:
        assert abs(p[4][0] - POSES["A"][0]) < 0.02
        assert abs(p[4][1] - POSES["A"][1]) < 0.02


def test_app_counts_the_fresh_slots_of_each_dispatch(layout, frames,
                                                     monkeypatch):
    """Four cameras in one group: each iteration that dispatches records
    ``app.slots`` (the batch's 4) and ``app.slots_fresh`` (its cameras
    with a fresh frame) as host ints at the dispatch, read from no
    tensor; an iteration with no fresh frame dispatches and records
    nothing."""
    spans = tracing.SpanStats()
    monkeypatch.setattr(tracing, "SPANS", spans)
    clock, rec = ManualClock(), Recorder()
    app = _port_app(layout, clock, rec, graph=_graph(n_cams=4))
    assert app.groups[0].frames_buf.shape == (4, 240, 320)
    script = {0: ["A", None, None], 1: ["B", None, None],
              2: ["A", "B", None], 3: ["B", None, None]}
    t0 = time.monotonic_ns()
    packets, outs = _drive(app, frames, clock, rec, script)
    t1 = time.monotonic_ns()
    assert spans.counted_between("app.slots_fresh", t0, t1) == [4, 1]
    assert spans.counted_between("app.slots", t0, t1) == [4, 4]
    for name in ("app.slots_fresh", "app.slots"):
        assert all(type(v) is int and t0 <= t <= t1
                   for v, t in spans.counts[name])
    assert spans.counted_between("app.slots", t0, t0 - 1) == []
    # camera 2 alone published the second step's pose
    assert sorted(p[:3] for p in packets if p[2]) == [
        (1, 0, 2), (1, 1, 2), (1, 2, 2), (1, 3, 2), (2, 2, 2)]
    spans.reset()
    assert spans.counted_between("app.slots", t0, t1) == []


def test_live_update_camera(layout, frames):
    """Orientation and resolution changes regroup a running App (flushing
    the in-flight batch first); detections continue."""
    clock, rec = ManualClock(), Recorder()
    app = _port_app(layout, clock, rec, graph=_graph(n_cams=1))
    app.start_all_tasks()
    app.fused_chains[0].camera._cap = ScriptedCap([frames["A"]] * 2)
    for _ in range(2):
        clock.t += TICK_US
        app.run_one_iteration()
    app.update_camera(0, orientation="clockwise")
    assert app._in_flight is None  # flushed
    assert sum(p[2] == 2 for p in rec.packets) == 2
    assert (app.groups[0].frame_w, app.groups[0].frame_h) == (240, 320)
    app.update_camera(0, orientation="none", width=256, height=192)
    assert (app.groups[0].frame_w, app.groups[0].frame_h) == (256, 192)
    assert app.fused_chains[0].camera._cap.width == 256  # reopened
    out = None
    for _ in range(10):
        clock.t += TICK_US
        out = app.run_one_iteration() or out
        time.sleep(0.02)  # let the synthetic camera emit frames
    app.stop_all_tasks()
    assert out is not None and out.detections.valid.any()
    assert tuple(app.groups[0].frames_buf.shape) == (1, 192, 256)


def test_dying_capture_degrades_not_crashes(layout, frames):
    clock, rec = ManualClock(), Recorder()
    app = _port_app(layout, clock, rec)
    app.start_all_tasks()

    class DyingCap:
        def latest(self):
            raise OSError("device disappeared")

        def close(self):
            pass

    victim, other = app.fused_chains
    victim.camera._synthetic_ok = False
    victim.camera._cap = DyingCap()
    other.camera._cap = ScriptedCap([frames["A"]] * 4)
    fresh = []
    for _ in range(4):
        clock.t += TICK_US
        app.run_one_iteration()  # must not raise
        fresh.append((victim.fresh, other.fresh))
    assert fresh == [(False, True)] * 4
    assert any(p[1] == 0 and p[2] == 0 for p in rec.packets)  # heartbeats
    assert any(p[1] == 1 and p[2] == 2 for p in rec.packets)
    victim.camera._synthetic_ok = True
    deadline = time.time() + 5
    while time.time() < deadline and not victim.fresh:
        clock.t += TICK_US
        app.run_one_iteration()
        time.sleep(0.005)
    app.stop_all_tasks()
    assert victim.fresh, "camera did not recover after failure"


def test_graph_without_cameras_runs():
    g = TaskGraph.from_dict({"tasks": [{"id": "m", "type": "Monitor"}],
                             "cnx": []})
    app = App(g, comm=Recorder(), device="cpu")
    assert app.groups == [] and app.step is None
    assert app.run_one_iteration() is None
    app.stop_all_tasks()


def test_mesh_falls_back_when_too_few_devices(layout, frames, caplog):
    """A grid larger than the host offers degrades to the single-device
    step with a warning; a grid it offers runs and publishes."""
    too_many = (os.cpu_count() or 1) + 1
    with caplog.at_level(logging.WARNING):
        app = _port_app(layout, comm=Recorder(),
                        mesh={"data": too_many, "space": 1})
    assert app._mesh is None and app._mesh_req is None
    assert app.groups[0].frames_buf.shape[0] == 2
    assert "running single-device" in caplog.text

    clock, rec = ManualClock(), Recorder()
    app = _port_app(layout, clock, rec, mesh={"data": 2, "space": 2})
    assert app._mesh.shape == {"data": 2, "space": 2}
    assert app.groups[0].frames_buf.shape == (2, 240, 320)
    packets, _ = _drive(app, frames, clock, rec,
                        {0: ["A", None], 1: ["B", None]})
    assert [p[:3] for p in packets if p[2]] == [(1, 0, 2), (1, 1, 2)]


def test_app_on_cuda_without_a_card_raises(layout, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        App(_graph(), field_layout=layout, comm=Recorder())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--graph", os.path.join(ROOT, "examples", "chalkydri.ron"),
              "--iters", "1"])


def test_app_without_field_layout_raises_like_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="field.json"):
        App(_graph(), comm=Recorder(), device="cpu")


def test_main_runs_the_loop_and_logs_both_cameras(tmp_path, layout):
    """``main`` on a two-camera graph file (synthetic cameras), three
    iterations on the CPU: exit 0, frames of both cameras in the log."""
    graph = tmp_path / "rig.ron"
    graph.write_text(_graph().dumps())
    field = tmp_path / "field.json"
    field.write_text(json.dumps(LAYOUT))
    log = tmp_path / "run.ctlog"
    config = tmp_path / "chalkydri.toml"
    config.write_text("team_number = 4533\n")
    rio = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rio.bind(("127.0.0.1", 0))
    rio.settimeout(5.0)
    try:
        assert main(["--graph", str(graph), "--field", str(field),
                     "--config", str(config), "--device", "cpu", "--iters",
                     "3", "--log", str(log), "--robot-addr",
                     f"127.0.0.1:{rio.getsockname()[1]}"]) == 0
        assert decode_measurement(rio.recvfrom(64)[0])[3] in (0, 1)
    finally:
        rio.close()
    cams = {r["cam_id"] for r in read_log(str(log)) if r["kind"] == "frame"}
    assert cams == {0, 1}


def test_observers_get_fresh_detections_and_poses(layout, frames):
    """Detection observers get each fresh camera's valid detections (one
    extra host copy, queued with the scalars), pose observers every
    published valid pose; the preview overlay draws them."""
    cv2 = pytest.importorskip("cv2")  # noqa: F841 (the overlay's encoder)
    from chalkydri_tpu_torch.subsystems.overlay import PreviewOverlay

    clock, rec = ManualClock(), Recorder()
    app = _port_app(layout, clock, rec)
    dets, poses = [], []
    overlay = PreviewOverlay()
    app.add_frame_observer(overlay.on_frame)
    app.add_detection_observer(overlay.on_detections)
    app.add_detection_observer(lambda *a: dets.append(a))
    app.add_pose_observer(lambda *a: poses.append(a))
    _drive(app, frames, clock, rec, {0: ["A", None], 1: [None, "blank"]})
    assert [d[0] for d in dets] == [0]  # camera 1's frame has no tags
    cam, ids, corners, margins = dets[0]
    assert sorted(ids.tolist()) == [3, 4] and corners.shape == (2, 4, 2)
    assert (margins > 0).all()
    assert [(p[0], p[3]) for p in poses] == [(0, 2)]
    annotated = overlay.annotate(0, frames["A"])
    green = (annotated[:, :, 1] > 200) & (annotated[:, :, 0] < 60)
    assert green.sum() > 50 and len(overlay.ring) >= 1


def test_app_publishes_robot_schema_over_nt(layout, frames):
    from chalkydri_tpu_torch.io.networktables import MiniNTServer

    srv = MiniNTServer().start()
    clock, rec = ManualClock(), Recorder()
    app = _port_app(layout, clock, rec, graph=_graph(n_cams=1),
                    ntables_ip=f"127.0.0.1:{srv.port}")
    try:
        app.start_all_tasks()
        app.fused_chains[0].camera._cap = ScriptedCap([frames["A"]] * 400)
        deadline = time.time() + 20
        while time.time() < deadline and \
                "/Chalkydri/Robot/Position/X" not in srv.values:
            clock.t += TICK_US
            app.run_one_iteration()
            time.sleep(0.02)
        assert any(k.startswith("/Chalkydri/Devices/") for k in srv.values)
        assert abs(srv.values["/Chalkydri/Robot/Position/X"]
                   - POSES["A"][0]) < 0.02
    finally:
        app.stop_all_tasks()
        app._nt.close()
        srv.stop()


def test_aaec_walks_exposure_toward_the_optimum(layout):
    """An ``Aaec`` graph node closes the loop metric -> controller ->
    camera exposure; the synthetic camera's gradient peaks at its optimum,
    so a badly over-exposed camera walks back toward it."""
    from chalkydri_tpu_torch.io.camera import SyntheticCapture

    d = _graph_dict(n_cams=1)
    d["tasks"].append({"id": "aaec", "type": "Aaec",
                       "config": {"period": 1, "step": 24}})
    app = _port_app(layout, comm=Recorder(), graph=TaskGraph.from_dict(d))
    assert app._aaec and app.fused_chains[0].aaec is not None
    app.start_all_tasks()
    cap = app.fused_chains[0].camera._cap
    assert isinstance(cap, SyntheticCapture)
    start = 400
    cap.set_exposure(start)
    app.fused_chains[0].aaec.exposure = start
    for _ in range(40):
        cap._last_emit = 0  # a fresh frame every poll
        app.run_one_iteration()
    app.stop_all_tasks()
    opt = SyntheticCapture.OPTIMAL_EXPOSURE
    assert abs(cap.exposure - opt) < 0.5 * abs(start - opt)
