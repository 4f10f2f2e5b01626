"""The port's host modules against the JAX package's (same inputs, equal
outputs), and what only the port has: its native build outside the source
tree, its kernel library's first use across threads, its device
resolution and its NT4 reader's handling of a truncated float64.

Floats: the exposure metric is a float32 convolution summed in another
order (XLA's and torch's CPU kernels): rtol 1e-5. Everything else is
equal. Sockets bind port 0 (ephemeral).
"""

import base64
import dataclasses
import hashlib
import os
import socket
import struct
import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chalkydri_tpu.detector.families import load_family as jax_load_family
from chalkydri_tpu.io import camera as jax_camera
from chalkydri_tpu.io import config as jax_config
from chalkydri_tpu.io import whacknet as jax_whacknet
from chalkydri_tpu.runtime import graph as jax_graph
from chalkydri_tpu.runtime import logging as jax_log
from chalkydri_tpu.subsystems import aaec as jax_aaec
from chalkydri_tpu_torch.detector.families import load_family
from chalkydri_tpu_torch.io import camera, config, whacknet
from chalkydri_tpu_torch.ops import build
from chalkydri_tpu_torch.runtime import graph
from chalkydri_tpu_torch.runtime import logging as port_log
from chalkydri_tpu_torch.runtime.clock import RobotClock, Stamped, Tov
from chalkydri_tpu_torch.subsystems import aaec
from chalkydri_tpu_torch.utils.platform import resolve_device
from chalkydri_tpu_torch.utils.tracing import SpanStats, device_trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE_GRAPH = os.path.join(ROOT, "examples", "chalkydri.ron")

TOML = """
team_number = 4533
ntables_ip = "10.45.33.2"
device_name = "coproc-a"

[mesh]
data = 2
space = 4

[[cameras]]
id = "/dev/video0"
name = "front"
orientation = "clockwise"

[cameras.subsystems.capriltags]
capacity_fallback = true
"""


def _graph_view(g):
    return ([(t.id, t.type, t.config) for t in g.tasks],
            [(e.src, e.dst, e.msg) for e in g.edges],
            [(r.id, r.provider) for r in g.resources],
            g.chains(), g.topo_order())


def test_task_graph_matches_jax():
    got, want = (graph.TaskGraph.load(EXAMPLE_GRAPH),
                 jax_graph.TaskGraph.load(EXAMPLE_GRAPH))
    assert _graph_view(got) == _graph_view(want)
    assert got.dumps() == want.dumps()
    assert _graph_view(graph.TaskGraph.loads(got.dumps())) == _graph_view(got)


def test_config_matches_jax(tmp_path):
    got, want = config.Config.loads(TOML), jax_config.Config.loads(TOML)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.mesh == config.MeshCfg(data=2, space=4)
    assert got.cameras[0].subsystems.capriltags.capacity_fallback
    assert got.dumps() == want.dumps()
    # /boot -> /etc -> ./ : the first file that parses wins
    bad, good = tmp_path / "bad.toml", tmp_path / "good.toml"
    bad.write_text("team_number = = 1\n")
    good.write_text("team_number = 254\n")
    paths = [str(tmp_path / "absent.toml"), str(bad), str(good)]
    assert (dataclasses.asdict(config.Config.load_with_fallback(paths))
            == dataclasses.asdict(jax_config.Config.load_with_fallback(paths)))
    assert config.Config.load_with_fallback(paths).team_number == 254
    assert config.Config.load_with_fallback(paths[:1]) == config.Config()


@pytest.mark.parametrize("pose,std,ts,cam,n", [
    ((1.5, -2.25, 3.0), (0.01, 0.02, 0.003), 12345, 0, 4),
    ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), 0, 255, 0),
    ((-8.1, 4.05, -3.14159), (1e-9, 2.5, 1e3), 2 ** 64 + 7, 300, 257),
])
def test_packets_equal_jax(pose, std, ts, cam, n):
    got = whacknet.encode_measurement(whacknet.RobotPose(*pose),
                                      whacknet.VisionUncertainty(*std),
                                      ts, cam, n)
    want = jax_whacknet.encode_measurement(jax_whacknet.RobotPose(*pose),
                                           jax_whacknet.VisionUncertainty(*std),
                                           ts, cam, n)
    assert got == want and len(got) == whacknet.PACKET_SIZE == 64
    assert (whacknet.decode_measurement(got)[2:]
            == jax_whacknet.decode_measurement(want)[2:])
    assert whacknet.team_ip(4533) == jax_whacknet.team_ip(4533) == "10.45.33.2"


@pytest.mark.parametrize("use_native", [False, True])
def test_comm_sends_the_packet_bytes_and_reads_the_gyro(use_native):
    """Both Comm paths: the datagram is encode_measurement's bytes, and a
    little-endian float64 on the gyro port reads back."""
    from chalkydri_tpu_torch.native import BUILD_DIR, library_path, load_native

    if use_native and load_native() is None:
        pytest.skip("no C++ toolchain: the native path cannot build")
    rio = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rio.bind(("127.0.0.1", 0))
    rio.settimeout(5.0)
    probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    probe.bind(("127.0.0.1", 0))
    gyro_port = probe.getsockname()[1]
    probe.close()
    comm = whacknet.Comm(remote_addr="127.0.0.1",
                         remote_port=rio.getsockname()[1],
                         gyro_port=gyro_port, use_native=use_native)
    robot = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        assert (comm._native is not None) == use_native
        if use_native:  # built outside the source tree
            assert os.path.exists(library_path())
            assert os.path.dirname(library_path()) == BUILD_DIR
            assert not any(f.endswith(".so") for f in os.listdir(
                os.path.dirname(whacknet.__file__).replace("io", "native")))
        pose, std = whacknet.RobotPose(1.0, 2.0, 0.5), whacknet.VisionUncertainty(
            0.1, 0.2, 0.3)
        comm.publish(3, 4, 777, pose, std)
        assert rio.recvfrom(64)[0] == jax_whacknet.encode_measurement(
            jax_whacknet.RobotPose(1.0, 2.0, 0.5),
            jax_whacknet.VisionUncertainty(0.1, 0.2, 0.3), 777, 3, 4)
        deadline = time.time() + 5
        while comm.gyro_angle() != -1.25 and time.time() < deadline:
            robot.sendto(struct.pack("<d", -1.25), ("127.0.0.1", gyro_port))
            time.sleep(0.01)
        assert comm.gyro_angle() == -1.25
    finally:
        comm.close()
        rio.close()
        robot.close()


@pytest.mark.parametrize("use_native", [False, True])
def test_comm_keeps_the_order_of_a_burst(use_native):
    """Both Comm paths: a burst of packets (sent at once from the
    publishing thread while nothing waits before them, else queued)
    arrives whole and in the order published."""
    from chalkydri_tpu_torch.native import load_native

    if use_native and load_native() is None:
        pytest.skip("no C++ toolchain: the native path cannot build")
    rio = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rio.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 20)
    rio.bind(("127.0.0.1", 0))
    rio.settimeout(5.0)
    probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    probe.bind(("127.0.0.1", 0))
    gyro_port = probe.getsockname()[1]
    probe.close()
    comm = whacknet.Comm(remote_addr="127.0.0.1",
                         remote_port=rio.getsockname()[1],
                         gyro_port=gyro_port, use_native=use_native)
    try:
        n = 48  # under the native queue's bound of 64
        for ts in range(n):
            comm.publish(ts % 2, 1, ts, whacknet.RobotPose(float(ts), 0.0, 0.0),
                         whacknet.VisionUncertainty())
        got = [whacknet.decode_measurement(rio.recvfrom(64)[0])[2]
               for _ in range(n)]
        assert got == list(range(n))
    finally:
        comm.close()
        rio.close()
        for t in (getattr(comm, "_send_thread", None),
                  getattr(comm, "_gyro_thread", None)):
            if t is not None:  # the Python path's threads end within 0.2 s
                t.join(timeout=5.0)
                assert not t.is_alive()



class _WouldBlock:
    """A Comm's send socket whose non-blocking sends in ``blocked`` (by
    the count of non-blocking tries) fail as a full buffer does; blocking
    sends, the sender thread's, go through."""

    def __init__(self, sock, blocked):
        self._sock, self._blocked, self._tries = sock, blocked, 0

    def sendto(self, data, *args):
        if len(args) == 2:  # (flags, address): the publishing thread's try
            self._tries += 1
            if self._blocked(self._tries):
                raise BlockingIOError(11, "Resource temporarily unavailable")
        return self._sock.sendto(data, *args)

    def close(self):
        self._sock.close()


@pytest.mark.parametrize("blocked", ["first", "every third", "all"])
def test_comm_queues_a_send_that_would_block(blocked):
    """The Python path under socket backpressure: a send that would block
    goes to the queue, later packets queue behind it until the sender
    thread has sent it, and all arrive, in the order published, from the
    one source port."""
    rule = {"first": lambda n: n == 1, "every third": lambda n: n % 3 == 0,
            "all": lambda n: True}[blocked]
    rio = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rio.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 20)
    rio.bind(("127.0.0.1", 0))
    rio.settimeout(5.0)
    probe = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    probe.bind(("127.0.0.1", 0))
    gyro_port = probe.getsockname()[1]
    probe.close()
    comm = whacknet.Comm(remote_addr="127.0.0.1",
                         remote_port=rio.getsockname()[1],
                         gyro_port=gyro_port, use_native=False)
    sock = _WouldBlock(comm._send_sock, rule)
    comm._send_sock = sock
    try:
        n = 48
        for ts in range(n):
            comm.publish(0, 1, ts, whacknet.RobotPose(float(ts), 0.0, 0.0),
                         whacknet.VisionUncertainty())
        got = [rio.recvfrom(64) for _ in range(n)]
        assert [whacknet.decode_measurement(d)[2] for d, _ in got] == list(
            range(n))
        assert len({addr for _, addr in got}) == 1
        assert sock._tries >= 1
    finally:
        comm.close()
        comm._send_thread.join(timeout=5.0)
        comm._gyro_thread.join(timeout=5.0)
        rio.close()
        assert not comm._send_thread.is_alive()


def test_native_library_is_named_by_its_sources(tmp_path, monkeypatch):
    """The native library's path changes with any byte of ``native/src``
    (so a tree built before a change builds anew), and with nothing
    else."""
    import shutil

    import chalkydri_tpu_torch.native as native

    src = tmp_path / "native" / "src"
    shutil.copytree(native._SRC_DIR, src)
    shutil.copy(os.path.join(native._DIR, "Makefile"), tmp_path / "native")
    monkeypatch.setattr(native, "_SRC_DIR", str(src))
    first = native.library_path()
    assert first == native.library_path()
    assert os.path.dirname(first) == native.BUILD_DIR
    with open(src / "whacknet.cpp", "a") as f:
        f.write("// changed\n")
    assert native.library_path() != first

def _write_log(mod, path, frame):
    log = mod.UnifiedLogger(path, meta={"graph": "g.ron"})
    log.log_frame(1, 123, frame)
    log.log_pose(1, 456, mod.RobotPose(1.0, 2.0, 0.1),
                 mod.VisionUncertainty(0.01, 0.02, 0.03))
    log.close()


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_unified_log_reads_across(tmp_path, writer, reader):
    mods = {"port": port_log, "jax": jax_log}
    frame = np.random.default_rng(5).integers(0, 256, (6, 10), dtype=np.uint8)
    path = str(tmp_path / "run.ctlog")
    _write_log(mods[writer], path, frame)
    recs = list(mods[reader].read_log(path))
    assert [r["kind"] for r in recs] == ["meta", "frame", "pose"]
    assert recs[0]["meta"] == {"graph": "g.ron"}
    np.testing.assert_array_equal(recs[1]["frame"], frame)
    assert (recs[1]["cam_id"], recs[1]["tov_us"]) == (1, 123)
    assert recs[2]["latency_us"] == 456 and recs[2]["pose"].y == 2.0
    other = str(tmp_path / "other.ctlog")
    _write_log(mods[reader], other, frame)
    with open(path, "rb") as a, open(other, "rb") as b:
        assert a.read() == b.read()
    replay = list(port_log.replay_frames(path))
    assert replay[0][:2] == (1, 123)


@pytest.mark.parametrize("family", ["tag36h11", "tag16h5"])
def test_synthetic_frames_bit_equal(family):
    fam, jfam = load_family(family), jax_load_family(family)
    for phase in range(camera.SyntheticCapture.N_PHASES):
        np.testing.assert_array_equal(
            camera._render_synthetic(fam, 320, 240, (3, 4), phase),
            jax_camera._render_synthetic(jfam, 320, 240, (3, 4), phase),
            err_msg=f"phase {phase}")


def test_synthetic_exposure_lut_bit_equal():
    caps = [camera.SyntheticCapture(320, 240),
            jax_camera.SyntheticCapture(320, 240)]
    for exposure in (100, 37, 400):
        frames = []
        for cap in caps:
            cap.set_exposure(exposure)
            cap._last_emit = 0  # emit on this poll
            frames.append(cap.latest()[0])
        np.testing.assert_array_equal(*frames, err_msg=f"exposure {exposure}")


def test_exposure_gradients_match_jax():
    frames = np.random.default_rng(7).integers(0, 256, (3, 40, 56),
                                               dtype=np.uint8)
    frames[1] = 128  # flat: the metric's floor, sqrt(1e-6)
    got = aaec.compute_exposure_gradients(torch.from_numpy(frames))
    want = np.asarray(jax_aaec.compute_exposure_gradients(jnp.asarray(frames)))
    assert got.dtype == torch.float32 and got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)


def test_exposure_controller_trajectory_equals_jax():
    metrics = np.random.default_rng(3).uniform(10, 50, 40).tolist()
    ctl, jctl = (aaec.ExposureController(initial=400, step=24),
                 jax_aaec.ExposureController(initial=400, step=24))
    assert [ctl.update(m) for m in metrics] == [jctl.update(m) for m in metrics]


def test_nt4_reader_survives_a_truncated_double():
    """Once the client has published (so its handshake read is over), the
    server sends a binary frame holding a float64 tag with 2 of its 8
    bytes (``struct.error`` in the decoder), then a good value frame: the
    reader drops the bad frame, stays alive and records the good value."""
    from chalkydri_tpu_torch.io.networktables import (
        _WS_GUID,
        NT4Client,
        _ws_send,
        msgpack_encode,
    )

    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    conns = []

    def serve():
        conn, _ = srv.accept()
        conns.append(conn)
        req = b""
        while b"\r\n\r\n" not in req:
            req += conn.recv(4096)
        key = next(line.split(":", 1)[1].strip()
                   for line in req.decode().split("\r\n")
                   if line.lower().startswith("sec-websocket-key:"))
        accept = base64.b64encode(
            hashlib.sha1((key + _WS_GUID).encode()).digest()).decode()
        conn.sendall(("HTTP/1.1 101 Switching Protocols\r\n"
                      "Upgrade: websocket\r\nConnection: Upgrade\r\n"
                      f"Sec-WebSocket-Accept: {accept}\r\n\r\n").encode())
        conn.recv(4096)  # the client's first frame
        _ws_send(conn, b"\xcb\x00\x00", opcode=0x2, mask=False)
        _ws_send(conn, msgpack_encode([5, 1000, 1, 2.5]), opcode=0x2,
                 mask=False)

    server = threading.Thread(target=serve, daemon=True)
    server.start()
    client = NT4Client("127.0.0.1", srv.getsockname()[1], reconnect=False)
    try:
        client.connect(timeout=5.0, sync=False)
        client.publish("/hello", 1.0)
        deadline = time.time() + 10
        while "id5" not in client.values and time.time() < deadline:
            time.sleep(0.01)
        assert client.values.get("id5") == (2.5, 1000)  # topic 5, unannounced
        assert client._reader.is_alive()
    finally:
        client.close()
        server.join(timeout=5)
        for c in conns:
            c.close()
        srv.close()


def test_kernel_library_builds_once_across_threads(tmp_path, monkeypatch):
    """Two threads at a first kernel call: one build, one load, the same
    library for both (nvcc and the loader stubbed)."""
    calls = {"compile": 0, "link": 0, "load": 0}

    def fake_run_all(cmds):
        time.sleep(0.05)  # widen the window a racing thread would use
        for cmd in cmds:
            calls["link" if "-shared" in cmd else "compile"] += 1
            with open(cmd[cmd.index("-o") + 1], "w") as f:
                f.write("x")

    class FakeLib:
        def __init__(self, path):
            calls["load"] += 1
            self.path = path

        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build, "_run_all", fake_run_all)
    monkeypatch.setattr(build.ctypes, "CDLL", FakeLib)
    monkeypatch.setattr(build, "_LIBRARY", None)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        barrier = threading.Barrier(4)
        libs = []

        def first_call():
            barrier.wait()
            libs.append(build.kernel_library())

        threads = [threading.Thread(target=first_call) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert calls == {"compile": len(build.SOURCES), "link": 1, "load": 1}
    assert len(libs) == 4 and all(lib is libs[0] for lib in libs)
    assert os.listdir(tmp_path) == [os.path.basename(build.library_path())]


def test_device_resolution(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda:1")


def test_span_percentiles_and_device_trace(tmp_path):
    stats = SpanStats()
    for ms in range(1, 11):
        stats.record("s", ms / 1e3)
    s = stats.summary()["s"]
    assert s["n"] == 10 and s["p50_ms"] == pytest.approx(5.0)
    assert s["p90_ms"] == pytest.approx(9.0)
    assert s["max_ms"] == pytest.approx(10.0)
    stats.reset()
    assert stats.summary() == {}
    with device_trace(str(tmp_path)) as prof:
        torch.ones(4).sum()
    assert prof is not None and (tmp_path / "trace.json").exists()


def test_ml_subsystem_runs_on_the_apps_device():
    from chalkydri_tpu_torch.runtime.tasks import ResourceManager
    from chalkydri_tpu_torch.subsystems.ml import MlSubsys

    res = ResourceManager()
    res.add("app.device", torch.device("cpu"))
    task = MlSubsys(config={}, resources=res)
    task.attach(lambda x: x.float().mean())
    task.process(RobotClock(), Stamped(np.full((4, 6), 3, np.uint8), Tov(1)))
    assert task.device == torch.device("cpu")
    assert task.last_output.device.type == "cpu"
    assert float(task.last_output) == 3.0
