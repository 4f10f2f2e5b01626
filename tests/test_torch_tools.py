"""The port's operator tools and host modules against the JAX package's, on
the CPU: the configurator (``generate``, the scripted interactive session,
``configure``'s caps listing, ``calibrate`` on rendered views), logread
(``dump`` and ``replay --device cpu`` on a log written by the port's
``runtime.logging``), the soak report (JAX's keys and projection
arithmetic), the USB update scan, the robot-side client, the codebook
generator (cv2) and the two example twins. Text outputs must be equal;
the soak's numbers are this machine's and only their schema and
arithmetic are compared."""

import ast
import io
import json
import os
import socket
import struct
import time
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from chalkydri_tpu.tools import configurator as jcfg
from chalkydri_tpu_torch.tools import configurator as tcfg

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


# -- configurator --------------------------------------------------------------

FLAG_CONFIGURES = (
    ["configure", "--name", "front", "--device", "/dev/video0", "--width",
     "1280", "--height", "800", "--cam-id", "0"],
    ["configure", "--name", "rear", "--device", "/dev/video2", "--width",
     "640", "--height", "480", "--cam-id", "1", "--offsets",
     '{"roll": 0.0, "pitch": 0.0, "yaw": 180.0, "x": -0.25, "y": 0.0, '
     '"z": 0.5}'],
)


def test_configurator_generate_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for name, main in (("jax", jcfg.main), ("port", tcfg.main)):
        for argv in FLAG_CONFIGURES:
            assert _run(main, ["--state", f"{name}.json", *argv])[0] == 0
        state = jcfg.ConfiguratorState.load(f"{name}.json")
        e = jcfg.CamConfigEntry(**state.cameras["front"])
        e.calib = '{"OpenCVModel5": {"fx": 1, "fy": 1, "cx": 0, "cy": 0}}'
        state.put("front", e)
        state.save(f"{name}.json")
        assert _run(main, ["--state", f"{name}.json", "generate",
                           "--output", f"{name}.ron"])[0] == 0
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    assert (tmp_path / "port.ron").read_text() == (tmp_path / "jax.ron").read_text()
    from chalkydri_tpu_torch.runtime.graph import TaskGraph

    assert len(TaskGraph.load("port.ron").chains()) == 2


def test_configurator_interactive_session_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    answers = ["front", "/dev/video0", "2", "0", "n", "n",
               "rear", "/dev/video2", "0", "1", "y",
               "-0.25", "0", "0.5", "0", "0", "180", "n",
               "", "y", "OUT.ron"]
    for name, main in (("jax", jcfg.main), ("port", tcfg.main)):
        it = iter([a.replace("OUT", name) for a in answers])
        monkeypatch.setattr("builtins.input", lambda prompt="", _it=it: next(_it))
        assert _run(main, ["--state", f"{name}.json", "configure",
                           "--interactive"])[0] == 0
    assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    assert (tmp_path / "port.ron").read_text() == (tmp_path / "jax.ron").read_text()

    def eof(prompt=""):
        raise EOFError

    monkeypatch.setattr("builtins.input", eof)
    assert _run(tcfg.main, ["--state", "eof.json", "configure",
                            "--interactive"])[0] == 0


def test_configure_lists_caps(tmp_path):
    state = str(tmp_path / "configurator.json")
    rc, out = _run(tcfg.main, ["--state", state, "configure", "--name", "camA",
                               "--device", "missing-dev", "--width", "1280",
                               "--height", "800", "--cam-id", "2"])
    assert rc == 0 and "configured camera 'camA'" in out
    assert tcfg.ConfiguratorState.load(state).entry("camA").width == 1280


class _Feed:
    """Views put in through ``camera._cap``, each once."""

    def __init__(self, frames):
        self.frames = list(frames)

    def latest(self):
        return (self.frames.pop(0), 0) if self.frames else None

    def close(self):
        pass


def test_configurator_calibrate_stores_the_solve(tmp_path, monkeypatch):
    """``calibrate`` on 4 rendered 640x480 views (put in through the
    camera's ``_cap``) stores the calib JSON of the port's Calibrator on
    the same views, string for string."""
    from chalkydri_tpu_torch.io.camera import CamPipeline
    from chalkydri_tpu_torch.tools.calibration import Calibrator
    from chalkydri_tpu_torch.tools.scenes import CALIB_LENS, board_views

    lens = dict(CALIB_LENS, cx=320.0, cy=240.0, width=640, height=480)
    frames, _, _ = board_views(4, lens, seed=5, distance=(0.5, 0.6))
    state = str(tmp_path / "c.json")
    assert _run(tcfg.main, ["--state", state, "configure", "--name", "cam",
                            "--device", "absent", "--width", "640",
                            "--height", "480"])[0] == 0
    monkeypatch.setattr(CamPipeline, "start",
                        lambda self, clock: setattr(self, "_cap", _Feed(frames)))
    rc, out = _run(tcfg.main, ["--state", state, "calibrate", "4", "--name",
                               "cam", "--device", "cpu", "--timeout", "60"])
    assert rc == 0 and "over 4 frames" in out
    cal = Calibrator(device="cpu")
    assert all(cal.process_frame(f) for f in frames)
    want = cal.calibrate().to_model(640, 480, device="cpu").to_json()
    assert tcfg.ConfiguratorState.load(state).entry("cam").calib == want


# -- logread -------------------------------------------------------------------


@pytest.fixture(scope="module")
def session_log(tmp_path_factory):
    """A log written by the port's UnifiedLogger: meta, two corpus frames
    (two cameras) and two poses."""
    from chalkydri_tpu_torch.io.whacknet import RobotPose, VisionUncertainty
    from chalkydri_tpu_torch.runtime.logging import UnifiedLogger
    from tests.reference_impl.corpus import build_parity_corpus

    path = str(tmp_path_factory.mktemp("log") / "s.ctlog")
    log = UnifiedLogger(path, meta={"graph": "x.ron"})
    for cam, (canvas, _) in enumerate(build_parity_corpus(2)):
        log.log_frame(cam, 1000 + cam, canvas[:470, :630])
    log.log_pose(0, 1234, RobotPose(1.5, 2.25, 0.125),
                 VisionUncertainty(0.1, 0.2, 0.3))
    log.log_pose(1, 99, RobotPose(-1.0, 0.5, 3.0), VisionUncertainty(9, 8, 7))
    log.close()
    return path


def test_logread_dump_matches_jax(session_log):
    from chalkydri_tpu.tools import logread as jlog
    from chalkydri_tpu_torch.tools import logread as tlog

    rc_j, want = _run(jlog.main, ["dump", session_log])
    rc_t, got = _run(tlog.main, ["dump", session_log])
    assert rc_j == rc_t == 0
    assert got == want and len(got.splitlines()) == 5


def test_logread_replay_matches_jax(session_log):
    from chalkydri_tpu.tools import logread as jlog
    from chalkydri_tpu_torch.tools import logread as tlog

    rc_j, want = _run(jlog.main, ["replay", session_log])
    rc_t, got = _run(tlog.main, ["replay", session_log, "--device", "cpu"])
    assert rc_j == rc_t == 0
    assert got == want
    assert [json.loads(x)["cam"] for x in got.splitlines()] == [0, 1]
    assert all(json.loads(x)["ids"] for x in got.splitlines())


def test_logread_replay_defaults_to_the_card(session_log, monkeypatch):
    from chalkydri_tpu_torch.tools import logread as tlog

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tlog.main(["replay", session_log])


# -- soak ----------------------------------------------------------------------


def _jax_soak_keys():
    """(report keys, latency-span keys) of the JAX soak, read from its
    source: the ``report`` dict of ``main`` and the dict
    ``_measure_latency_spans`` returns."""
    import chalkydri_tpu.tools.soak as jsoak

    with open(jsoak.__file__) as f:
        tree = ast.parse(f.read())
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    report = next(n.value for n in ast.walk(fns["main"])
                  if isinstance(n, ast.Assign)
                  and getattr(n.targets[0], "id", None) == "report")
    spans = next(n.value for n in ast.walk(fns["_measure_latency_spans"])
                 if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict))
    return ({k.value for k in report.keys}, {k.value for k in spans.keys})


def test_soak_report_has_jax_schema(capsys):
    from chalkydri_tpu_torch.tools.soak import main as soak_main

    rc = soak_main(["--seconds", "3", "--cams", "1", "--width", "320",
                    "--height", "240", "--json", "--device", "cpu"])
    assert rc == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    report_keys, span_keys = _jax_soak_keys()
    assert report_keys <= set(report), report_keys - set(report)
    spans = report["latency_spans"]
    assert set(spans) == span_keys
    assert report["iterations"] >= 2
    assert report["packets_rx"] >= 1
    assert "app.dispatch" in report["spans"]
    expected = (spans["host_capture_ms"] + spans["h2d_deploy_ms"]
                + spans["device_step_ms"] + spans["d2h_fetch_ms"]
                + spans["host_publish_ms"])
    assert abs(spans["projection_p50_ms"] - expected) < 0.01
    # each of the three is rounded to 1e-3 on its own
    assert abs(spans["h2d_put_ms"] - max(spans["h2d_put_ms_raw"]
                                         - spans["rtt_ms"], 0.0)) <= 0.0015
    assert spans["h2d_bytes"] == 1 * 240 * 320
    assert spans["h2d_deploy_ms"] == round(240 * 320 / 4e9 * 1e3, 3)
    assert report["device_mb_drift"] == 0.0  # no card: 0 by definition


# -- update, client, codebooks ---------------------------------------------------


def test_update_scan_and_stage_match_jax(tmp_path):
    from chalkydri_tpu.utils import update as jup
    from chalkydri_tpu_torch.utils import update as tup

    for sub, meta in (("usb/a", {"version": "1.2.0", "description": "a"}),
                      ("usb/b/c", {"version": "1.10.0"}),
                      ("usb/bad", None)):
        pkg = tmp_path / sub / "chalkydri-update"
        pkg.mkdir(parents=True)
        (pkg / "manifest.json").write_text(
            "{not json" if meta is None else json.dumps(meta))
        (pkg / "payload.bin").write_bytes(b"x" * 10)
    got = tup.scan_for_updates([str(tmp_path)])
    want = jup.scan_for_updates([str(tmp_path)])
    assert [(p.path, p.version, p.description) for p in got] == \
        [(p.path, p.version, p.description) for p in want]
    assert [p.version for p in got] == ["1.2.0", "1.10.0"]
    staged = tup.stage_update(got[0], str(tmp_path / "t"))
    assert staged == os.path.join(str(tmp_path / "t"), "update-1.2.0")
    assert sorted(os.listdir(staged)) == ["manifest.json", "payload.bin"]


def _free_port(kind=socket.SOCK_DGRAM):
    s = socket.socket(socket.AF_INET, kind)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_python_client_matches_jax():
    from chalkydri_tpu.clients.python_client import Chalkydri as JClient
    from chalkydri_tpu_torch.clients import Chalkydri, Pose2d
    from chalkydri_tpu_torch.io.whacknet import (
        RobotPose,
        VisionUncertainty,
        encode_measurement,
    )

    gyro_rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    gyro_rx.bind(("127.0.0.1", 0))
    gyro_rx.settimeout(5)
    gport = gyro_rx.getsockname()[1]
    clients = [cls(listen_port=_free_port(), coprocessor_addr="127.0.0.1",
                   gyro_port=gport) for cls in (Chalkydri, JClient)]
    packets = [
        encode_measurement(RobotPose(1.0, 2.0, 0.1),
                           VisionUncertainty(0.1, 0.1, 0.2), 1500, 0, 2),
        encode_measurement(RobotPose(1.2, 2.1, 0.3),
                           VisionUncertainty(0.2, 0.2, 0.1), 900, 1, 3),
        encode_measurement(RobotPose(9.0, 9.0, 3.0),
                           VisionUncertainty(0.1, 0.1, 0.1), 5, 2, 0),
        encode_measurement(RobotPose(5.0, 5.0, 1.0),
                           VisionUncertainty(1.7e308, 1.7e308, 1.7e308), 7, 3, 4),
    ]
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        for c in clients:
            for p in packets:
                tx.sendto(p, ("127.0.0.1", c._sock.getsockname()[1]))
        deadline = time.monotonic() + 5
        while any(c.get_camera(3) is None for c in clients):
            assert time.monotonic() < deadline, "packets never arrived"
            time.sleep(0.01)
        got, want = clients
        for cam in range(4):
            g, w = got.get_camera(cam), want.get_camera(cam)
            assert (g.pose.x, g.pose.y, g.pose.rotation, g.std_devs,
                    g.latency_us, g.tag_count) == \
                (w.pose.x, w.pose.y, w.pose.rotation, w.std_devs,
                 w.latency_us, w.tag_count)
        assert got.calculate_robot_pose() == want.calculate_robot_pose()
        assert isinstance(got.get_robot_pose(), Pose2d)
        got.send_gyro(0.75)
        want.send_gyro(0.75)
        assert gyro_rx.recvfrom(64)[0] == gyro_rx.recvfrom(64)[0] \
            == struct.pack("<d", 0.75)
    finally:
        tx.close()
        gyro_rx.close()
        for c in clients:
            c.close()


def test_gen_families_regenerates_checked_in_codebooks(tmp_path):
    pytest.importorskip("cv2")
    from chalkydri_tpu_torch.tools import gen_families

    assert os.path.samefile(
        gen_families.OUT_DIR,
        os.path.join(ROOT, "chalkydri_tpu_torch", "detector", "_data"))
    with redirect_stdout(io.StringIO()):
        gen_families.main(out_dir=str(tmp_path))
    for name, (_, dim, h) in gen_families.FAMILIES.items():
        with np.load(tmp_path / f"{name}.npz") as new, \
                np.load(os.path.join(gen_families.OUT_DIR, f"{name}.npz")) as old:
            assert np.array_equal(new["codes"], old["codes"]), name
            assert int(new["dim"]) == int(old["dim"]) == dim
            assert int(new["min_hamming"]) == int(old["min_hamming"]) == h


# -- the example twins -----------------------------------------------------------


def test_demo_twin_solves_the_true_pose():
    from chalkydri_tpu_torch.examples import demo

    out, (x, y, _) = demo.run("cpu")
    assert bool(out.pose_valid[0]) and int(out.tag_count[0]) == 2
    assert abs(float(out.pose_x[0]) - x) < 0.01
    assert abs(float(out.pose_y[0]) - y) < 0.01
    assert abs(float(out.pose_yaw[0])) < 0.01
    rc, text = _run(demo.main, ["--device", "cpu"])
    assert rc == 0 and "(valid=True, tags=2)" in text


def test_ml_subsystem_twin_matches_jax():
    import jax.numpy as jnp

    from chalkydri_tpu_torch.runtime.clock import RobotClock, Stamped, Tov
    from chalkydri_tpu_torch.runtime.tasks import ResourceManager
    from chalkydri_tpu_torch.subsystems.ml import MlSubsys
    from examples.ml_subsystem import model as jax_model

    rng = np.random.default_rng(3)
    frame = rng.normal(120, 10, (240, 320)).astype(np.float32)
    yy, xx = np.mgrid[:240, :320]
    frame[(xx - 211) ** 2 + (yy - 87) ** 2 <= 20 * 20] = 235
    frame = np.clip(frame, 0, 255).astype(np.uint8)
    want = jax_model(jnp.asarray(frame))
    res = ResourceManager()
    res.add("app.device", torch.device("cpu"))
    task = MlSubsys(
        config={"model": "chalkydri_tpu_torch.examples.ml_subsystem:model"},
        resources=res)
    task.process(RobotClock(), Stamped(frame, Tov(0)))
    got = task.last_output
    for k in ("x", "y", "radius"):
        assert float(got[k]) == float(want[k]), k
    assert abs(float(got["score"]) - float(want["score"])) <= \
        1e-4 * abs(float(want["score"]))
    assert abs(float(got["x"]) - 211) <= 3 and abs(float(got["y"]) - 87) <= 3
