"""The App's loop on a tiny rig on the CPU (``App(device="cpu")``),
through the harness's camera and roboRIO stand-ins, held to the plain
reference."""

import json

from benchmark.tests.conftest import run_in


def _run(root, *args):
    p = run_in(root, ["benchmark.tests.tiny", *args])
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_saturate_every_polled_frame_gets_its_packet(tiny_checkout):
    r = _run(tiny_checkout, "--workload", "tiny-saturate", "--seconds", "2")
    assert r["correct"], r["checks"]
    assert r["attempted"] == sum(r["polled"]) > 0 and r["failed"] == 0
    assert r["frames_compared"] == r["attempted"]
    assert set(r["metrics"]) == {"frames_per_s", "setup_s"}
    assert r["metrics"]["frames_per_s"]["value"] > 0


def test_live_cameras_run_half_a_period_apart(tiny_checkout):
    r = _run(tiny_checkout, "--workload", "tiny-live", "--seconds", "3")
    assert r["correct"], r["checks"]
    # 4 fps a camera for 3 s: 12 frames each, offered whether polled or not
    assert r["attempted"] == 24
    assert set(r["metrics"]) == {"pose_latency_p50_ms", "setup_s"}
    assert r["metrics"]["pose_latency_p50_ms"]["value"] > 0


def test_traced_run_reports_per_layer_metrics(tiny_checkout):
    r = _run(tiny_checkout, "--workload", "tiny-saturate", "--seconds", "2",
             "--trace", "1")
    assert r["correct"]
    assert "app_dispatch_ms.saturate" in r["metrics"]
    assert r["device"]["window_s"] > 0 and "breakdown" in r
