"""The four-camera rig (``configs/north-4x1280x800-qd2.json``): its traffic
lays quarter-period offsets over ``live``; a tiny rig of four cameras a
quarter period apart (``data/configs/tiny4-320x256-qd2.json``) runs
through the App on the CPU, held to the plain reference; and the reader of
``fresh_slot_pct.live`` on a synthetic ``Context`` and ``SPANS``: the
App's fresh slots over its slots in the untraced stretch, None where there
is no record or the program keeps no counters."""

import json
import os

import pytest

from benchmark import harness
from benchmark.tests.conftest import add_tiny_cells, copy_checkout, run_in
from benchmark.trace import Context, StepTimes, load_module
from chalkydri_tpu_torch.utils import tracing

TINY4_CELL = {"name": "tiny4-live", "config": "tiny4-320x256-qd2",
              "traffic": "tiny-live", "chips": 1,
              "why": "the harness on the CPU: four cameras a quarter period "
                     "apart at 4 fps"}
HOST0 = 5_000_000_000  # the stretch's first dispatch, host ns
PERIOD = 10_000_000  # a dispatch every 10 ms


@pytest.fixture(scope="module")
def four_checkout(tmp_path_factory):
    """The tiny checkout with the cell ``tiny4-live`` added, reporting
    every metric ``tiny-live`` reports."""
    root = copy_checkout(str(tmp_path_factory.mktemp("checkout4")))
    add_tiny_cells(root)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["workloads"].append(TINY4_CELL)
    for m in bench["end_to_end"] + bench["per_layer"]:
        cells = m.get("workloads")
        if cells is not None and "tiny-live" in cells:
            cells.append(TINY4_CELL["name"])
    with open(path, "w") as f:
        json.dump(bench, f)
    return root


def test_north_traffic_puts_the_cameras_a_quarter_period_apart():
    traffic = harness.load_traffic("live", "north-4x1280x800-qd2")
    assert traffic["offset_periods"] == [0.0, 0.25, 0.5, 0.75]
    assert 0 < traffic["rate_fps"] <= 60  # the configuration's frame rate
    cams = [harness.StandInCamera([], 1280, 800) for _ in range(4)]
    harness.arm_all(cams, traffic, 0, 10**9)
    rate = traffic["rate_fps"]
    assert [c.offset_ns for c in cams] == [round(i / 4 * 1e9 / rate)
                                           for i in range(4)]


def test_four_cameras_a_quarter_period_apart(four_checkout):
    p = run_in(four_checkout, ["benchmark.tests.tiny", "--workload",
                               "tiny4-live", "--seconds", "3"])
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    # 4 fps a camera for 3 s: 12 frames each, offered whether polled or not
    assert r["attempted"] == 4 * 12
    assert len(r["polled"]) == 4 and min(r["polled"]) > 0
    assert r["frames_compared"] == sum(r["polled"])
    assert set(r["metrics"]) == {"pose_latency_p50_ms", "setup_s"}


def context(n_dispatches: int = 6) -> Context:
    steps = StepTimes(starts=[10.0 * i for i in range(n_dispatches)],
                      ends=[10.0 * i + 9 for i in range(n_dispatches)],
                      host_starts=[HOST0 + PERIOD * i
                                   for i in range(n_dispatches)], host=[])
    return Context(workload={"name": "w"}, config={}, traffic={}, trace=None,
                   dispatch_ms=[], scene=None, device="cuda", steps=steps)


@pytest.fixture
def spans(monkeypatch):
    fresh = tracing.SpanStats()
    monkeypatch.setattr(tracing, "SPANS", fresh)
    return fresh


def test_fresh_slot_pct_sums_the_untraced_stretchs_counts(spans):
    reader = load_module("metrics", "fresh_slot_pct.live")
    spans.count("app.slots_fresh", 4, HOST0 - 1)  # before the stretch
    spans.count("app.slots", 4, HOST0 - 1)
    inside = [1, 1, 2, 1, 4]
    for i, n in enumerate(inside):
        spans.count("app.slots_fresh", n, HOST0 + PERIOD * i + 1000)
        spans.count("app.slots", 4, HOST0 + PERIOD * i + 1000)
    spans.count("app.slots_fresh", 4, HOST0 + PERIOD * 6)  # traced second
    spans.count("app.slots", 4, HOST0 + PERIOD * 6)
    assert reader.read(context()) == pytest.approx(100.0 * 9 / 20)


def test_fresh_slot_pct_none_without_counts(spans, monkeypatch):
    reader = load_module("metrics", "fresh_slot_pct.live")
    assert reader.read(context()) is None
    spans.count("app.slots_fresh", 1, HOST0 - 1)  # outside the stretch
    spans.count("app.slots", 4, HOST0 - 1)
    assert reader.read(context()) is None
    spans.count("app.slots_fresh", 1, HOST0 + 1)
    spans.count("app.slots", 4, HOST0 + 1)
    ctx = context()
    ctx.steps = None  # a CPU run, or a run without a card's events
    assert reader.read(ctx) is None

    class OldSpans:  # SpanStats before it kept counters
        samples = {}

        def between(self, name, t0, t1):
            return []

    monkeypatch.setattr(tracing, "SPANS", OldSpans())
    assert reader.read(context()) is None
