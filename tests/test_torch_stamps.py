"""The step's own stage stamps and the span records
(``chalkydri_tpu_torch/utils/tracing.py``).

On the CPU:
- ``SpanStats`` keeps each sample's start beside it (``starts``, the same
  length as ``samples``, which stays float seconds), ``between`` selects
  by start, ``summary()`` keeps its keys, and ``span()`` records its start
  on ``time.monotonic_ns()``;
- a stamp vector and a clock map give the six ``step.*`` durations,
  ``step.span`` and their starts on the host clock;
- the clock map takes the shortest round trip, its offset from that
  trip's middle and half of it as its error bound;
- ``stage`` does nothing outside a stamped step and on the CPU, so the CPU
  step leaves no stamps, and the App on the CPU tiny rig records no
  ``step.*`` record while it publishes a pose for each frame.

On a card (marked ``cuda``, skipped without one): the replayed step with
its stamps equals the eager step bit for bit, its stamps do not decrease
and their stages sum to the span, and in the App at ``pipeline_depth`` 1
the stamps of replay N survive replay N+1 being enqueued before N is
fetched. This file imports no JAX, so on the card machine:
``python -m pytest --noconftest tests/test_torch_stamps.py -m cuda -q``.
"""

import time

import numpy as np
import pytest
import torch

from chalkydri_tpu_torch.pipeline import (
    build_rig_from_config,
    make_vision_pipeline,
)
from chalkydri_tpu_torch.tools.scenes import TINY_CALIB, render_tiny, tiny_rig
from chalkydri_tpu_torch.utils import graph, tracing
from chalkydri_tpu_torch.utils.tracing import (
    STAGE_RECORDS,
    STAGES,
    ClockMap,
    SpanStats,
    stage_records,
)

torch.set_num_threads(1)

BATCH = 2


# -- span records and their starts -------------------------------------------


def test_span_stats_keep_a_start_beside_each_float_sample():
    stats = SpanStats()
    for i in range(1, 11):
        stats.record("s", i / 1e3, start_ns=1000 * i)
    stats.record("s", 0.5)  # no start known
    assert list(stats.samples["s"]) == [i / 1e3 for i in range(1, 11)] + [0.5]
    assert all(type(x) is float for x in stats.samples["s"])
    assert list(stats.starts["s"]) == [1000 * i for i in range(1, 11)] + [None]
    assert stats.between("s", 3000, 5000) == [0.003, 0.004, 0.005]
    assert stats.between("other", 0, 10 ** 18) == []
    assert set(stats.summary()["s"]) == {"n", "mean_ms", "max_ms", "p50_ms",
                                         "p90_ms"}
    stats.reset()
    assert stats.summary() == {} and not stats.starts


def test_span_stats_starts_roll_with_their_samples(monkeypatch):
    from chalkydri_tpu_torch.utils import tracing as tr

    monkeypatch.setattr(tr, "SAMPLES_KEPT", 4)
    stats = SpanStats()
    for i in range(10):
        stats.record("s", float(i), start_ns=i)
    assert list(stats.samples["s"]) == [6.0, 7.0, 8.0, 9.0]
    assert list(stats.starts["s"]) == [6, 7, 8, 9]
    assert stats.stats["s"][0] == 10


def test_span_records_its_start_on_the_monotonic_clock():
    before = time.monotonic_ns()
    with tracing.span("test.span"):
        time.sleep(0.002)
    after = time.monotonic_ns()
    start = tracing.SPANS.starts["test.span"][-1]
    dt = tracing.SPANS.samples["test.span"][-1]
    assert before <= start <= after and isinstance(dt, float)
    assert 0.002 <= dt <= (after - start) / 1e9


# -- stamps to records --------------------------------------------------------


def test_stamps_give_six_stages_and_the_span():
    stamps = [10_000, 12_000, 12_500, 15_500, 16_000, 20_000, 29_000]
    clock = ClockMap(offset_ns=4_000, error_ns=3)
    got = stage_records(np.array(stamps, dtype=np.int64), clock)
    assert [name for name, _, _ in got] == list(STAGE_RECORDS)
    durations = dict((n, dt) for n, dt, _ in got)
    assert durations == pytest.approx({
        "step.front": 2e-6, "step.cluster": 0.5e-6, "step.quad": 3e-6,
        "step.refine": 0.5e-6, "step.decode": 4e-6, "step.solve": 9e-6,
        "step.span": 19e-6})
    assert sum(durations[n] for n in STAGE_RECORDS[:-1]) == pytest.approx(
        durations["step.span"])
    starts = [t for _, _, t in got]
    assert starts == [6_000, 8_000, 8_500, 11_500, 12_000, 16_000, 6_000]
    assert all(t is None for _, _, t in stage_records(stamps, None))


def test_record_stages_goes_to_the_spans_with_the_cards_clock(monkeypatch):
    card = torch.device("cuda", 0)
    monkeypatch.setitem(tracing._CLOCKS, card, ClockMap(100, 1))
    stats = SpanStats()
    tracing.record_stages([1100, 1200, 1300, 1400, 1500, 1600, 1700], card,
                          stats)
    assert set(stats.samples) == set(STAGE_RECORDS)
    assert stats.starts["step.front"][0] == 1000
    assert stats.starts["step.solve"][0] == 1500
    tracing.record_stages([0] * 7, torch.device("cuda", 1), stats)
    assert stats.starts["step.span"][-1] is None  # no map for that card


def test_clock_map_takes_the_shortest_round_trip():
    trips = [(1_000, 50_700, 1_900),  # 900 ns
             (5_000, 54_230, 5_060),  # 60 ns: this one
             (9_000, 58_000, 9_300)]
    m = ClockMap.from_round_trips(trips)
    assert m == ClockMap(offset_ns=54_230 - 5_030, error_ns=30)
    assert m.host_ns(54_230) == 5_030
    assert ClockMap.from_round_trips([(0, 7, 5)]).error_ns == 3  # half, up


# -- no stamps off the card ---------------------------------------------------


def test_stage_does_nothing_outside_a_card_step():
    tracing.take_stamps()
    tracing.stage("front")  # no step open
    with tracing.step_stamps("cpu"):
        tracing.stage("front")
    assert tracing.take_stamps() is None


def tiny_step(device="cpu"):
    layout, cams = tiny_rig()
    params, rc = build_rig_from_config(cams * BATCH, layout, device=device)
    step = make_vision_pipeline(layout.to(device), params, rc, device=device)
    frames = torch.from_numpy(render_tiny(layout, rc, BATCH)).to(device)
    gyro = torch.zeros(BATCH, dtype=torch.float32, device=device)
    return step, frames, gyro


def test_cpu_step_leaves_no_stamps():
    step, frames, gyro = tiny_step()
    out = step(frames, gyro)
    assert bool(out.pose_valid.all())
    assert tracing.take_stamps() is None


# -- the App ------------------------------------------------------------------


class Comm:
    """A Comm stand-in that records each publish."""

    def __init__(self):
        self.packets = []

    def publish(self, cam_id, tag_count, ts_us, pose, std):
        self.packets.append((cam_id, tag_count, (pose.x, pose.y, pose.rot)))

    def gyro_angle(self):
        return 0.0

    def close(self):
        pass


class Cap:
    """A capture handing out ``frame`` at each poll."""

    def __init__(self, frame):
        self.frame = frame

    def latest(self):
        return self.frame, 0

    def close(self):
        pass


def tiny_app(device, iters: int):
    """The App over two cameras of the tiny rig at ``pipeline_depth`` 1,
    run ``iters`` iterations on the tiny frame, then stopped; returns its
    Comm stand-in and the direct step's output on the same frames."""
    from chalkydri_tpu_torch.runtime import App, TaskGraph

    layout, cams = tiny_rig()
    tasks, cnx = [], []
    for i in range(BATCH):
        tasks += [
            {"id": f"camera_{i}", "type": "CamPipeline",
             "config": {"id": f"missing-dev-{i}", "name": f"c{i}",
                        "width": TINY_CALIB["width"],
                        "height": TINY_CALIB["height"]}},
            {"id": f"apriltags_{i}", "type": "chalkydri_apriltags::AprilTags",
             "config": {"cam_id": i, "calib": cams[0]["calib"],
                        "robot_to_cam": cams[0]["robot_to_cam"]}}]
        cnx.append({"src": f"camera_{i}", "dst": f"apriltags_{i}",
                    "msg": "frame"})
    graph_ = TaskGraph.from_dict(
        {"tasks": tasks, "cnx": cnx,
         "resources": [{"id": "comm", "provider": "whacknet::CommBundle"}]})
    comm = Comm()
    app = App(graph_, field_layout=layout.to(device), comm=comm,
              device=device, pipeline_depth=1)
    _, rc = build_rig_from_config(cams, layout, device="cpu")
    frame = render_tiny(layout, rc, 1)[0]
    app.start_all_tasks()
    for ch in app.fused_chains:
        ch.camera._cap = Cap(frame)
    for _ in range(iters):
        app.run_one_iteration()
    app.stop_all_tasks()
    step, frames, gyro = tiny_step(device)
    return comm, getattr(step, "module", step)(frames, gyro)


def test_cpu_app_records_no_stage_stamps():
    tracing.SPANS.reset()
    comm, want = tiny_app("cpu", iters=3)
    assert not [k for k in tracing.SPANS.samples if k.startswith("step.")]
    assert "graph.replay" not in tracing.SPANS.samples
    assert len(tracing.SPANS.starts["app.dispatch"]) == 3
    poses = [p for p in comm.packets if p[1] > 0]
    assert len(poses) == 3 * BATCH  # the in-flight step published at stop
    for cam, n_tags, pose in poses:
        assert n_tags == int(want.tag_count[cam])
        assert pose == (float(want.pose_x[cam]), float(want.pose_y[cam]),
                        float(want.pose_yaw[cam]))


# -- on a card ----------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def leaves(out) -> list:
    return [*out[:-1], *out.detections]


@pytest.mark.cuda
def test_replayed_step_with_stamps_equals_eager(card):
    step, frames, gyro = tiny_step(card)
    assert isinstance(step, graph.CapturedStep)
    inputs = [(frames, gyro), (frames ^ 1, gyro + 0.01)]
    eager = [step.module(*x) for x in inputs]
    assert tracing.take_stamps() is not None  # the eager step stamps too
    for i in range(4):
        out = step(*inputs[i % 2])
        stamps = tracing.take_stamps()
        assert stamps is not None and stamps.shape == (1 + len(STAGES),)
        assert stamps.device == card
        for a, b in zip(leaves(out), leaves(eager[i % 2])):
            assert torch.equal(a, b), i
    (entry,) = step.graphs.values()
    assert entry.stamps is not None and card in tracing._CLOCKS


@pytest.mark.cuda
def test_stamps_do_not_decrease_and_stages_sum_to_the_span(card):
    step, frames, gyro = tiny_step(card)
    step(frames, gyro)
    seen = []
    for _ in range(5):
        step(frames, gyro)
        seen.append(tracing.take_stamps())
    vectors = [s.cpu().tolist() for s in seen]
    fetched = time.monotonic_ns()
    clock = tracing.clock_map(card)
    assert 0 <= clock.error_ns < 1_000_000
    for v in vectors:
        assert v == sorted(v) and v[-1] > v[0]
    for a, b in zip(vectors, vectors[1:]):
        assert a[-1] <= b[0]  # replays one after another
    recs = stage_records(vectors[-1], clock)
    assert sum(dt for _, dt, _ in recs[:-1]) == pytest.approx(recs[-1][1])
    # the last replay ended before the host had fetched its stamps
    assert recs[-1][2] + recs[-1][1] * 1e9 <= fetched + clock.error_ns


@pytest.mark.cuda
def test_app_keeps_each_replays_stamps_at_depth_1(card):
    tracing.SPANS.reset()
    iters = 6
    comm, want = tiny_app(card, iters=iters)
    spans = tracing.SPANS
    assert [len(spans.samples[k]) for k in STAGE_RECORDS] == [iters] * 7
    assert len(spans.samples["graph.replay"]) == iters
    starts = list(spans.starts["step.span"])
    durations = list(spans.samples["step.span"])
    assert all(t is not None for t in starts)
    # replay N+1 was enqueued before N was fetched; had it overwritten N's
    # stamps, two records would be one replay's
    for i in range(1, iters):
        assert starts[i] >= starts[i - 1] + durations[i - 1] * 1e9 - 1, i
    poses = [p for p in comm.packets if p[1] > 0]
    assert len(poses) == iters * BATCH
    for cam, n_tags, pose in poses:
        assert pose == (float(want.pose_x[cam]), float(want.pose_y[cam]),
                        float(want.pose_yaw[cam]))
