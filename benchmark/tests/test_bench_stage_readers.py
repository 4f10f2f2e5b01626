"""The readers of the step's own records (``metrics/stage_*_ms.py``,
``step_span_ms.*``, ``graph_replay_host_ms.live``) on a synthetic
``Context`` and ``SPANS``: the median of the records that started in the
untraced stretch, in ms; None where there is none, where the run has no
``StepTimes`` and where the program keeps no start times."""

import statistics

import pytest

from benchmark.trace import Context, StepTimes, load_module
from chalkydri_tpu_torch.utils import tracing

READERS = {"stage_front_ms": "step.front", "stage_cluster_ms": "step.cluster",
           "stage_quad_ms": "step.quad", "stage_refine_ms": "step.refine",
           "stage_decode_ms": "step.decode", "stage_solve_ms": "step.solve",
           "step_span_ms.live": "step.span",
           "step_span_ms.saturate": "step.span",
           "graph_replay_host_ms.live": "graph.replay"}
HOST0 = 5_000_000_000  # the stretch's first dispatch, host ns
PERIOD = 10_000_000  # a dispatch every 10 ms


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


@pytest.mark.parametrize("name", list(READERS))
def test_median_of_the_untraced_stretchs_records(name, spans):
    record = READERS[name]
    # one before the stretch's first start, five inside, one after its
    # last start (in the profiled second)
    spans.record(record, 0.100, HOST0 - 1)
    inside = [0.0091, 0.0089, 0.0090, 0.0112, 0.0088]
    for i, dt in enumerate(inside):
        spans.record(record, dt, HOST0 + PERIOD * i + 1000)
    spans.record(record, 0.200, HOST0 + PERIOD * 6)
    spans.record(record, 0.300)  # no start: never counted
    spans.record("app.unrelated", 1.0, HOST0 + 5)
    got = load_module("metrics", name).read(context())
    assert got == pytest.approx(statistics.median(inside) * 1e3)


@pytest.mark.parametrize("name", list(READERS))
def test_none_without_records_or_step_times(name, spans):
    reader = load_module("metrics", name)
    assert reader.read(context()) is None
    spans.record(READERS[name], 0.009, HOST0 - 1)  # outside the stretch
    assert reader.read(context()) is None
    spans.record(READERS[name], 0.009, HOST0 + 1)
    ctx = context()
    ctx.steps = None  # a CPU run, or a run without a card's events
    assert reader.read(ctx) is None


@pytest.mark.parametrize("name", list(READERS))
def test_none_where_the_program_keeps_no_starts(name, monkeypatch):
    class OldSpans:  # SpanStats before it kept start times
        samples = {READERS[name]: [0.009]}

    monkeypatch.setattr(tracing, "SPANS", OldSpans())
    assert load_module("metrics", name).read(context()) is None
