"""Percentiles over every sample, frames with no packet at the top."""

import math

import pytest

from benchmark import harness
from benchmark.harness import Observed, Polled, StandInCamera


def test_percentile_nearest_rank_over_all_samples():
    v = list(range(1, 101))
    assert harness.percentile(v, 0.5) == 50
    assert harness.percentile(v, 0.95) == 95
    assert harness.percentile([3.0], 0.95) == 3.0
    with pytest.raises(ValueError):
        harness.percentile([], 0.5)


def test_p95_is_of_all_samples_not_of_chunk_medians():
    # 20 chunks of 20: every chunk's median is 1, but 10 % of all are 100
    v = ([1.0] * 18 + [100.0] * 2) * 20
    assert harness.percentile(v, 0.95) == 100.0


def _obs(latencies_ms, missing):
    """Camera 0 offered one frame per entry, a frame due every 10 ms;
    ``missing`` of them got no packet."""
    cam = StandInCamera([None], 8, 8)
    cam.arm("every_poll", 0, 10 ** 10)
    matched = {}
    for n, lat in enumerate(latencies_ms):
        due = n * 10_000_000
        cam.polled.append(Polled(n, 0, due, due))
        if n not in missing:
            matched[(0, n)] = (0,) * 9 + (due + round(lat * 1e6),)
    obs = Observed(cams=[cam], packets=[], detections=[{}], t0=0,
                   t_end=len(latencies_ms) * 10_000_000,
                   drain_end=len(latencies_ms) * 10_000_000 + 5 * 10 ** 9)
    return obs, matched


def test_missing_packets_count_as_later_than_any_delivered():
    lat = [10.0] * 90 + [20.0] * 10
    obs, matched = _obs(lat, missing=set(range(90, 100)))
    samples = harness.latency_samples(obs, matched)
    assert samples.count(math.inf) == 10
    e2e = harness.end_to_end(obs, matched, 1.0)
    assert e2e["pose_latency_p50_ms"] == pytest.approx(10.0)
    # p95 lands on a missing frame: reported as the whole run's length
    assert e2e["pose_latency_p95_ms"] == pytest.approx(6000.0)
    assert harness.offered_counts(obs, matched) == (100, 10)


def test_frames_per_s_counts_packets_that_arrived_in_the_window():
    obs, matched = _obs([5.0] * 10, missing=set())
    e2e = harness.end_to_end(obs, matched, 0.1)
    assert e2e["frames_per_s"] == pytest.approx(100.0)


def test_step_times_idle_share_and_gaps_by_host_range():
    from benchmark.trace import OUTSIDE, StepTimes

    # device ms: dispatch 0 [0, 8]; dispatch 1 queued behind it, recorded at
    # 5, runs [8, 16]; dispatch 2 finds the device idle, starts at 20, as
    # the host records it at 1,020 ms of its clock; dispatch 3 at 30, host
    # 1,030, after a gap that no harness range covers
    st = StepTimes(starts=[0.0, 5.0, 20.0, 30.0], ends=[8.0, 16.0, 28.0, 38.0],
                   host_starts=[None, None, 1_020_000_000, 1_030_000_000],
                   host=[("app._upload", 1_017_000_000, 1_019_000_000),
                         ("app._fetch_small", 1_015_000_000, 1_020_000_000)])
    assert st.step_ms() == [8.0, 8.0, 8.0, 8.0]
    assert st.window_ms() == 38.0
    assert st.idle_pct() == pytest.approx(100 * 6 / 38)
    # the 4 ms gap's middle, 1,018 ms, is inside both ranges: the innermost
    assert st.idle_gaps() == [("app._upload", 0.004), (OUTSIDE, 0.002)]
