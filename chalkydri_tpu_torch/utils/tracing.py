"""Tracing / profiling utilities (port of ``chalkydri_tpu/utils/tracing.py``).

Parity with the reference's observability stack (SURVEY.md section 5.1):
``tracing`` env-filtered logs -> stdlib logging with CHALKYDRI_LOG levels;
per-span timing -> ``span()``; ``torch.profiler`` replaces tokio-console for
device work; latency accounting rides the Tov stamps (runtime/clock.py).
"""

from __future__ import annotations

import collections
import contextlib
import logging
import os
import time
from collections import defaultdict

_LOG_FORMAT = "%(asctime)s %(levelname)-5s %(name)s: %(message)s"
SAMPLES_KEPT = 4096  # newest span durations kept per name, for percentiles


def init_tracing(default_level: str = "INFO") -> logging.Logger:
    """Env-filtered logging init (the reference reads RUST_LOG,
    crates/chalkydri/src/main.rs:63-69; we read CHALKYDRI_LOG)."""
    level = os.environ.get("CHALKYDRI_LOG", default_level).upper()
    logging.basicConfig(level=getattr(logging, level, logging.INFO),
                        format=_LOG_FORMAT)
    return logging.getLogger("chalkydri")


class SpanStats:
    """Rolling per-span wall-time stats (count / total / max, and the
    newest ``SAMPLES_KEPT`` durations for p50 / p90)."""

    def __init__(self):
        self.stats = defaultdict(lambda: [0, 0.0, 0.0])  # n, total_s, max_s
        self.samples = defaultdict(
            lambda: collections.deque(maxlen=SAMPLES_KEPT))

    def record(self, name: str, dt: float) -> None:
        s = self.stats[name]
        s[0] += 1
        s[1] += dt
        s[2] = max(s[2], dt)
        self.samples[name].append(dt)

    def reset(self) -> None:
        self.stats.clear()
        self.samples.clear()

    def summary(self) -> dict:
        out = {}
        for k, (n, tot, mx) in self.stats.items():
            q = sorted(self.samples[k])
            out[k] = {"n": n, "mean_ms": tot / n * 1e3 if n else 0.0,
                      "max_ms": mx * 1e3,
                      "p50_ms": q[(len(q) - 1) // 2] * 1e3 if q else 0.0,
                      "p90_ms": q[(len(q) - 1) * 9 // 10] * 1e3 if q else 0.0}
        return out


SPANS = SpanStats()


@contextlib.contextmanager
def span(name: str, logger: logging.Logger | None = None):
    """Timed span (the reference's #[instrument] on camera ops,
    pipeline.rs:188-202)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        SPANS.record(name, dt)
        if logger is not None:
            logger.debug("%s took %.3f ms", name, dt * 1e3)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """``torch.profiler`` session over the host and, where there is one,
    the card -> ``log_dir/trace.json`` (Chrome trace format; opens in
    Perfetto or chrome://tracing). Yields the profiler, whose
    ``key_averages()`` sums the device time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
