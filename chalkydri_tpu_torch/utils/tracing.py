"""Tracing / profiling utilities (port of ``chalkydri_tpu/utils/tracing.py``).

Parity with the reference's observability stack (SURVEY.md section 5.1):
``tracing`` env-filtered logs -> stdlib logging with CHALKYDRI_LOG levels;
per-span timing -> ``span()``; ``torch.profiler`` replaces tokio-console for
device work; latency accounting rides the Tov stamps (runtime/clock.py).

Every record in ``SPANS`` keeps its start on the host's
``time.monotonic_ns()``. The vision step also times its own stages on the
card: while a ``VisionPipeline.forward`` call runs on a CUDA card
(``step_stamps``), each ``stage(name)`` launches a one-thread kernel
(``csrc/stamp.cu``) that writes the card's ``%globaltimer`` into a slot of
a small int64 buffer, in stream order, so inside the step's CUDA graph
too. Everywhere else ``stage`` does nothing: on the CPU, in the
detector-only graphs of ``make_detector`` and in the row-banded step.
``CapturedStep`` hands each replay's copy of the buffer on
(``take_stamps``); the App fetches it with the step's poses and, once
they are published, records ``step.<stage>`` and ``step.span``
(``record_stages``), each start put on the host's clock by the card's
``ClockMap``. A data-parallel grid of single-card groups hands on its
last group's stamps.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import os
import threading
import time
from collections import defaultdict
from typing import NamedTuple

_LOG_FORMAT = "%(asctime)s %(levelname)-5s %(name)s: %(message)s"
SAMPLES_KEPT = 4096  # newest span durations kept per name, for percentiles
# The step's stages, in order, each ending at its stamp (stamp 0: entry):
# the front end (grayscale, decimation, threshold, CCL, extraction,
# compaction), the cluster sort, quad fit and the top quads, refinement,
# decode with the rank, dedup and compaction, the solver and the outputs.
STAGES = ("front", "cluster", "quad", "refine", "decode", "solve")
STAGE_RECORDS = tuple(f"step.{s}" for s in STAGES) + ("step.span",)
CLOCK_TRIPS = 20  # stamp-and-synchronise round trips behind a ClockMap


def init_tracing(default_level: str = "INFO") -> logging.Logger:
    """Env-filtered logging init (the reference reads RUST_LOG,
    crates/chalkydri/src/main.rs:63-69; we read CHALKYDRI_LOG)."""
    level = os.environ.get("CHALKYDRI_LOG", default_level).upper()
    logging.basicConfig(level=getattr(logging, level, logging.INFO),
                        format=_LOG_FORMAT)
    return logging.getLogger("chalkydri")


class SpanStats:
    """Rolling per-span wall-time stats (count / total / max, and the
    newest ``SAMPLES_KEPT`` durations for p50 / p90, with their starts in
    ``starts``: host ``monotonic_ns``, None where unknown)."""

    def __init__(self):
        self.stats = defaultdict(lambda: [0, 0.0, 0.0])  # n, total_s, max_s
        self.samples = defaultdict(
            lambda: collections.deque(maxlen=SAMPLES_KEPT))
        self.starts = defaultdict(
            lambda: collections.deque(maxlen=SAMPLES_KEPT))
        self._lock = threading.Lock()  # keeps samples and starts in step

    def record(self, name: str, dt: float,
               start_ns: int | None = None) -> None:
        with self._lock:
            self._add(name, dt, start_ns)

    def record_many(self, records) -> None:
        """``record`` each (name, seconds, start ns or None) of ``records``."""
        with self._lock:
            for name, dt, start_ns in records:
                self._add(name, dt, start_ns)

    def _add(self, name: str, dt: float, start_ns: int | None) -> None:
        s = self.stats[name]
        s[0] += 1
        s[1] += dt
        s[2] = max(s[2], dt)
        self.samples[name].append(dt)
        self.starts[name].append(start_ns)

    def between(self, name: str, t0_ns: int, t1_ns: int) -> list:
        """The kept durations (s) of ``name`` that started in [t0_ns,
        t1_ns], oldest first."""
        with self._lock:
            return [dt for dt, t in zip(self.samples.get(name, ()),
                                        self.starts.get(name, ()))
                    if t is not None and t0_ns <= t <= t1_ns]

    def reset(self) -> None:
        with self._lock:
            self.stats.clear()
            self.samples.clear()
            self.starts.clear()

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
    pipeline.rs:188-202), recorded with its start."""
    t0 = time.monotonic_ns()
    try:
        yield
    finally:
        dt = (time.monotonic_ns() - t0) / 1e9
        SPANS.record(name, dt, t0)
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


# -- the step's stage stamps on the card ------------------------------------

_STEP = threading.local()  # .open: the running step's stamps; .last: the last
_CLOCKS: dict = {}  # torch.device -> ClockMap


def _stamp(buf, slot: int) -> None:
    """The card's ns clock into ``buf[slot]``, in stream order."""
    from chalkydri_tpu_torch.ops import build

    build.launch("chalkydri_stage_stamp", buf, buf.data_ptr(), slot)


@contextlib.contextmanager
def step_stamps(device):
    """One step's stamps: on a CUDA card a [1 + len(STAGES)] int64 buffer
    (made here, so inside a capture it is the graph's own) whose slot 0
    is stamped now and slot ``i + 1`` by ``stage(STAGES[i])``; when the
    step returns it is this thread's last stamps (``take_stamps``).
    Elsewhere nothing."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        yield
        return
    buf = torch.empty(1 + len(STAGES), dtype=torch.int64, device=device)
    _stamp(buf, 0)
    _STEP.open = buf
    try:
        yield
    finally:
        _STEP.open = None
    _STEP.last = buf


def stage(name: str) -> None:
    """Stamp the end of stage ``name`` of the running step, if it stamps."""
    buf = getattr(_STEP, "open", None)
    if buf is not None:
        _stamp(buf, 1 + STAGES.index(name))


def take_stamps():
    """This thread's last step's stamps (a tensor on its card), or None;
    clears them."""
    buf = getattr(_STEP, "last", None)
    _STEP.last = None
    return buf


def hand_stamps(buf) -> None:
    """Make ``buf`` this thread's last step's stamps (a graph's replay)."""
    _STEP.last = buf


class ClockMap(NamedTuple):
    """A card's ``%globaltimer`` on the host's ``time.monotonic_ns()``:
    host ns = device ns - ``offset_ns``, within +- ``error_ns``."""

    offset_ns: int
    error_ns: int

    @classmethod
    def from_round_trips(cls, trips) -> "ClockMap":
        """From [(host ns before, device ns, host ns after)] of stamps each
        launched and synchronised: the shortest round trip, its stamp
        taken at its middle, within half of it."""
        t0, dev, t1 = min(trips, key=lambda t: t[2] - t[0])
        return cls(dev - (t0 + t1) // 2, (t1 - t0 + 1) // 2)

    def host_ns(self, device_ns: int) -> int:
        return device_ns - self.offset_ns


def clock_map(device) -> ClockMap:
    """The card's ``ClockMap``, measured on first use from ``CLOCK_TRIPS``
    round trips on the current stream (it waits for that stream)."""
    import torch

    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _CLOCKS:
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream()
            buf = torch.empty(CLOCK_TRIPS, dtype=torch.int64, device=device)
            stream.synchronize()
            host = []
            for i in range(CLOCK_TRIPS):
                t0 = time.monotonic_ns()
                _stamp(buf, i)
                stream.synchronize()
                host.append((t0, time.monotonic_ns()))
            _CLOCKS[device] = ClockMap.from_round_trips(
                [(t0, d, t1) for (t0, t1), d in zip(host, buf.tolist())])
    return _CLOCKS[device]


def stage_records(stamps, clock: ClockMap | None) -> list:
    """[(name, seconds, host start ns or None)] of one step's stamps:
    ``step.<stage>`` from each stamp to the next, then ``step.span`` from
    the first to the last; starts on the host clock by ``clock``."""
    s = [int(x) for x in stamps]
    starts, ends = s[:-1] + s[:1], s[1:] + s[-1:]
    offset = None if clock is None else clock.offset_ns
    return [(name, (b - a) / 1e9, None if offset is None else a - offset)
            for name, a, b in zip(STAGE_RECORDS, starts, ends)]


def record_stages(stamps, device, spans: SpanStats | None = None) -> None:
    """Record one step's stamps (a host tensor, array or list) in
    ``spans`` (``SPANS``), with the starts of ``device``'s ``ClockMap``
    where it has one."""
    spans = SPANS if spans is None else spans
    if hasattr(stamps, "tolist"):
        stamps = stamps.tolist()
    spans.record_many(stage_records(stamps, _CLOCKS.get(device)))
