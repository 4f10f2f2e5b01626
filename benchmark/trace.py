"""What a traced run read, and the arithmetic the per-layer readers share.

A traced run profiles the last part of its window with ``torch.profiler``
(host and device) and keeps, from the whole window, the ``app.dispatch``
span of every iteration that dispatched a step. ``TraceData`` holds the
device's kernels, copies and sets, the harness's own host ranges
(``harness.Instrument``) and the traced window, all in the trace's clock
(microseconds).

The profiler slows the launch of the replayed graph's nodes, so what the
device does between steps is read before it starts: ``StepTimes`` holds,
for each dispatch of the untraced stretch, the device's start and end
(CUDA events on the step's stream, ``harness.StepClock``) and the host's
time at its start, with the harness's host ranges of that stretch.
"""

from __future__ import annotations

import importlib.util
import math
import os
import re
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.traced_window"
OUTSIDE = "App polling with no frame due, or the harness"
NAME_CHARS = 160  # a kernel's demangled name, cut for the result line


@dataclass
class TraceData:
    kernels: list  # [(name, ts us, dur us)]
    device: list  # kernels, copies and sets: [(name, ts, dur)]
    host: list  # the harness's ranges: [(name, ts, dur)]
    window: tuple  # (ts us, dur us) of the traced window
    steps: int  # steps dispatched inside it

    @classmethod
    def from_events(cls, events: list, steps: int) -> "TraceData":
        device, host, window = [], [], None
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat")
            item = (e.get("name", ""), float(e["ts"]), float(e.get("dur", 0)))
            if cat in DEVICE_CATS:
                device.append(item + (cat,))
            elif cat == "user_annotation":
                if item[0] == WINDOW:
                    window = item[1:]
                else:
                    host.append(item)
        if window is None:
            raise RuntimeError("the trace has no traced-window range")
        kernels = [d[:3] for d in device if d[3] == "kernel"]
        return cls(kernels=kernels, device=[d[:3] for d in device],
                   host=host, window=window, steps=steps)

    @property
    def window_s(self) -> float:
        return self.window[1] / 1e6

    def busy_intervals(self) -> list:
        """The union of the device's operations, clipped to the window,
        as sorted disjoint [start, end) pairs (us)."""
        w0, w1 = self.window[0], self.window[0] + self.window[1]
        spans = sorted((max(ts, w0), min(ts + dur, w1))
                       for _, ts, dur in self.device
                       if ts < w1 and ts + dur > w0)
        merged = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def idle_gaps(self) -> list:
        """[(what the host was doing, seconds)] of each stretch of the
        window in which the device ran nothing, longest first: the
        innermost harness range open at the stretch's middle."""
        w0, w1 = self.window[0], self.window[0] + self.window[1]
        edges = [w0] + [x for iv in self.busy_intervals() for x in iv] + [w1]
        gaps = []
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            inside = [(dur, name) for name, ts, dur in self.host
                      if ts <= mid <= ts + dur]
            gaps.append((min(inside)[1] if inside else OUTSIDE,
                         (b - a) / 1e6))
        return sorted(gaps, key=lambda g: -g[1])

    def top_ops(self, n: int = 10) -> list:
        """[(name, seconds)] of the device operations that took most time
        in the window, summed by name."""
        total: dict = {}
        for name, _, dur in self.device:
            total[name] = total.get(name, 0.0) + dur / 1e6
        top = sorted(total.items(), key=lambda kv: -kv[1])[:n]
        return [(name[:NAME_CHARS], s) for name, s in top]

    def kernel_time(self, pattern: str) -> tuple:
        """(launches, total seconds) of the kernels whose name matches the
        regular expression ``pattern``."""
        rx = re.compile(pattern)
        hits = [dur for name, _, dur in self.kernels if rx.search(name)]
        return len(hits), sum(hits) / 1e6


@dataclass
class StepTimes:
    """Dispatches timed by CUDA events: ``starts[i]`` and ``ends[i]``, in
    ms of the device's clock from the first start, bound the device work
    of dispatch ``i`` (the frames' upload, the replay, the queued fetch);
    ``host_starts[i]`` is the host's ``monotonic_ns`` as it recorded the
    start; ``host`` the harness's ranges, [(label, start ns, end ns)]."""

    starts: list
    ends: list
    host_starts: list
    host: list

    def spans(self) -> list:
        """[(start, end)] ms of each dispatch's device work: it starts at
        its start event or when the one before it ends, if later."""
        out, prev = [], -math.inf
        for s, e in zip(self.starts, self.ends):
            out.append((max(s, prev), e))
            prev = e
        return out

    def step_ms(self) -> list:
        return [e - s for s, e in self.spans()]

    def window_ms(self) -> float:
        return self.ends[-1] - self.starts[0]

    def idle_pct(self) -> float:
        busy = sum(self.step_ms())
        return 100.0 * (1.0 - busy / self.window_ms())

    def idle_gaps(self) -> list:
        """[(what the host was doing, seconds)] of each stretch in which
        the device waited for the next dispatch, longest first. A dispatch
        that finds the device idle starts as the host records it, so such
        a stretch ends at that host time: it is labelled by the innermost
        harness range open at its middle."""
        gaps = []
        for i in range(1, len(self.starts)):
            gap = self.starts[i] - self.ends[i - 1]
            if gap <= 0:
                continue
            mid = self.host_starts[i] - gap * 1e6 / 2
            inside = [(t1 - t0, name) for name, t0, t1 in self.host
                      if t0 <= mid <= t1]
            gaps.append((min(inside)[1] if inside else OUTSIDE, gap / 1e3))
        return sorted(gaps, key=lambda g: -g[1])


@dataclass
class Context:
    """What a per-layer reader gets: the cell, its configuration and
    traffic, the trace, the dispatches' device times, the dispatch spans,
    the run's scene and device."""

    workload: dict
    config: dict
    traffic: dict
    trace: TraceData | None
    dispatch_ms: list
    scene: object
    device: str
    steps: StepTimes | None = None
    cache: dict = field(default_factory=dict)


def load_module(folder: str, name: str):
    """``benchmark/<folder>/<name>.py`` as a module (its name may hold
    dots)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), folder,
                        f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {folder} file for {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{folder}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def roofline_pct(ctx: Context, kernel: str):
    """A kernel's share of its roofline, in %: the least time its work
    could take on the chip (``benchmark/rooflines/<kernel>.py``: bytes over
    the memory rate or operations over the 32-bit rate, whichever is
    larger, ``benchmark/peaks.py``) over its measured device time a call.
    None where the trace holds no call of it."""
    from benchmark.peaks import least_seconds

    if ctx.trace is None:
        return None
    roof = load_module("rooflines", kernel)
    launches, seconds = ctx.trace.kernel_time(roof.KERNELS)
    calls = launches / roof.LAUNCHES_PER_CALL
    if calls < 1 or seconds <= 0:
        return None
    nbytes, ops = roof.work(ctx)
    return 100.0 * least_seconds(nbytes, ops) / (seconds / calls)


def step_device_ms(ctx: Context):
    """Kernel time in the traced window over the steps dispatched in it."""
    if ctx.trace is None or ctx.trace.steps < 1:
        return None
    total = sum(dur for _, _, dur in ctx.trace.kernels) / 1e3
    return total / ctx.trace.steps if total > 0 else None


def device_idle_pct(ctx: Context):
    """Share of the untraced stretch in which the device ran no dispatch
    (``StepTimes``)."""
    if ctx.steps is None or ctx.steps.window_ms() <= 0:
        return None
    return ctx.steps.idle_pct()


def app_dispatch_ms(ctx: Context):
    """The median of the ``app.dispatch`` spans of the iterations that
    dispatched a step, over the whole window."""
    if not ctx.dispatch_ms:
        return None
    import statistics

    return statistics.median(ctx.dispatch_ms)
