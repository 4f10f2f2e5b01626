"""One run of one cell: the program's App loop driven between stand-ins for
the cameras and the roboRIO, timed by the host clock, then held to the
plain reference.

The App is built as ``python -m chalkydri_tpu_torch.main`` builds it:
a task graph of one ``CamPipeline -> AprilTags`` chain per camera and a
whacknet comm bundle, the field layout, ``App(..., device=...)`` with the
configuration's ``pipeline_depth`` and detector settings. Then:

- each chain's camera is replaced by a ``StandInCamera`` that hands out
  the newest frame due by the traffic's schedule, stamped with its due
  time (so the packet's own latency field also counts from exposure);
  a frame that a newer one replaces before the App polls is skipped, as
  a free-running camera drops it;
- the App's ``Comm`` sends to a receiver process on a loopback port
  (``benchmark/receiver.py``), which stamps each packet on arrival; the
  run's heading goes to the App on its gyro port and stays fixed;
- set-up warms the App's step up on the cell's own batch, then the window
  calls ``App.run_one_iteration()`` until it ends, then drains: the
  frames still due are polled and the step still in flight published.

Every packet is matched to its frame by camera id and by its arrival time
less its latency field. After the window, the App is freed and the plain
reference (``benchmark/reference``) works out every distinct frame again;
``benchmark/compare.py`` holds each polled frame's detections and packet
to it.
"""

from __future__ import annotations

import gc
import json
import math
import os
import socket
import struct
import subprocess
import sys
import time
from dataclasses import dataclass, field

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(ROOT, "benchmark")
WARMUP_ITERS = 6  # App iterations on fresh frames before the window
DRAIN_S = 60.0  # the longest the drain waits for frames still due
PACKET = struct.Struct("<6dQ2B6x")  # whacknet's 64-byte VisionMeasurement
STOP_ID = 255


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(benchmark: dict, name: str) -> dict:
    for w in benchmark["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def find_file(folder: str, name: str) -> str:
    """``folder/name.json`` (a configuration or a traffic mix)."""
    path = os.path.join(BENCH_DIR, folder, f"{name}.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {folder} file for {name!r}: {path}")
    return path


def load_traffic(name: str, config: str) -> dict:
    """The traffic mix ``name``, with what its per-configuration file
    ``traffic/<name>/<config>.json`` sets (a rate from that
    configuration's sweep) laid over it."""
    mix = load_json(find_file("traffic", name))
    own = os.path.join(BENCH_DIR, "traffic", name, f"{config}.json")
    if os.path.exists(own):
        mix.update(load_json(own))
    return mix


class MonotonicClock:
    """The App's clock on ``time.monotonic_ns()``, which the receiver
    process shares: a packet's latency field and the frames' due times
    are in one time base."""

    @staticmethod
    def now_us() -> int:
        return time.monotonic_ns() // 1000

    @staticmethod
    def now_ms() -> int:
        return time.monotonic_ns() // 1_000_000


@dataclass
class Polled:
    """A frame the App polled: its number in the camera's schedule, the
    pose it shows, when it was due and when the App took it."""

    n: int
    pose: int
    due_ns: int
    poll_ns: int


class StandInCamera:
    """``CamPipeline``'s surface (``start``, ``process``, ``stop``,
    ``set_exposure``, the geometry attributes) over frames the harness
    renders. ``process`` returns the newest frame due, or no frame."""

    def __init__(self, frames: list, width: int, height: int):
        self.frames = frames  # [K] of [H, W] uint8, cycled
        self.width, self.height = width, height
        self.orientation = "none"
        self.mode = None  # None, "warm", "free_running", "every_poll"
        self.t0 = self.t_end = 0
        self.rate = 0.0
        self.offset_ns = 0
        self.last = -1
        self.gave = False  # handed out a frame since the flag was cleared
        self.polled: list[Polled] = []

    def start(self, clock) -> None:
        pass

    def stop(self, clock) -> None:
        pass

    def set_exposure(self, value: int) -> None:
        pass

    def warm(self) -> None:
        """A new frame at every poll, not recorded (set-up)."""
        self.mode, self.last = "warm", -1

    def idle(self) -> None:
        self.mode = None

    def arm(self, arrivals: str, t0: int, t_end: int, rate: float = 0.0,
            offset_periods: float = 0.0) -> None:
        """The window's schedule: ``free_running`` (a frame every 1 /
        ``rate`` s from ``t0``, ``offset_periods`` of a period late) or
        ``every_poll`` (a new frame at every poll); none due at or after
        ``t_end``."""
        if arrivals not in ("free_running", "every_poll"):
            raise ValueError(f"unknown arrivals {arrivals!r}")
        self.mode, self.t0, self.t_end = arrivals, t0, t_end
        self.rate = float(rate)
        self.offset_ns = (round(offset_periods * 1e9 / self.rate)
                          if arrivals == "free_running" else 0)
        self.last = -1
        self.polled = []

    def due_ns(self, n: int) -> int:
        return self.t0 + self.offset_ns + round(n * 1e9 / self.rate)

    def last_due(self) -> int:
        """The number of the last frame due before ``t_end`` (-1: none)."""
        span = self.t_end - 1 - self.t0 - self.offset_ns
        if span < 0:
            return -1
        n = math.floor(span * self.rate / 1e9)
        while n >= 0 and self.due_ns(n) >= self.t_end:
            n -= 1
        return n

    def offered(self) -> list:
        """[(n, pose, due ns)] of every frame offered in the window."""
        if self.mode == "free_running":
            k = len(self.frames)
            return [(n, n % k, self.due_ns(n))
                    for n in range(self.last_due() + 1)]
        return [(p.n, p.pose, p.due_ns) for p in self.polled]

    def has_frame(self) -> bool:
        """Whether a poll now would hand out a frame."""
        now = time.monotonic_ns()
        if self.mode == "free_running":
            return (now >= self.t0 + self.offset_ns and self.last < min(
                math.floor((now - self.t0 - self.offset_ns) * self.rate / 1e9),
                self.last_due()))
        if self.mode == "every_poll":
            return self.t0 <= now < self.t_end
        return self.mode == "warm"

    def pending(self) -> bool:
        """A frame due in the window that the App has not polled yet."""
        return self.mode == "free_running" and self.last < self.last_due()

    def process(self, clock):
        from chalkydri_tpu_torch.runtime.clock import Stamped, Tov

        now = time.monotonic_ns()
        if self.mode == "warm":
            self.last += 1
            self.gave = True
            return Stamped(self.frames[self.last % len(self.frames)],
                           Tov(now // 1000))
        if self.mode == "free_running":
            if now < self.t0 + self.offset_ns:
                return Stamped(None, Tov())
            n = min(math.floor((now - self.t0 - self.offset_ns)
                               * self.rate / 1e9), self.last_due())
            while n > self.last and self.due_ns(n) > now:
                n -= 1
            if n <= self.last:
                return Stamped(None, Tov())
            due = self.due_ns(n)
        elif self.mode == "every_poll":
            if not self.t0 <= now < self.t_end:
                return Stamped(None, Tov())
            n, due = self.last + 1, now
        else:
            return Stamped(None, Tov())
        self.last = n
        self.gave = True
        k = n % len(self.frames)
        self.polled.append(Polled(n, k, due, now))
        return Stamped(self.frames[k], Tov(due // 1000))


class Receiver:
    """The receiver process (``benchmark/receiver.py``)."""

    def __init__(self):
        env = dict(os.environ, PYTHONPATH=ROOT)
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "benchmark.receiver"], cwd=ROOT, env=env,
            stdin=subprocess.DEVNULL, stdout=subprocess.PIPE)
        self.port = int(self.proc.stdout.readline())

    def collect(self, timeout: float = 60.0) -> list:
        """Wait for the stop packet's effect and return [(arrival ns,
        bytes)]; stops the process with a stop datagram if it is slow."""
        from benchmark.receiver import decode

        try:
            blob, _ = self.proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.stop()
            blob, _ = self.proc.communicate(timeout=30)
        if self.proc.returncode != 0:
            raise RuntimeError(f"the receiver process failed "
                               f"({self.proc.returncode})")
        return decode(blob)

    def stop(self) -> None:
        if self.proc.poll() is None:
            with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
                s.sendto(b"S", ("127.0.0.1", self.port))

    def close(self) -> None:
        self.stop()
        try:
            self.proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.communicate()


def free_udp_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def task_graph(cfg: dict):
    """The App's task graph, as the configurator writes it: one camera ->
    AprilTags chain per camera of ``cfg``, and the whacknet comm bundle."""
    from benchmark.scene import camera_entries
    from chalkydri_tpu_torch.runtime import TaskGraph

    tasks, cnx = [], []
    for i, cam in enumerate(camera_entries(cfg)):
        tasks += [
            {"id": f"camera_{i}", "type": "CamPipeline",
             "config": {"id": f"bench-{i}", "name": f"cam{i}",
                        "width": cfg["width"], "height": cfg["height"],
                        "fps": cfg["max_frame_rate"]}},
            {"id": f"apriltags_{i}", "type": "chalkydri_apriltags::AprilTags",
             "config": {"cam_id": i, "calib": cam["calib"],
                        "robot_to_cam": cam["robot_to_cam"],
                        "family": cfg["family"],
                        "bits_corrected": cfg["bits_corrected"]}}]
        cnx.append({"src": f"camera_{i}", "dst": f"apriltags_{i}",
                    "msg": "frame"})
    return TaskGraph.from_dict(
        {"tasks": tasks, "cnx": cnx,
         "resources": [{"id": "comm", "provider": "whacknet::CommBundle"}]})


class Recorder:
    """What the App's step produced in the window, kept by reference: a
    wrapper around each group's step keeps every call's output (the
    replay's own copies on the device: no copy, no wait) with the
    (camera, frame number) of each camera that handed the App a fresh
    frame for it. ``frames()`` fetches them once the window is over."""

    def __init__(self, app, cams: list):
        self.on = False
        self.cams = cams
        self.calls = []  # [(output, [(camera, n)])]
        for g in app.groups:
            g.step = self.wrap(g.step)

    def wrap(self, step):
        def recorded(frames, gyro):
            out = step(frames, gyro)
            if self.on:
                self.calls.append((out, [(c, cam.last) for c, cam in
                                         enumerate(self.cams) if cam.gave]))
            return out
        return recorded

    def start(self) -> None:
        self.calls = []
        self.on = True

    def frames(self) -> list:
        """``out[c]``: {n: (ids, corners, pose)} of camera ``c``'s frames,
        pose (x, y, yaw, std x, std y, std yaw, tag count) as the packet
        carries it, or None where the step found no valid pose."""
        out = [{} for _ in self.cams]
        for res, fresh in self.calls:
            d = res.detections
            ids, corners, valid = (x.cpu().numpy() for x in
                                   (d.ids, d.corners, d.valid))
            f = [x.cpu().numpy() for x in
                 (res.pose_x, res.pose_y, res.pose_yaw, res.std_devs,
                  res.pose_valid, res.tag_count)]
            for c, n in fresh:
                pose = None
                if f[4][c]:
                    pose = (float(f[0][c]), float(f[1][c]), float(f[2][c]),
                            *(float(s) for s in f[3][c]), int(f[5][c]))
                keep = valid[c]
                out[c][n] = (ids[c][keep], corners[c][keep], pose)
        return out


@dataclass
class Observed:
    """What the window produced."""

    cams: list  # StandInCamera per camera
    packets: list  # [(arrival ns, bytes)] received
    detections: list  # per camera: {n: (ids, corners, pose)} (``Recorder``)
    t0: int = 0
    t_end: int = 0
    drain_end: int = 0
    dispatch_ms: list = field(default_factory=list)
    steps_traced: int = 0


class StepClock:
    """In a traced run's untraced stretch, CUDA events on the step's
    stream at the start of each dispatch (``App._upload``) and at its end
    (after ``App._start_fetch``), with the host's time at each start, and
    the host ranges of ``Instrument``: the device's time between steps,
    which the profiler's own launch cost would hide
    (``trace.StepTimes``)."""

    def __init__(self):
        self.on = False
        self.marks = []  # [start event, host ns, end event or None]
        self.host = []  # [(label, start ns, end ns)]

    def start(self) -> None:
        import torch

        if self.on:
            ev = torch.cuda.Event(enable_timing=True)
            t = time.monotonic_ns()
            ev.record()
            self.marks.append([ev, t, None])

    def end(self) -> None:
        import torch

        if self.on and self.marks and self.marks[-1][2] is None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks[-1][2] = ev

    def times(self):
        """The stretch's ``trace.StepTimes`` once its events have been
        reached (the caller synchronises), or None under two dispatches."""
        from benchmark.trace import StepTimes

        marks = [m for m in self.marks if m[2] is not None]
        if len(marks) < 2:
            return None
        base = marks[0][0]
        return StepTimes(starts=[base.elapsed_time(m[0]) for m in marks],
                         ends=[base.elapsed_time(m[2]) for m in marks],
                         host_starts=[m[1] for m in marks], host=self.host)


class Instrument:
    """In a traced run, ``record_function`` ranges around the App methods
    the harness calls into, so the trace tells what the host was doing
    while the device idled; while ``clock`` (a ``StepClock``) is on, the
    same ranges go to it with their host times, and each dispatch gets
    its events. The camera poll gets its range only when a frame is due:
    between frames the App polls tens of thousands of times a second, and
    a range each would swamp the profiler."""

    LABELS = {"_upload": "app._upload", "_fetch_small": "app._fetch_small"}

    @staticmethod
    def wrap(fn, label, clock=None, when=None):
        import torch

        def wrapped(*args, **kwargs):
            if when is not None and not when():
                return fn(*args, **kwargs)
            t0 = time.monotonic_ns()
            with torch.profiler.record_function(label):
                out = fn(*args, **kwargs)
            if clock is not None and clock.on:
                clock.host.append((label, t0, time.monotonic_ns()))
            return out
        return wrapped

    @classmethod
    def install(cls, app, cams, clock=None) -> None:
        for name, label in cls.LABELS.items():
            setattr(app, name, cls.wrap(getattr(app, name), label, clock))
        app._poll_cameras = cls.wrap(
            app._poll_cameras, "app._poll_cameras (a frame due)", clock,
            when=lambda: any(c.has_frame() for c in cams))
        for g in app.groups:
            g.step = cls.wrap(g.step, "step (graph replay)", clock)
        app._comm.publish = cls.wrap(app._comm.publish, "comm.publish", clock)
        if clock is None:
            return
        upload, start_fetch = app._upload, app._start_fetch

        def timed_upload(g):
            clock.start()
            return upload(g)

        def timed_start_fetch(out):
            copy = start_fetch(out)
            clock.end()
            return copy
        app._upload, app._start_fetch = timed_upload, timed_start_fetch


class Tracer:
    """``torch.profiler`` from ``start_ns`` until ``stop`` (the caller stops
    it once the window's last iteration is done): the device synchronised
    before it starts, so every step it sees is whole, and ``stop``
    synchronises too. ``warm`` starts and stops one in set-up, so that
    the profiler's own start-up stalls no window."""

    def __init__(self, device: str, clock: StepClock | None = None):
        self.cuda = device != "cpu"
        self.clock = clock  # turned off as the profiler starts
        self.start_ns = 0
        self.prof = None
        self.window = None
        self.done = False

    def _profile(self):
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=activities)

    def warm(self, fn) -> None:
        """Run ``fn()`` under a profiler that is then thrown away."""
        import torch

        prof = self._profile()
        prof.start()
        fn()
        if self.cuda:
            torch.cuda.synchronize()
        prof.stop()

    @property
    def active(self) -> bool:
        return self.prof is not None and not self.done

    def tick(self, now: int) -> None:
        import torch

        if self.prof is None and now >= self.start_ns:
            if self.clock is not None:
                self.clock.on = False
            if self.cuda:
                torch.cuda.synchronize()
            self.prof = self._profile()
            self.prof.start()
            self.window = torch.profiler.record_function("bench.traced_window")
            self.window.__enter__()

    def stop(self) -> None:
        if self.active:
            self.window.__exit__(None, None, None)
            self.prof.stop()
            self.done = True

    def events(self, path: str) -> list:
        """The trace's events (Chrome trace format), written to ``path``
        and read back."""
        self.prof.export_chrome_trace(path)
        try:
            with open(path) as f:
                return json.load(f)["traceEvents"]
        finally:
            os.remove(path)


def gyro_handshake(comm, heading: float, timeout: float = 10.0) -> None:
    """Send the heading on the App's gyro port until the App reads it."""
    port = comm.gyro_port
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        deadline = time.monotonic() + timeout
        while comm.gyro_angle() != heading:
            if time.monotonic() > deadline:
                raise RuntimeError("the App never read the gyro heading")
            s.sendto(struct.pack("<d", heading), ("127.0.0.1", port))
            time.sleep(0.005)


def build_app(cfg: dict, layout_path: str, device: str, recv_port: int):
    """The App and its Comm, as ``main`` builds them."""
    import torch

    from chalkydri_tpu_torch.geometry.field_layout import load_field_layout
    from chalkydri_tpu_torch.io.whacknet import Comm
    from chalkydri_tpu_torch.runtime import App

    gyro_port = free_udp_port()
    comm = Comm(remote_addr="127.0.0.1", remote_port=recv_port,
                gyro_port=gyro_port)
    comm.gyro_port = gyro_port
    layout = load_field_layout(layout_path, dtype=torch.float32,
                               device=device)
    app = App(task_graph(cfg), field_layout=layout, comm=comm,
              clock=MonotonicClock(), synthetic_cameras=False,
              detector_kwargs={"quad_decimate": int(cfg["quad_decimate"])},
              pipeline_depth=int(cfg["pipeline_depth"]), device=device)
    return app, comm


def iterate(app, cams) -> bool:
    """One App iteration; whether a camera handed out a frame in it."""
    for c in cams:
        c.gave = False
    app.run_one_iteration()
    return any(c.gave for c in cams)


def arm_all(cams, traffic: dict, t0: int, t_end: int) -> None:
    """Every camera on the traffic's schedule from ``t0`` to ``t_end``."""
    offsets = traffic.get("offset_periods", [0.0])
    for i, c in enumerate(cams):
        c.arm(traffic["arrivals"], t0, t_end, traffic.get("rate_fps") or 0.0,
              offsets[i % len(offsets)])


def drive(app, cams, traffic: dict, seconds: float, recorder: Recorder,
          tracer=None, spans=None, on_window=None) -> Observed:
    """Warm the App up, run the traffic's ``settle_s`` seconds unmeasured,
    run the window, drain. Returns what was seen (packets are collected
    by the caller). ``on_window(t0)`` is called as the window opens; with
    ``spans`` (``utils.tracing.SPANS``) the ``app.dispatch`` span of every
    iteration that dispatched a step is kept.

    The settling stretch is there because the card runs the replayed
    step about a quarter slower in its first seconds of sustained work
    (1.5 to over 10 s), and then keeps the faster pace: a robot runs for
    minutes, so the window measures what follows."""
    for c in cams:
        c.warm()
    for _ in range(WARMUP_ITERS):
        iterate(app, cams)
    if tracer is not None:
        tracer.warm(lambda: iterate(app, cams))
    settle = float(traffic.get("settle_s", 0.0))
    if settle > 0:
        t = time.monotonic_ns()
        arm_all(cams, traffic, t, t + round(settle * 1e9))
        while time.monotonic_ns() < t + round(settle * 1e9):
            iterate(app, cams)
    for c in cams:
        c.idle()
    for _ in range(2):  # publish what is in flight
        iterate(app, cams)
    sync(app)
    obs = Observed(cams=cams, packets=[], detections=[])
    if spans is not None:
        spans.reset()
    t0 = time.monotonic_ns()
    t_end = t0 + round(seconds * 1e9)
    arm_all(cams, traffic, t0, t_end)
    obs.t0, obs.t_end = t0, t_end
    recorder.start()
    if tracer is not None and tracer.clock is not None:
        tracer.clock.on = True
    if on_window is not None:
        on_window(t0)
    while True:
        now = time.monotonic_ns()
        if now >= t_end:
            break
        if tracer is not None:
            tracer.tick(now)
        if iterate(app, cams):
            if spans is not None:
                obs.dispatch_ms.append(spans.samples["app.dispatch"][-1]
                                       * 1e3)
            if tracer is not None and tracer.active:
                obs.steps_traced += 1
    if tracer is not None:
        tracer.stop()
    deadline = time.monotonic() + DRAIN_S
    while any(c.pending() for c in cams) and time.monotonic() < deadline:
        iterate(app, cams)
    for _ in range(max(1, int(getattr(app, "pipeline_depth", 1)))):
        iterate(app, cams)  # publish the step still in flight
    sync(app)
    obs.drain_end = time.monotonic_ns()
    recorder.on = False
    obs.detections = recorder.frames()
    return obs


def sync(app) -> None:
    import torch

    if app.device.type == "cuda":
        torch.cuda.synchronize(app.device)


def same(packet: tuple, pose: tuple) -> bool:
    """Whether ``packet`` carries ``pose`` (``Recorder.frames``)."""
    return packet[:6] == pose[:6] and packet[8] == pose[6]


def match_packets(obs: Observed) -> dict:
    """{(camera, n): packet fields + (arrival ns,)} for each frame polled
    in the window whose pose packet arrived, and the number of pose
    packets of the window that belong to no such frame.

    A camera's pose packets arrive in the order the App sent them (one
    sender thread, loopback), the order of its frames: each frame with a
    valid pose in the step's output takes the next packet of its camera
    that carries that pose and was not sent before the frame was due
    (its arrival less its latency field). Heartbeats (tag count 0) carry
    no pose; packets whose arrival less their latency field falls outside
    the window belong to set-up."""
    t0_us, end_us = obs.t0 // 1000, obs.drain_end // 1000
    per_cam = [[] for _ in obs.cams]
    unmatched = 0
    for arrival, data in obs.packets:
        fields = PACKET.unpack(data)
        cam, n_tags = fields[7], fields[8]
        if n_tags == 0 or cam == STOP_ID:
            continue
        if not t0_us <= arrival // 1000 - fields[6] <= end_us:
            continue
        if cam >= len(obs.cams):
            unmatched += 1
            continue
        per_cam[cam].append(fields + (arrival,))
    matched = {}
    for c, cam in enumerate(obs.cams):
        packets, j = per_cam[c], 0
        for p in cam.polled:
            got = obs.detections[c].get(p.n)
            if got is None or got[2] is None:
                continue
            k = j
            while k < len(packets) and not (
                    same(packets[k], got[2]) and packets[k][-1] // 1000
                    - packets[k][6] >= p.due_ns // 1000 - 1):
                k += 1
            if k == len(packets):
                continue  # its packet never came
            unmatched += k - j
            matched[(c, p.n)] = packets[k]
            j = k + 1
        unmatched += len(packets) - j
    return {"matched": matched, "unmatched": unmatched}


def percentile(values: list, q: float) -> float:
    """The nearest-rank ``q`` quantile (0 < q <= 1) over all values."""
    if not values:
        raise ValueError("no samples")
    s = sorted(values)
    return s[max(0, math.ceil(q * len(s)) - 1)]


def latency_samples(obs: Observed, matched: dict) -> list:
    """The time, in ms, from each offered frame's due time to its pose
    packet's arrival; ``inf`` for a frame that got none."""
    out = []
    for c, cam in enumerate(obs.cams):
        for n, _, due in cam.offered():
            got = matched.get((c, n))
            out.append((got[-1] - due) / 1e6 if got else math.inf)
    return out


def end_to_end(obs: Observed, matched: dict, seconds: float) -> dict:
    """The end-to-end metrics a run can report (without ``setup_s``)."""
    lat = latency_samples(obs, matched)
    worst = (obs.drain_end - obs.t0) / 1e6  # later than any packet can be

    def pct(q):
        v = percentile(lat, q)
        return worst if math.isinf(v) else v

    in_window = sum(1 for m in matched.values()
                    if obs.t0 <= m[-1] < obs.t_end)
    return {"pose_latency_p50_ms": pct(0.50),
            "pose_latency_p95_ms": pct(0.95),
            "frames_per_s": in_window / seconds}


def offered_counts(obs: Observed, matched: dict) -> tuple:
    """(frames offered in the window, of them those with no pose packet)."""
    offered = [(c, n) for c, cam in enumerate(obs.cams)
               for n, _, _ in cam.offered()]
    return len(offered), sum(1 for key in offered if key not in matched)


def release(app, comm) -> None:
    """Stop the App and free its device memory."""
    import torch

    app.stop_all_tasks()
    comm.close()
    if app.device.type == "cuda":
        torch.cuda.synchronize(app.device)
    del app
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"
