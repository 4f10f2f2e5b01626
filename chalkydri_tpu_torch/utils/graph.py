"""The step as one launch per iteration: a CUDA graph of an eager module,
PyTorch's counterpart of the JAX package's ``@jax.jit``.

``CapturedStep(module)`` keeps ``module``'s call signature (positional
tensors on the module's card in, a tensor or nested tuples of tensors
out). On the first call for a key (each argument's shape and dtype) it
runs
``WARMUP_STEPS`` eager calls on a side stream of its own, which fill
every per-device cache of the step (the route checks of the cluster
kernels, the solver's and the refinement's constant tables, the kernel
library), then captures one call into a ``torch.cuda.CUDAGraph`` whose
inputs are static buffers. Every call, the first included, copies the
caller's tensors into those buffers, replays the graph and returns fresh
tensors that the caller owns: no output aliases a buffer that the next
replay overwrites. ``.module`` is the eager module.

The callers: ``pipeline.make_vision_pipeline`` (the single-card step),
``detector.make_detector`` (the detector, and each program of
``capacity_fallback``) and ``parallel.make_sharded_vision_pipeline``
(each data group whose devices are one card: the whole-frame step, and
the row-banded step, whose band CCL runs its seam rounds gated on the
card). A row-banded group spread over several cards stays eager: a graph
records one device's work.

There is no fallback: a failed capture or replay raises.

The graphs of one card share one memory pool, so their intermediates
overlap. That is safe only while no two replays run at the same time,
so the replays of one card are serialized: one host lock around the
copy in, the replay and the copy out, and each replay's stream waits for
the previous replay's end (an event), whichever threads and streams
call. Captures run one at a time in the process (a second lock), in the
``thread_local`` capture mode, so that other threads may go on
launching and allocating while one thread captures.

The kernel wrappers' launch counts (``.launches`` and the like) count
the launches a graph recorded at each of its replays
(``ops/build.py::count``); the warm-up calls count as the eager launches
they are.

A module that stamps its stages (``utils/tracing.py::step_stamps``) leaves
its stamp buffer in the graph; each replay hands a fresh copy of it on
(``tracing.take_stamps``), and the first capture on a card measures the
card's clock map. Each call is recorded as the ``graph.replay`` span: the
lock, the copy in, the replay, the copies out and the event.
"""

from __future__ import annotations

import threading
import time
from typing import NamedTuple

import torch

from chalkydri_tpu_torch.ops import build
from chalkydri_tpu_torch.utils import tracing

WARMUP_STEPS = 2  # eager calls on the capture stream before a capture

_CAPTURE_LOCK = threading.Lock()  # one capture at a time in the process
_STATE_LOCK = threading.Lock()  # guards _POOLS and _REPLAY
_POOLS: dict[torch.device, tuple] = {}  # the card's shared graph pool
_REPLAY: dict[torch.device, tuple[threading.Lock, torch.cuda.Event]] = {}


class Captured(NamedTuple):
    """One graph of a ``CapturedStep``: its static inputs and outputs, the
    kernel launches it recorded, and what its first call cost."""

    graph: torch.cuda.CUDAGraph
    inputs: tuple
    outputs: object
    tally: dict  # {(kernel wrapper, counter name): launches a replay}
    warmup_ms: float  # host ms of the WARMUP_STEPS eager calls
    capture_ms: float  # host ms of the capture and the graph's instantiation
    stamps: torch.Tensor | None  # the graph's stage stamps, if it stamps


def _card_state(device: torch.device):
    """(shared pool handle, (replay lock, last replay's event)) of a card."""
    with _STATE_LOCK:
        if device not in _POOLS:
            _POOLS[device] = torch.cuda.graph_pool_handle()
            _REPLAY[device] = (threading.Lock(), torch.cuda.Event())
        return _POOLS[device], _REPLAY[device]


def _map(fn, out):
    """``fn`` over every tensor of ``out`` (a tensor or nested tuples,
    NamedTuples rebuilt as their own type)."""
    if isinstance(out, torch.Tensor):
        return fn(out)
    if hasattr(out, "_fields"):
        return type(out)(*(_map(fn, x) for x in out))
    return type(out)(_map(fn, x) for x in out)


def _module_device(module) -> torch.device:
    for t in (*module.parameters(), *module.buffers()):
        return t.device
    raise ValueError(f"CapturedStep: {type(module).__name__} holds no "
                     f"tensor to place it; pass device=")


def pool_bytes(device) -> int:
    """Bytes of the segments that the card's shared graph pool holds."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    pool = _POOLS.get(device)
    if pool is None:
        return 0
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", ())) == tuple(pool))


class CapturedStep:
    """``step(*tensors)``: ``module(*tensors)`` replayed from a CUDA graph
    captured on the first call for each key (module docstring).
    ``module`` is an ``nn.Module`` on a CUDA card, or any callable of
    CUDA tensors with ``device`` given. ``.graphs`` maps each key to its
    ``Captured``; ``.replays`` counts the replays of all of them."""

    def __init__(self, module, device=None):
        device = torch.device(device) if device is not None else (
            _module_device(module))
        if device.type != "cuda":
            raise ValueError(
                f"CapturedStep: a CUDA graph needs a module on a CUDA card, "
                f"not on {device}; call the eager module there")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.module, self.device = module, device
        self.graphs: dict[tuple, Captured] = {}
        self.replays = 0

    def __repr__(self) -> str:
        return (f"CapturedStep({type(self.module).__name__} on "
                f"{self.device}, {len(self.graphs)} graphs)")

    def __call__(self, *args: torch.Tensor):
        for a in args:
            if a.device != self.device:
                raise ValueError(f"CapturedStep: an input on {a.device}, the "
                                 f"step on {self.device}")
        key = tuple((tuple(a.shape), a.dtype) for a in args)
        entry = self.graphs.get(key) or self._capture(key, args)
        return self._replay(entry, args)

    def _capture(self, key, args) -> Captured:
        with _CAPTURE_LOCK, torch.no_grad(), torch.cuda.device(self.device):
            entry = self.graphs.get(key)  # another thread may have won
            if entry is not None:
                return entry
            pool, _ = _card_state(self.device)
            inputs = tuple(
                torch.empty_like(a, memory_format=torch.contiguous_format)
                .copy_(a) for a in args)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream())
            t0 = time.perf_counter()
            with torch.cuda.stream(side):
                for _ in range(WARMUP_STEPS):
                    self.module(*inputs)
            side.synchronize()
            t1 = time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            tracing.take_stamps()  # drop an earlier step's
            with build.capture_tally() as tally, torch.cuda.graph(
                    graph, pool=pool, stream=side,
                    capture_error_mode="thread_local"):
                outputs = self.module(*inputs)
            stamps = tracing.take_stamps()
            t2 = time.perf_counter()
            torch.cuda.current_stream().wait_stream(side)
            if stamps is not None:
                tracing.clock_map(self.device)
            entry = Captured(graph, inputs, outputs, tally,
                             (t1 - t0) * 1e3, (t2 - t1) * 1e3, stamps)
            self.graphs[key] = entry
            return entry

    def _replay(self, entry: Captured, args):
        _, (lock, done) = _card_state(self.device)
        with tracing.span("graph.replay"), lock, torch.no_grad(), \
                torch.cuda.device(self.device):
            stream = torch.cuda.current_stream()
            stream.wait_event(done)
            for static, a in zip(entry.inputs, args):
                static.copy_(a)
            entry.graph.replay()
            out = _map(torch.clone, entry.outputs)
            if entry.stamps is not None:
                tracing.hand_stamps(entry.stamps.clone())
            done.record(stream)
            build.add_tally(entry.tally)
            self.replays += 1
        return out
