"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources compile with ``nvcc`` for Hopper (``sm_90a``) into ONE shared
library with a plain C interface, loaded with ``ctypes``. The build runs
on first use into ``chalkydri_tpu_torch/_build/`` (ignored by git) and is
reused while the sources, the shared header and the flags hash the same.
Nothing here builds at import time, so the package imports on machines
without a CUDA toolkit. First use is safe across threads (the App's
capacity warm-up thread may reach its first kernel call with the loop):
one lock covers the build and the load, and the temporary files carry the
process and thread ids.

Every kernel wrapper in ``ops/`` asks ``on_card`` whether to launch its
kernel or return its plain twin's result: the kernel on CUDA tensors, the
twin on CPU tensors and, on any device, inside ``plain_chain()`` (the
card's checks hold each kernel to its twin on the same CUDA tensors that
way). The wrappers count their launches here (``count``); a launch
recorded into a CUDA graph is counted at each of the graph's replays
(``utils/graph.py``).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
SOURCES = ("ccl_extract.cu", "segment_stats.cu", "threshold_ccl.cu",
           "propagate.cu", "extract_blocked.cu", "stamp.cu", "solve.cu",
           "tail.cu", "front.cu")
HEADERS = ("ccl_common.cuh", "union_find.cuh", "ordered.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # gray, B, H, W, iters, min_diff, tile_min, tile_max, tern, bits,
    # lab_a, lab_b, flags, black, white, payload, stream
    "chalkydri_ccl_extract": [_P, _I, _I, _I, _I, _I] + [_P] * 11,
    # gray, B, H, W, C, iters, min_diff, black, white, payload, rounds,
    # stream
    "chalkydri_ccl_extract_cluster": [_P] + [_I] * 6 + [_P] * 5,
    # key, payload, B, n, status, epoch, t, cand_len, cand_pos, stream
    "chalkydri_segment_stats": [_P, _P, _I, _I] + [_P] * 6,
    # gray, B, H, W, min_diff, tile_min, tile_max, tern, stream
    "chalkydri_threshold": [_P, _I, _I, _I, _I] + [_P] * 4,
    # tern, B, H, W, iters, bits, labels, scratch, flags, stream
    "chalkydri_label_components": [_P, _I, _I, _I, _I] + [_P] * 5,
    # gray, B, H, W, wp, min_diff, tern, parent, labels, stream
    "chalkydri_threshold_ccl_exact": [_P, _I, _I, _I, _I, _I] + [_P] * 4,
    # tern, B, H, W, wp, C, labels, stream
    "chalkydri_label_components_cluster": [_P] + [_I] * 5 + [_P] * 2,
    # tern, labels, active, B, H, W, C, out, stream
    "chalkydri_propagate_components_cluster": [_P] * 3 + [_I] * 4 + [_P] * 2,
    # tern, B, H, W, wp, parent, labels, stream
    "chalkydri_label_components_exact": [_P, _I, _I, _I, _I] + [_P] * 3,
    # tern, labels, active, B, H, W, parent, rootval, out, stream
    "chalkydri_propagate_components": [_P] * 3 + [_I] * 3 + [_P] * 4,
    # tern, labels, B, Hext, W, halo_top, halo_bottom, y_offset, black,
    # white, payload, stream
    "chalkydri_extract_band": [_P, _P, _I, _I, _I, _I, _I, _I] + [_P] * 4,
    # out, slot, stream
    "chalkydri_stage_stamp": [_P, _I, _P],
    # ptrs, ints, reals (csrc/solve.cu lists their entries), stream
    "chalkydri_solve": [_P] * 4,
    # ptrs, ints (csrc/tail.cu lists their entries), stream
    "chalkydri_tail_quads": [_P] * 3,
    # ptrs, ints, reals, stream
    "chalkydri_tail_refine": [_P] * 4,
    # ptrs, ints, stream
    "chalkydri_tail_decode": [_P] * 3,
    # tern, labels, B, H, W, keep0, keep1, counts0, counts1, flags0,
    # flags1, sel, part, black, white, payload, dropped, stream
    "chalkydri_front_extract": [_P] * 2 + [_I] * 5 + [_P] * 11,
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (nvcc on PATH or /usr/local/cuda/bin)")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(BUILD_DIR, f"libchalkydri_kernels_{_digest()}.so")


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands side by side; raise with the output of the first
    that fails, after all have ended."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    outputs = [p.communicate() for p in procs]
    for p, (out, err) in zip(procs, outputs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{out}\n{err}")


_LOCK = threading.RLock()  # build() and kernel_library(), one thread at a time
_LIBRARY: ctypes.CDLL | None = None
_CAPTURING = threading.local()  # .tally: this thread's CUDA graph capture
_PLAIN = threading.local()  # .on: this thread is inside plain_chain()


def build() -> str:
    """Compile the kernels unless a library for these sources exists;
    returns its path. One nvcc per source, all started together, then one
    link."""
    with _LOCK:
        path = library_path()
        if os.path.exists(path):
            return path
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = _nvcc()
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        _compile(nvcc, tmp)
        os.replace(tmp, path)
        return path


def _compile(nvcc: str, tmp: str) -> None:
    """Compile every source to ``tmp.<source>.o`` and link them to
    ``tmp``; the objects are removed either way."""
    objs = [f"{tmp}.{s}.o" for s in SOURCES]
    try:
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, os.path.join(CSRC_DIR, s)]
                  for s, o in zip(SOURCES, objs)])
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)


def kernel_library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call, once, whichever
    threads call at the same time)."""
    global _LIBRARY
    if _LIBRARY is not None:
        return _LIBRARY
    with _LOCK:
        if _LIBRARY is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIBRARY = lib
    return _LIBRARY


def empty(shape, dtype, like: torch.Tensor) -> torch.Tensor:
    """Uninitialised output or scratch tensor on ``like``'s device."""
    return torch.empty(shape, dtype=dtype, device=like.device)


def on_card(*tensors: torch.Tensor) -> bool:
    """Whether a kernel wrapper launches its kernel: every tensor on a CUDA
    device and this thread outside ``plain_chain()``. When it is false the
    wrapper returns its plain twin's result. Raises ``ValueError`` on a
    device that is neither CUDA nor the CPU, which neither route takes."""
    cuda = True
    for x in tensors:
        if x.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {x.device} (the kernels "
                             f"take CUDA tensors, their plain twins CPU "
                             f"or CUDA ones)")
        cuda = cuda and x.device.type == "cuda"
    return cuda and not getattr(_PLAIN, "on", False)


@contextlib.contextmanager
def plain_chain():
    """Within this context every kernel wrapper called from this thread
    returns its plain twin's result, CUDA tensors included. It nests, and
    restores the state it found on exit."""
    before = getattr(_PLAIN, "on", False)
    _PLAIN.on = True
    try:
        yield
    finally:
        _PLAIN.on = before


def same_device(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless the tensors are on one device."""
    dev = tensors[0].device
    if any(x.device != dev for x in tensors[1:]):
        raise ValueError(f"{name}: tensors on different devices")


def _on_current_card(like: torch.Tensor) -> bool:
    index = like.device.index
    return index is None or index == torch.cuda.current_device()


def stream_of(like: torch.Tensor) -> int:
    """The handle of the current stream of ``like``'s card."""
    if _on_current_card(like):
        return torch.cuda.current_stream().cuda_stream
    return torch.cuda.current_stream(like.device).cuda_stream


def call(entry: str, like: torch.Tensor, *args) -> int:
    """Call the library's C entry point ``entry`` with ``args`` and the
    current stream of ``like``'s card; returns its code. A device context
    is entered only when that card is not the current one."""
    fn = getattr(kernel_library(), entry)
    if _on_current_card(like):
        return fn(*args, torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(like.device):
        return fn(*args, torch.cuda.current_stream().cuda_stream)


def launch(entry: str, like: torch.Tensor, *args) -> None:
    """``call``, raising on a launch error."""
    check(call(entry, like, *args), entry)


def check(rc: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` code from a launch."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def check_cluster(rc: int, name: str, c: int, nbytes: int) -> None:
    """``check`` for a cluster launch (``ccl_common.cuh::launch_cluster``),
    whose code -2 says the card cannot schedule one cluster of ``c`` CTAs
    with ``nbytes`` of shared memory each."""
    if rc == -2:
        raise RuntimeError(
            f"{name}: this card cannot schedule a cluster of {c} CTAs with "
            f"{nbytes} bytes of shared memory each")
    check(rc, name)


def count(fn, attr: str = "launches") -> None:
    """Count one launch of ``fn``'s kernel in ``fn.<attr>``. While this
    thread captures a CUDA graph (``capture_tally``) the kernel is only
    recorded into the graph, so the count goes to the capture's tally,
    which each replay of the graph adds (``add_tally``)."""
    tally = getattr(_CAPTURING, "tally", None)
    if tally is None:
        setattr(fn, attr, getattr(fn, attr) + 1)
    else:
        tally[(fn, attr)] = tally.get((fn, attr), 0) + 1


@contextlib.contextmanager
def capture_tally():
    """Within this context ``count`` tallies this thread's launches into
    the dict it yields, {(wrapper, counter name): launches}."""
    _CAPTURING.tally = tally = {}
    try:
        yield tally
    finally:
        _CAPTURING.tally = None


def add_tally(tally: dict) -> None:
    """Count the launches of one replay of a graph captured with ``tally``."""
    for (fn, attr), n in tally.items():
        setattr(fn, attr, getattr(fn, attr) + n)
