"""Native (C++) runtime components: the whacknet fast path and the host
frame pool (port of ``chalkydri_tpu/native``).

The host-side runtime pieces are first-party C++ (``native/src``) built as
one shared library with ``make`` and bound through ``ctypes``. The build
runs on first use, never at import, into
``chalkydri_tpu_torch/_build/native/`` (ignored by git), so the source tree
stays clean. Callers fall back to pure-Python paths when no C++ compiler
is present.

Build by hand: ``make -C chalkydri_tpu_torch/native``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build", "native")
_LIB_PATH = os.path.join(BUILD_DIR, "libchalkydri_native.so")
_lock = threading.Lock()
_lib = None
_tried = False


def build_native(force: bool = False) -> str | None:
    """Compile the shared library with make/g++ into ``BUILD_DIR``.
    Returns the path or None."""
    if os.path.exists(_LIB_PATH) and not force:
        return _LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    # A temporary name per process and thread, then one rename: processes
    # that build at the same time never load a half-written library.
    tmp = f"{_LIB_PATH}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        subprocess.run(
            ["make", "-C", _DIR, "-s", "-B", f"TARGET={tmp}"],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, _LIB_PATH)
    except (OSError, subprocess.CalledProcessError, subprocess.TimeoutExpired):
        if os.path.exists(tmp):
            os.remove(tmp)
        return None
    return _LIB_PATH


def load_native():
    """dlopen the native library (building it on first use). None if
    unavailable — callers fall back to pure-Python paths."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = build_native()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None

        # -- whacknet ------------------------------------------------------
        lib.whacknet_start.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
        lib.whacknet_start.restype = ctypes.c_int
        lib.whacknet_send.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        lib.whacknet_send.restype = ctypes.c_int
        lib.whacknet_gyro.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_double)]
        lib.whacknet_gyro.restype = ctypes.c_int
        lib.whacknet_stop.argtypes = [ctypes.c_int]
        lib.whacknet_stop.restype = None

        # -- framepool -----------------------------------------------------
        lib.framepool_create.argtypes = [ctypes.c_size_t, ctypes.c_int]
        lib.framepool_create.restype = ctypes.c_int
        lib.framepool_push.argtypes = [
            ctypes.c_int, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint64
        ]
        lib.framepool_push.restype = ctypes.c_int
        lib.framepool_acquire_latest.argtypes = [
            ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.framepool_acquire_latest.restype = ctypes.c_int
        lib.framepool_release.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.framepool_release.restype = None
        lib.framepool_dropped.argtypes = [ctypes.c_int]
        lib.framepool_dropped.restype = ctypes.c_uint64
        lib.framepool_destroy.argtypes = [ctypes.c_int]
        lib.framepool_destroy.restype = None

        _lib = lib
        return _lib
