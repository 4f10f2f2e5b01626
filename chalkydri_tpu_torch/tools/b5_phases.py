"""Where kernel B5's tile kernel spends its time, phase by phase.

    python3 -m chalkydri_tpu_torch.tools.b5_phases

Builds a copy of ``csrc/threshold_ccl.cu`` in which thread 0 of every CTA of
``tile_kernel`` reads ``clock64()`` as each phase starts (the phases are
separated by block barriers, so a phase's cycles run from the barrier
before it to the barrier after it), as the CTA ends and, for a CTA of skip
pixels only, as it returns early, with ``%globaltimer`` at its start. The
copy goes to ``chalkydri_tpu_torch/_build/b5_phases/`` and serves this
probe only. It runs B5 once on the deployed scene [2, 1304, 1600] and once
on the deployed-shape serpentine (``perfprobe.B5_STRIPES`` stripes), holds
tern and labels to the plain twin, and prints for each a line of SM cycles
a phase (median / p90 / max over the CTAs that hold non-skip pixels), of a
whole such CTA and of a skip-only CTA, and the time over which the CTAs
started. Fails without CUDA.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

import numpy as np
import torch

from chalkydri_tpu_torch.ops import build

PHASES = ("stage", "tile min/max", "thresholds", "classify", "runs", "unions",
          "flatten", "marks", "labels")
SLOTS = 16  # a CTA's words: phase starts, end (9), early exit (10), ns (11)
OUT_DIR = os.path.join(build.BUILD_DIR, "b5_phases")

_MARK = ("if (threadIdx.x == 0) "
         f"g_phase[blockIdx.x * {SLOTS} + %d] = clock64();")
_START_NS = (f"if (threadIdx.x == 0) {{ unsigned long long t; asm volatile("
             f"\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t)); "
             f"g_phase[blockIdx.x * {SLOTS} + 11] = t; }}")
_READER = """
extern "C" int b5_phases_read(long long* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, g_phase, (size_t)n * 8);
}
extern "C" int b5_phases_clear(int n) {
  void* p;
  const cudaError_t e = cudaGetSymbolAddress(&p, g_phase);
  return e ? (int)e : (int)cudaMemset(p, 0, (size_t)n * 8);
}
"""


def instrumented_source(src: str, max_ctas: int) -> str:
    """``threshold_ccl.cu`` with the clock reads in ``tile_kernel``."""
    head, rest = src.split("    tile_kernel(", 1)
    body, tail = rest.split("\n// Launch 2:", 1)
    exit_at = "    return;\n  }\n  // 4. "
    if exit_at not in body:
        raise RuntimeError("tile_kernel: no early exit before phase 4")
    body = body.replace(exit_at, f"    {_MARK % 10}\n{exit_at}", 1)
    body = body.replace("  // 0. ",
                        f"  {_START_NS}\n  {_MARK % 0}\n  // 0. ", 1)
    for k in range(1, len(PHASES)):
        if f"\n  // {k}. " not in body:
            raise RuntimeError(f"tile_kernel: no phase {k}")
        body = body.replace(f"\n  // {k}. ", f"\n  {_MARK % k}\n  // {k}. ", 1)
    end = body.rstrip().rfind("}")
    body = f"{body[:end]}  {_MARK % len(PHASES)}\n{body[end:]}"
    head = head.replace("struct TileSmem {", f"__device__ long long g_phase["
                        f"{max_ctas * SLOTS}];\n\nstruct TileSmem {{", 1)
    return f"{head}    tile_kernel({body}\n// Launch 2:{tail}{_READER}"


def build_instrumented(max_ctas: int) -> ctypes.CDLL:
    os.makedirs(OUT_DIR, exist_ok=True)
    for name in build.HEADERS:
        shutil.copy(os.path.join(build.CSRC_DIR, name), OUT_DIR)
    with open(os.path.join(build.CSRC_DIR, "threshold_ccl.cu")) as f:
        src = instrumented_source(f.read(), max_ctas)
    cu = os.path.join(OUT_DIR, "threshold_ccl.cu")
    with open(cu, "w") as f:
        f.write(src)
    lib_path = os.path.join(OUT_DIR, "libb5_phases.so")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
                    lib_path, cu], check=True)
    lib = ctypes.CDLL(lib_path)
    entry = lib.chalkydri_threshold_ccl_exact
    entry.argtypes = build._SIGNATURES["chalkydri_threshold_ccl_exact"]
    entry.restype = ctypes.c_int
    return lib


def run(lib, gray: torch.Tensor) -> np.ndarray:
    """One call of the instrumented B5 on ``gray``, held to the twin:
    the CTAs' words [CTAs, SLOTS]."""
    from chalkydri_tpu_torch.detector.segment import padded_width
    from chalkydri_tpu_torch.detector.threshold import MIN_WHITE_BLACK_DIFF
    from chalkydri_tpu_torch.ops.threshold_ccl import (
        RECT_COLS,
        RECT_ROWS,
        threshold_ccl_exact_plain,
    )

    b, h, w = gray.shape
    ctas = b * -(-h // RECT_ROWS) * -(-w // RECT_COLS)
    tern = torch.empty_like(gray)
    parent = torch.empty(gray.shape, dtype=torch.int32, device=gray.device)
    labels = torch.empty_like(parent)

    def call():
        build.check(lib.chalkydri_threshold_ccl_exact(
            gray.data_ptr(), b, h, w, padded_width(w), MIN_WHITE_BLACK_DIFF,
            tern.data_ptr(), parent.data_ptr(), labels.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "b5_phases")

    for _ in range(3):
        call()
    build.check(lib.b5_phases_clear(ctas * SLOTS), "b5_phases_clear")
    call()
    torch.cuda.synchronize()
    want = threshold_ccl_exact_plain(gray)
    if not (torch.equal(tern, want[0]) and torch.equal(labels, want[1])):
        raise AssertionError("the instrumented B5 differs from its twin")
    words = (ctypes.c_longlong * (ctas * SLOTS))()
    build.check(lib.b5_phases_read(words, ctas * SLOTS), "b5_phases_read")
    return np.frombuffer(words, dtype=np.int64).reshape(ctas, SLOTS).copy()


def spread(x: np.ndarray) -> str:
    return (f"{np.median(x):.0f}/{np.percentile(x, 90):.0f}/{x.max()}"
            if x.size else "none")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("b5_phases: CUDA is not available")
    from chalkydri_tpu_torch.tools.perfprobe import B5_STRIPES
    from chalkydri_tpu_torch.tools.scenes import load_scene, serpentine

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    deployed = load_scene("deployed", dev)[3]
    snake = torch.from_numpy(np.stack(
        [serpentine(*deployed.shape[1:], B5_STRIPES)] * len(deployed))).to(dev)
    lib = build_instrumented(max_ctas=1 << 14)
    n = len(PHASES)
    for name, gray in (("deployed scene", deployed),
                       ("deployed serpentine", snake)):
        a = run(lib, gray)
        busy = a[:, n] != 0
        phases = ", ".join(f"{p} {spread(a[busy, k + 1] - a[busy, k])}"
                           for k, p in enumerate(PHASES))
        start_us = (a[:, 11] - a[:, 11].min()) / 1e3
        print(f"B5 phases {name} {list(gray.shape)}: {busy.sum()} of "
              f"{len(a)} CTAs hold non-skip pixels; SM cycles median/p90/max: "
              f"{phases}; such a CTA {spread(a[busy, n] - a[busy, 0])}; a "
              f"skip-only CTA {spread(a[~busy, 10] - a[~busy, 0])}; CTAs "
              f"started within {start_us.max():.1f} us [{card}]", flush=True)


if __name__ == "__main__":
    main()
