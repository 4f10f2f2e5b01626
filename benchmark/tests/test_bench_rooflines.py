"""The rooflines' byte counts give PERF.md's MB at PERF.md's shapes (the
kernel table: B1 [4, 400, 640], B2 [4, 65536], B5 [2, 1304, 1600]), and
the least time is the larger of the byte and operation bounds."""

import pytest

from benchmark import peaks
from benchmark.trace import Context, load_module


def _ctx(mounts, width, height, b1_rounds=5.0):
    cfg = {"mounts": [{}] * mounts, "width": width, "height": height}
    ctx = Context(workload={}, config=cfg, traffic={}, trace=None,
                  dispatch_ms=[], scene=None, device="cpu")
    ctx.cache["b1_rounds"] = b1_rounds
    return ctx


@pytest.mark.parametrize("kernel, shape, mb_in, mb_out", [
    ("b1", (4, 1280, 800), 1.02, 24.58),  # decimated to [4, 400, 640]
    ("b2", (4, 1280, 800), 2.10, 1.08),   # 4 x 65,536 sorted rows
    ("b5", (2, 1600, 1304), 4.17, 20.86),
])
def test_bytes_match_perf_md(kernel, shape, mb_in, mb_out):
    nbytes, ops = load_module("rooflines", kernel).work(_ctx(*shape))
    assert nbytes / 1e6 == pytest.approx(mb_in + mb_out, abs=0.011)
    assert ops > 0


def test_b1_counts_the_rounds_the_frames_need():
    roof = load_module("rooflines", "b1")
    _, ops5 = roof.work(_ctx(2, 1600, 1304, 5.0))
    _, ops6 = roof.work(_ctx(2, 1600, 1304, 6.0))
    assert ops6 - ops5 == 2 * 652 * 800 * roof.ROUND_OPS


def test_least_time_is_the_larger_bound():
    assert peaks.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert peaks.least_seconds(0, 67e12) == pytest.approx(1.0)
    assert peaks.least_seconds(3.35e6, 67e12) == pytest.approx(1.0)


def test_kernel_patterns_pick_their_kernels():
    import re

    names = {
        "b1": "(anonymous namespace)::cluster_kernel(unsigned char const*, "
              "int, int, int, int, int, int*, int*, int*, int*)",
        "b2": "(anonymous namespace)::segment_stats_kernel(int const*, int "
              "const*, int, long*, long*, int*, int*, int*)",
        "b5": "void (anonymous namespace)::tile_kernel<32, 128>(unsigned "
              "char const*, int, int, int, int, unsigned char*, int*, int*)",
    }
    b6 = ("(anonymous namespace)::cluster_kernel(unsigned char const*, int "
          "const*, int const*, int, int, int, int*)")
    b7 = "(anonymous namespace)::extract_tile_kernel(unsigned char const*)"
    for k, name in names.items():
        rx = re.compile(load_module("rooflines", k).KERNELS)
        assert rx.search(name)
        assert not rx.search(b6) and not rx.search(b7)
