"""Kernel B2 (``ops.segment_stats``, ``csrc/segment_stats.cu``): run
statistics of the sorted candidate keys, one launch a call.

Work of one call (as ``chip_smoke.py`` counts it): the [B, n] int32 keys
and payloads read once (8 bytes a row), ``t`` written once (4 bytes a
row), and the two top candidates of every 128-row chunk (length and
position, int32); 8 operations a row. ``n`` is the candidate budget the
clustering sorts, ``MAX_EDGE_POINTS``."""

KERNELS = r"segment_stats_kernel"
LAUNCHES_PER_CALL = 1
SEGMENT_OPS = 8


def work(ctx) -> tuple:
    from benchmark.reference.cluster import MAX_EDGE_POINTS

    n = len(ctx.config["mounts"]) * MAX_EDGE_POINTS
    return n * 12 + 2 * (2 * n // 128) * 4, n * SEGMENT_OPS
