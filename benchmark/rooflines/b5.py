"""Kernel B5 (``ops.threshold_ccl.threshold_ccl_exact``,
``csrc/threshold_ccl.cu``): the fused threshold and the tile union-find
to the global fixed point at full resolution, three launches a call
(``tile_kernel``, ``border_kernel``, ``resolve_kernel``).

Work of one call (as ``chip_smoke.py`` counts it): each pixel read once
(1 byte), its ternary class (1 byte) and label (4 bytes) written once;
operations per pixel: the tile threshold (6) and the union-find (10)."""

KERNELS = r"(?<![A-Za-z_])(tile_kernel|border_kernel|resolve_kernel)\b"
LAUNCHES_PER_CALL = 3
THRESH_OPS, UNION_FIND_OPS = 6, 10


def work(ctx) -> tuple:
    px = len(ctx.config["mounts"]) * ctx.config["height"] * ctx.config["width"]
    return px * (1 + 1 + 4), px * (THRESH_OPS + UNION_FIND_OPS)
