"""Kernel B1 (``ops.ccl_extract``, ``csrc/ccl_extract.cu``): the fused
threshold, capped CCL rounds and boundary extraction on the decimated
frames, one cluster launch a call (``cluster_kernel``; B6's kernel of the
same name takes the labels as its second argument).

Work of one call at the cell's shapes (as ``chip_smoke.py`` counts it):
each decimated pixel read once (1 byte) and its three int32 candidate
pages written once for both directions (24 bytes); operations per pixel:
the tile threshold (6), 12 per CCL round the frames need (the kernel
runs the rounds a frame needs and one more, at most ``ccl_iters``), and
the extraction (16)."""

KERNELS = r"cluster_kernel\(unsigned char const\*, int, int"
LAUNCHES_PER_CALL = 1
THRESH_OPS, ROUND_OPS, EXTRACT_OPS = 6, 12, 16
CCL_ITERS = 12


def rounds_run(ctx) -> float:
    """The mean CCL rounds B1 runs a frame over the run's distinct
    frames, from the plain reference's threshold and round count."""
    if "b1_rounds" not in ctx.cache:
        import numpy as np
        import torch

        from benchmark.reference.detector import decimate2
        from benchmark.reference.segment import rounds_needed
        from benchmark.reference.threshold import adaptive_threshold

        frames = torch.from_numpy(np.stack(
            [f for cam in ctx.scene.frames for f in cam])).to(ctx.device)
        tern = adaptive_threshold(decimate2(frames))
        need = rounds_needed(tern, CCL_ITERS)
        ctx.cache["b1_rounds"] = float(
            (need + 1).clamp(max=CCL_ITERS).double().mean())
    return ctx.cache["b1_rounds"]


def work(ctx) -> tuple:
    b = len(ctx.config["mounts"])
    h = (ctx.config["height"] // 8) * 8 // 2
    w = (ctx.config["width"] // 8) * 8 // 2
    px = b * h * w
    return (px * (1 + 24),
            px * (THRESH_OPS + rounds_run(ctx) * ROUND_OPS + EXTRACT_OPS))
