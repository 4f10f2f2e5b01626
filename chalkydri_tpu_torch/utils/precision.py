"""Matmul-precision policy: full float32 everywhere.

The geometry and solver math (3x3 rotations, camera models, 9x9 solver
systems) needs full float32 products; TF32 keeps about three decimal digits
and would degrade the solved pose the way bf16 did on the JAX side. The
detector's products are tiny and exact-integer or geometry too, so the
policy is global: TF32 off for matmuls and cuDNN, matmul precision
"highest". It is set once, by the builders (``make_detector``,
``make_frame_solver``), in place of the JAX package's per-call
``highest_precision`` decorator.
"""

from __future__ import annotations

import torch


def full_fp32() -> None:
    """Turn TF32 off and ask for full float32 matmuls (idempotent)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
