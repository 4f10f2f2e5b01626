"""Device resolution for the entry points (the port's counterpart of
``chalkydri_tpu/utils/platform.py``, which forces a JAX platform).

``main --device`` and ``App(device=...)`` name a torch device; the default
is the card. A CUDA device asked for on a machine without one raises:
nothing moves to the CPU unless the caller asks for it.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``, checked: a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but CUDA is not available; "
                "pass device='cpu' (main: --device cpu) to run on the CPU")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(dev)!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are visible")
    return dev
