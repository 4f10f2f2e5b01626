"""AAEC — Adaptive Active Exposure Control (port of
``chalkydri_tpu/subsystems/aaec.py``).

The reference's ``aaec`` crate is a stub: Sobel kernels declared, empty
``find_gradients`` (``crates/aaec/src/main.rs:4-17``; intent
"automatically adjust exposure to maximize image gradients",
``crates/aaec/README.md:2``). Implemented here for real, on the frames'
device:

gradient-magnitude sum G(exposure) is unimodal in exposure for a fixed scene;
the controller nudges manual exposure in the direction that increases the
mean Sobel gradient magnitude over the frame (a 1D hill climb with
hysteresis), which is the standard active-exposure formulation.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from chalkydri_tpu_torch.utils.precision import full_fp32

# Sobel kernels (aaec/src/main.rs:5-8), host constants.
_SOBEL_X = np.array([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]])
_SOBEL_Y = _SOBEL_X.T


@torch.no_grad()
def compute_exposure_gradients(gray: torch.Tensor) -> torch.Tensor:
    """Mean Sobel gradient magnitude per frame. gray: [B, H, W] uint8 ->
    [B] float32 on gray's device (the metric AAEC maximizes). Runs under
    the full-float32 policy: a TF32 convolution would change the metric."""
    full_fp32()
    x = gray.to(torch.float32)[:, None, :, :]  # NCHW
    k = torch.from_numpy(np.stack([_SOBEL_X, _SOBEL_Y])[:, None, :, :]).to(
        device=gray.device, dtype=torch.float32)  # OIHW
    g = F.conv2d(x, k)  # [B, 2, H-2, W-2], VALID
    mag = torch.sqrt(torch.sum(g * g, dim=1) + 1e-6)
    return torch.mean(mag, dim=(1, 2))


class ExposureController:
    """1D hill climb on manual exposure with hysteresis."""

    def __init__(self, initial: int = 100, step: int = 8,
                 lo: int = 1, hi: int = 10000, hysteresis: float = 0.02):
        self.exposure = initial
        self._step = step
        self._dir = 1
        self._lo, self._hi = lo, hi
        self._hyst = hysteresis
        self._last_metric = None

    def update(self, metric: float) -> int:
        """Feed the latest gradient metric; returns the next exposure."""
        if self._last_metric is not None:
            rel = (metric - self._last_metric) / max(abs(self._last_metric), 1e-9)
            if rel < -self._hyst:
                self._dir = -self._dir  # got worse: reverse
        self._last_metric = metric
        self.exposure = int(
            min(self._hi, max(self._lo, self.exposure + self._dir * self._step))
        )
        return self.exposure
