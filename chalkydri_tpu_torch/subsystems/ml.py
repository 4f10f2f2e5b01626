"""MlSubsys: the ML inference hook (port of
``chalkydri_tpu/subsystems/ml.py``).

The reference reserved a Coral Edge TPU + TFLite slot (``MlSubsys {}`` config,
``chalkydri_core/src/config.rs:101-102``; build infra
``build/build-ml.sh:12-160``; the TFLedge subsystem itself was removed,
``book/src/maintenance/subprojects.md:12-14``). Here the slot is a torch
model hook: any callable ``frame tensor -> outputs`` (a function or an
``nn.Module``) is attached and called on each frame as a tensor on the
App's device, next to the vision step.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from chalkydri_tpu_torch.runtime.clock import RobotClock, Stamped
from chalkydri_tpu_torch.runtime.tasks import SinkTask, register_task


@register_task("MlSubsys")
class MlSubsys(SinkTask):
    """config: {model: import path "pkg.mod:fn" or None}. The resolved
    callable is applied per frame, on the device the App provides as the
    ``app.device`` resource (the card when no App provides one)."""

    def __init__(self, config=None, resources=None):
        super().__init__(config, resources)
        self._fn = None
        self.last_output = None
        self.device = torch.device("cuda")
        if resources is not None:
            try:
                self.device = torch.device(resources.get("app.device"))
            except KeyError:
                pass
        spec = self.config.get("model")
        if spec:
            self._fn = self._resolve(spec)

    @staticmethod
    def _resolve(spec: str) -> Callable:
        import importlib

        mod_name, _, fn_name = spec.partition(":")
        return getattr(importlib.import_module(mod_name), fn_name or "model")

    def attach(self, fn: Callable) -> None:
        self._fn = fn

    @torch.no_grad()
    def process(self, clock: RobotClock, msg: Stamped) -> None:
        if msg.payload is None or self._fn is None:
            return
        frame = torch.from_numpy(np.ascontiguousarray(msg.payload))
        self.last_output = self._fn(frame.to(self.device))
