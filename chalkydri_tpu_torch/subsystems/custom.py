"""PythonSubsys: user-supplied per-frame Python code.

Port of the reference's pyo3-embedded custom subsystems
(``crates/chalkydri/src/subsystems/python/mod.rs:24-199``): the TOML config
carries named code strings (``custom_subsystems.{name}.code``,
``chalkydri_core/src/config.rs:49,103-105``); each is loaded as a module that
must define ``run(frame) -> dict[str, float]``; returned values are published
to NetworkTables topics ``/chalkydri/subsystems/{name}``
(mod.rs:113-120). Being already in Python, no embedding layer is needed —
the user API surface (``chalkydri.Camera.get_frame`` analogue: the frame
comes as a numpy array argument) is preserved.
"""

from __future__ import annotations

import types
from typing import Callable

import numpy as np

from chalkydri_tpu_torch.runtime.clock import RobotClock, Stamped
from chalkydri_tpu_torch.runtime.tasks import SinkTask, register_task


def load_subsystem(name: str, code: str) -> Callable[[np.ndarray], dict]:
    """Compile a user code string into its ``run`` callable.

    The module must define ``run(frame)`` returning {str: float} (the
    reference converts the returned PyDict to NT floats, mod.rs:150-170).
    """
    mod = types.ModuleType(f"chalkydri_custom_{name}")
    exec(compile(code, f"<subsystem {name}>", "exec"), mod.__dict__)
    run = getattr(mod, "run", None)
    if not callable(run):
        raise ValueError(f"custom subsystem {name!r} defines no run(frame)")
    return run


@register_task("PythonSubsys")
class PythonSubsys(SinkTask):
    """config: {name, code}; publishes outputs via the NT hook resource if
    present, else keeps a last-values dict (inspectable/testable)."""

    def __init__(self, config=None, resources=None):
        super().__init__(config, resources)
        self.name = self.config.get("name", "custom")
        self._run = load_subsystem(self.name, self.config.get("code", "def run(frame):\n    return {}\n"))
        self.last_values: dict[str, float] = {}
        self._nt = None
        if resources is not None:
            try:
                self._nt = resources.get("nt.client")
            except KeyError:
                self._nt = None

    def process(self, clock: RobotClock, msg: Stamped) -> None:
        if msg.payload is None:
            return
        out = self._run(np.asarray(msg.payload))
        if not isinstance(out, dict):
            return
        self.last_values = {str(k): float(v) for k, v in out.items()}
        if self._nt is not None:
            for k, v in self.last_values.items():
                # topic schema: /chalkydri/subsystems/{name} (mod.rs:113)
                self._nt.publish(f"/chalkydri/subsystems/{self.name}/{k}", v)
