"""Task model: sources, transforms, sinks, resources.

Rebuild of the Copper task surface the reference is written against
(``cu29``: ``CuSrcTask`` / ``CuTask`` / ``CuSinkTask`` with
new/start/process/stop lifecycle, resource bundles, ``Freezable`` state
snapshots — SURVEY.md section 2.2 row 1):

- ``SrcTask.process(clock) -> Stamped | None`` (emits)
- ``Task.process(clock, msg) -> Stamped | None`` (transforms)
- ``SinkTask.process(clock, msg) -> None`` (consumes)
- ``ResourceManager`` provides shared resources (the ``comm`` bundle in
  ``chalkydri.ron:106-111``) by "bundle.key" path.
- ``freeze()/thaw()`` hooks mirror Copper's Freezable (no-op by default, as
  in every reference task, e.g. ``crates/apriltags/src/lib.rs:215``).

The device twist lives in the scheduler, not here: batchable sink chains
are fused into one batched device step (``runtime/app.py``).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from chalkydri_tpu_torch.runtime.clock import RobotClock, Stamped


class ResourceManager:
    """Named shared resources, addressed "bundle.resource" like the RON
    ``resources: {"comm": "comm.comm"}`` mapping (chalkydri.ron:32-34)."""

    def __init__(self):
        self._resources: dict[str, Any] = {}

    def add(self, key: str, value: Any) -> None:
        self._resources[key] = value

    def get(self, key: str) -> Any:
        if key not in self._resources:
            raise KeyError(f"resource {key!r} not provided")
        return self._resources[key]

    def close(self) -> None:
        for v in self._resources.values():
            close = getattr(v, "close", None)
            if callable(close):
                close()


class BaseTask:
    """Lifecycle parity with Copper tasks: __init__(config, resources) ~ new;
    start/stop hooks; freeze/thaw ~ Freezable."""

    def __init__(self, config: Optional[dict] = None,
                 resources: Optional[ResourceManager] = None):
        self.config = config or {}
        self.resources = resources

    def start(self, clock: RobotClock) -> None:
        pass

    def stop(self, clock: RobotClock) -> None:
        pass

    def freeze(self) -> dict:
        return {}

    def thaw(self, state: dict) -> None:
        pass


class SrcTask(BaseTask):
    def process(self, clock: RobotClock) -> Optional[Stamped]:
        raise NotImplementedError


class Task(BaseTask):
    def process(self, clock: RobotClock, msg: Stamped) -> Optional[Stamped]:
        raise NotImplementedError


class SinkTask(BaseTask):
    def process(self, clock: RobotClock, msg: Stamped) -> None:
        raise NotImplementedError


class TaskRegistry:
    """Maps RON ``type`` strings to task classes. The reference's type names
    (``CamPipeline``, ``GstToCuImage``, ``chalkydri_apriltags::AprilTags``,
    ...) are registered as aliases so existing graph files load unchanged."""

    def __init__(self):
        self._types: dict[str, type] = {}

    def register(self, name: str, cls: type, *aliases: str) -> None:
        self._types[name] = cls
        for a in aliases:
            self._types[a] = cls

    def resolve(self, name: str) -> type:
        if name in self._types:
            return self._types[name]
        # Allow the trailing path segment ("foo::Bar" -> "Bar").
        short = name.rsplit("::", 1)[-1]
        if short in self._types:
            return self._types[short]
        raise KeyError(f"unknown task type {name!r}")

    def names(self):
        return sorted(self._types)


REGISTRY = TaskRegistry()


def register_task(name: str, *aliases: str) -> Callable[[type], type]:
    def deco(cls):
        REGISTRY.register(name, cls, *aliases)
        return cls

    return deco
