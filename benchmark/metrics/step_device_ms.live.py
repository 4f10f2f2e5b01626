"""Device time of the replayed step: the kernels ``torch.profiler`` saw in
the traced window over the steps dispatched in it."""

from benchmark.trace import step_device_ms as read  # noqa: F401
