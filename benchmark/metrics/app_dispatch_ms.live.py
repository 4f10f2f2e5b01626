"""``app.dispatch`` of ``runtime.app.App`` (the staged batch's upload, the
gyro, the replay's enqueue and the fetch queued behind it): the median
over every iteration of the window that dispatched a step, each read from
``utils.tracing.SPANS`` right after its iteration."""

from benchmark.trace import app_dispatch_ms as read  # noqa: F401
