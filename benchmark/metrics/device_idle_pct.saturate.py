"""Share of the window's untraced stretch in which the device ran none of
the App's dispatches (CUDA events on the step's stream, from the frames'
upload to the queued fetch; ``trace.StepTimes``): time the device waited
for the host."""

from benchmark.trace import device_idle_pct as read  # noqa: F401
