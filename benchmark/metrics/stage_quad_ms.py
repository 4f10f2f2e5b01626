"""Device ms of the replayed step's stage ``step.quad``, quad fit and the
top quads: from the step's own stamps on the card (``utils.tracing``),
fetched with its poses; the median over the dispatches whose record
starts in the untraced stretch (between the first and the last
``StepClock`` start), those the CUDA events timed. None where there is
no such record."""

import statistics


def read(ctx):
    from chalkydri_tpu_torch.utils.tracing import SPANS

    if ctx.steps is None or not hasattr(SPANS, "between"):
        return None
    v = SPANS.between("step.quad", ctx.steps.host_starts[0],
                      ctx.steps.host_starts[-1])
    return statistics.median(v) * 1e3 if v else None
