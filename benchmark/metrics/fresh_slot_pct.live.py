"""The share, in %, of the replayed step's batch slots that carried a fresh
frame: the sum of the App's counter ``app.slots_fresh`` (the cameras of a
dispatching group with a fresh frame) over the sum of ``app.slots`` (the
batch's slots), both from ``utils.tracing.SPANS``, over the dispatches
recorded in the untraced stretch (between the first and the last
``StepClock`` start), as the stage readers filter their records. The
step runs every slot, so the rest of them is work whose answer nobody
publishes. None where there is no such record, and where the program
keeps no counters."""


def read(ctx):
    from chalkydri_tpu_torch.utils.tracing import SPANS

    if ctx.steps is None or not hasattr(SPANS, "counted_between"):
        return None
    t0, t1 = ctx.steps.host_starts[0], ctx.steps.host_starts[-1]
    slots = sum(SPANS.counted_between("app.slots", t0, t1))
    fresh = sum(SPANS.counted_between("app.slots_fresh", t0, t1))
    return 100.0 * fresh / slots if slots else None
