"""Kernel B2's share of its roofline (``benchmark/rooflines/b2.py``)."""

from benchmark.trace import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "b2")
