"""Kernel B5's share of its roofline (``benchmark/rooflines/b5.py``)."""

from benchmark.trace import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "b5")
