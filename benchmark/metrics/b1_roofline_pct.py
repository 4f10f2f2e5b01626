"""Kernel B1's share of its roofline (``benchmark/rooflines/b1.py``)."""

from benchmark.trace import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "b1")
