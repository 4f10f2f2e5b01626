"""Exchanges between the row bands of one data group, over the list of
band tensors (band ``j`` on its own device). They stand for the JAX
package's collectives over the ``space`` mesh axis (``ppermute``,
``all_gather``, ``psum``); a multi-process version over NCCL would replace
this module alone.

Every function returns new tensors: a received row is a copy even when
both bands share a device, so no band aliases rows its neighbour rewrites.
Between cards a value moves by a device-to-device copy, never through the
host, so every exchange can run inside a CUDA graph of one card.
"""

from __future__ import annotations

from typing import Sequence

import torch


def fetch_rows(rows: Sequence[torch.Tensor], direction: int):
    """Ring shift: band ``j`` receives a copy of band ``j - direction``'s
    tensor on its own device. ``direction`` +1 receives from the band
    above, -1 from the band below; the ring wraps, so the first (last)
    band's result is the caller's to overwrite."""
    n = len(rows)
    return [rows[(j - direction) % n].to(rows[j].device, copy=True)
            for j in range(n)]


def all_gather_rows(xs: Sequence[torch.Tensor], dim: int,
                    device: torch.device | None = None) -> torch.Tensor:
    """The bands' tensors concatenated along ``dim`` in band order, on
    ``device`` (default: the first band's)."""
    device = xs[0].device if device is None else device
    return torch.cat([x.to(device) for x in xs], dim=dim)


def sum_over_bands(xs: Sequence[torch.Tensor],
                   device: torch.device | None = None) -> torch.Tensor:
    """The elementwise sum of the bands' tensors, on ``device`` (default:
    the first band's)."""
    device = xs[0].device if device is None else device
    total = xs[0].to(device)
    for x in xs[1:]:
        total = total + x.to(device)
    return total


def psum(xs: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The elementwise sum of the bands' tensors, on every band's device
    (``jax.lax.psum`` over the ``space`` axis)."""
    total = sum_over_bands(xs)
    return [total.to(x.device, copy=True) for x in xs]
