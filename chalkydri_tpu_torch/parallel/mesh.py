"""The device grid and the placement of frames on it (port of
``chalkydri_tpu/parallel/mesh.py``).

- cameras/frames -> the ``data`` axis (frames are independent);
- image rows -> the ``space`` axis: each frame is cut into row bands, one
  per device of its data group, for frames too large for one device.

The grid is a plain tuple of tuples of ``torch.device`` driven by one
process. A device may appear more than once: with one card every band
lives on it, and with one card per band the same code places a band on
each and the exchanges of ``collectives`` become peer copies.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch


class Mesh(NamedTuple):
    """``grid[i][j]``: the device of row band ``j`` of data group ``i``."""

    grid: tuple[tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.grid), "space": len(self.grid[0])}


def make_mesh(devices: Sequence[str | torch.device] | None = None,
              space: int = 1) -> Mesh:
    """A ('data', 'space') grid over ``devices`` (repeats allowed; by
    default every visible CUDA card): ``space`` consecutive devices form
    one data group."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        if not devices:
            raise ValueError("make_mesh: no CUDA card is visible; pass the "
                             "devices of the grid")
    devs = [torch.device(d) for d in devices]
    if space < 1 or not devs or len(devs) % space:
        raise ValueError(f"{len(devs)} devices do not split into groups of "
                         f"{space}")
    return Mesh(tuple(tuple(devs[i:i + space])
                      for i in range(0, len(devs), space)))


def _groups(mesh: Mesh, batch: int) -> int:
    n_data = mesh.shape["data"]
    if batch % n_data:
        raise ValueError(f"camera batch {batch} must be a multiple of the "
                         f"data axis {n_data}")
    return batch // n_data


def place_batch(mesh: Mesh, x) -> list[torch.Tensor]:
    """[B, ...] per-camera values -> one [B / data, ...] tensor per data
    group, on the group's first device."""
    x = torch.as_tensor(x)
    per = _groups(mesh, x.shape[0])
    return [x[i * per:(i + 1) * per].to(row[0])
            for i, row in enumerate(mesh.grid)]


def place_frames(mesh: Mesh, frames, spatial: bool = False):
    """[B, H, W] frames -> ``bands[i][j]``: the frames of data group ``i``,
    whole on the group's first device (one entry), or with ``spatial`` cut
    into ``space`` contiguous row bands [B / data, H / space, W], band
    ``j`` on ``grid[i][j]``."""
    frames = torch.as_tensor(frames)
    per = _groups(mesh, frames.shape[0])
    n_space = mesh.shape["space"] if spatial else 1
    h = frames.shape[1]
    if h % n_space:
        raise ValueError(f"{h} frame rows do not split into {n_space} bands")
    hl = h // n_space
    return [[frames[i * per:(i + 1) * per, j * hl:(j + 1) * hl]
             .to(row[j]).contiguous() for j in range(n_space)]
            for i, row in enumerate(mesh.grid)]


def gather_frames(bands, device=None) -> torch.Tensor:
    """The inverse of ``place_frames``: ``bands[i][j]`` -> [B, H, W] on
    ``device`` (default: the first band's)."""
    device = bands[0][0].device if device is None else device
    return torch.cat([torch.cat([b.to(device) for b in group], dim=1)
                      for group in bands], dim=0)


def frame_sharding(mesh: Mesh, spatial: bool = False):
    """The placement of [B, H, W] frames on ``mesh``: frames over ``data``,
    rows over ``space`` with ``spatial`` (``place_frames`` as a function of
    the frames, the counterpart of a ``NamedSharding`` for
    ``jax.device_put``)."""
    return lambda frames: place_frames(mesh, frames, spatial=spatial)


def batch_sharding(mesh: Mesh):
    """The placement of [B, ...] per-camera values: ``place_batch``."""
    return lambda x: place_batch(mesh, x)


def replicated(mesh: Mesh):
    """The placement of a value on every data group's first device."""
    return lambda x: [torch.as_tensor(x).to(row[0]) for row in mesh.grid]
