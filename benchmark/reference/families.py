# Frozen copy of chalkydri_tpu_torch/detector/families.py for the benchmark's plain
# reference; imports rewritten to this package. Do not edit to follow
# the program: the reference is held still while the program changes.
"""AprilTag family codebooks (port of ``chalkydri_tpu/detector/families.py``).

The codebooks are the port's own copies of the JAX package's data files,
``data/<name>.npz`` (tag36h11 only here; ``tests/test_torch_modules.py`` holds them equal to
the JAX package's tables). Code words stay int64: torch supports few
operations on uint32, and every code fits in 63 bits.

Bit packing convention (``chalkydri_tpu/tools/gen_families.py``): bit
(r, c) of the canonical upright rendering, row-major, MSB-first; bit = 1
means the cell is white.
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import NamedTuple

import numpy as np

_DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")

DEFAULT_FAMILY = "tag36h11"
DEFAULT_BITS_CORRECTED = 3


class TagFamily(NamedTuple):
    name: str
    dim: int  # data grid is dim x dim
    nbits: int
    ncodes: int
    min_hamming: int
    codes: np.ndarray  # [n] int64, canonical rotation
    codes_rot: np.ndarray  # [n, 4] int64, all four rotations
    codes32: np.ndarray  # [n, 4, 2] int64: (hi, lo) 32-bit halves

    @property
    def total_dim(self) -> int:
        """Tag side length in cells including the 1-cell black border."""
        return self.dim + 2


def _rotate_code(code: int, dim: int) -> int:
    """Rotate the bit grid 90 degrees clockwise."""
    nbits = dim * dim
    bits = [(code >> (nbits - 1 - i)) & 1 for i in range(nbits)]
    grid = np.array(bits, dtype=np.uint8).reshape(dim, dim)
    out = 0
    for b in np.rot90(grid, -1).reshape(-1):
        out = (out << 1) | int(b)
    return out


@lru_cache(maxsize=None)
def load_family(name: str = DEFAULT_FAMILY) -> TagFamily:
    path = os.path.join(_DATA_DIR, f"{name}.npz")
    if not os.path.exists(path):
        raise FileNotFoundError(f"family table {name!r} not found at {path}")
    with np.load(path) as data:
        codes = data["codes"].astype(np.int64)
        dim = int(data["dim"])
        min_hamming = int(data["min_hamming"])
    n = len(codes)
    codes_rot = np.zeros((n, 4), dtype=np.int64)
    codes_rot[:, 0] = codes
    for r in range(1, 4):
        codes_rot[:, r] = [_rotate_code(int(c), dim) for c in codes_rot[:, r - 1]]
    codes32 = np.stack([codes_rot >> 32, codes_rot & 0xFFFFFFFF], axis=-1)
    return TagFamily(name=name, dim=dim, nbits=dim * dim, ncodes=n,
                     min_hamming=min_hamming, codes=codes,
                     codes_rot=codes_rot, codes32=codes32)


def render_tag(family: TagFamily, tag_id: int, cell_px: int = 8,
               white_border: int = 1) -> np.ndarray:
    """A tag as a grayscale uint8 image (0/255): ``white_border`` cells of
    white, one cell of black border, then the data grid."""
    dim = family.dim
    code = int(family.codes[tag_id])
    nbits = family.nbits
    bits = np.array([(code >> (nbits - 1 - i)) & 1 for i in range(nbits)],
                    dtype=np.uint8).reshape(dim, dim)
    side = dim + 2 + 2 * white_border
    img = np.full((side, side), 255, dtype=np.uint8)
    b = white_border
    img[b:side - b, b:side - b] = 0
    img[b + 1:side - b - 1, b + 1:side - b - 1] = bits * 255
    return np.kron(img, np.ones((cell_px, cell_px), dtype=np.uint8))
