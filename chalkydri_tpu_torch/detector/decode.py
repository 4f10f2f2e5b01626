"""Stage 5: payload decode (port of ``chalkydri_tpu/detector/decode.py``).

Sample the data cells through the homography, threshold them against the
midpoint of two linear intensity models (border ring = black, the ring
just outside = white), match against every code x 4 rotations by XOR +
popcount, score the decision margin (mean |sample - threshold|), and roll
the corners so corner 0 is the decoded tag's bottom-left. Code words and
popcounts are int64 (torch supports few uint32 operations).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from chalkydri_tpu_torch.detector.families import TagFamily
from chalkydri_tpu_torch.detector.homography import (
    apply_homography,
    bilinear_sample,
    homography_from_corners,
)
from chalkydri_tpu_torch.ops.linalg import spd_solve


class Decoded(NamedTuple):
    tag_id: torch.Tensor  # [..., K] int32 (-1 when invalid)
    hamming: torch.Tensor  # [..., K] int32
    decision_margin: torch.Tensor  # [..., K] float32
    corners: torch.Tensor  # [..., K, 4, 2] rotation-corrected corners
    valid: torch.Tensor  # [..., K] bool


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Popcount of the low 32 bits of int64 words."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) >> 24) & 0xFF).to(torch.int32)


def sample_grids(family: TagFamily):
    """Sample coordinates in tag coords, float32: (data [nbits, 2], black
    [nb, 2] border ring cell centers, white [nw, 2] ring half a cell
    outside the border)."""
    dim, td = family.dim, family.total_dim
    s = 2.0 / td
    data = [(-1.0 + (c + 1.5) * s, 1.0 - (r + 1.5) * s)
            for r in range(dim) for c in range(dim)]
    black = [(-1.0 + (j + 0.5) * s, 1.0 - (i + 0.5) * s)
             for i in range(td) for j in range(td)
             if i in (0, td - 1) or j in (0, td - 1)]
    white = []
    m = 1.0 + 0.5 * s
    n_side = td + 1
    for i in range(n_side):
        t = -m + (2 * m) * i / (n_side - 1)
        white.extend([(t, m), (t, -m), (m, t), (-m, t)])
    return tuple(np.asarray(v, np.float32) for v in (data, black, white))


def _design(xy: np.ndarray) -> torch.Tensor:
    """Design matrix [S, 3] of the linear intensity model v ~ a + b x + c y."""
    return torch.from_numpy(np.stack([np.ones(len(xy), np.float32), xy[:, 0],
                                      xy[:, 1]], axis=-1))


def _eval_linear(coef: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    return (coef[..., 0, None] + coef[..., 1, None] * xy[:, 0]
            + coef[..., 2, None] * xy[:, 1])


class Decoder(nn.Module):
    """``decoder(gray [B, H, W] u8, corners [B, K, 4, 2], quad_valid
    [B, K]) -> Decoded`` for one family; the sample grids, the intensity
    model's design matrices and the codebook are buffers."""

    def __init__(self, family: TagFamily, bits_corrected: int = 2):
        super().__init__()
        self.bits_corrected = bits_corrected
        data_np, black_np, white_np = sample_grids(family)
        for name, xy in (("data", data_np), ("black", black_np),
                         ("white", white_np)):
            self.register_buffer(f"{name}_xy", torch.from_numpy(xy))
        for name, xy in (("black", black_np), ("white", white_np)):
            self.register_buffer(f"{name}_design", _design(xy))
        self.register_buffer(
            "codes", torch.from_numpy(family.codes32.reshape(-1, 2)))  # [N*4, 2]
        nbits = family.nbits
        self.register_buffer("bit_weight", torch.tensor(
            [1 << (nbits - 1 - i) for i in range(nbits)], dtype=torch.int64))
        # rolls[rot] reorders corners so corner 0 is the tag's bottom-left:
        # a roll by 2 - rot
        self.register_buffer("rolls", torch.tensor(
            [[(c - (2 - r)) % 4 for c in range(4)] for r in range(4)]))

    @staticmethod
    def _fit_linear(design: torch.Tensor, values: torch.Tensor):
        """Least squares of values [..., S] on design [S, 3]: 3x3 normal
        matrix with a 1e-6 ridge, unpivoted SPD solve."""
        eye = torch.eye(3, dtype=design.dtype, device=design.device)
        ata = design.T @ design + 1e-6 * eye
        atb = values @ design  # [..., 3]
        return spd_solve(ata.expand(*atb.shape[:-1], 3, 3), atb)

    def forward(self, gray, corners, quad_valid) -> Decoded:
        h = homography_from_corners(corners)  # [B, K, 3, 3]

        def sample(xy):
            return bilinear_sample(gray, apply_homography(h, xy))

        d_val = sample(self.data_xy)
        b_val = sample(self.black_xy)
        w_val = sample(self.white_xy)
        thresh = 0.5 * (
            _eval_linear(self._fit_linear(self.black_design, b_val), self.data_xy)
            + _eval_linear(self._fit_linear(self.white_design, w_val), self.data_xy))
        bits = d_val > thresh  # [B, K, nbits]
        margin = torch.abs(d_val - thresh).mean(dim=-1)
        contrast_ok = w_val.mean(dim=-1) - b_val.mean(dim=-1) > 10.0

        word = torch.where(bits, self.bit_weight, 0).sum(dim=-1)  # [B, K]
        ham = (popcount32(self.codes[:, 0] ^ (word[..., None] >> 32))
               + popcount32(self.codes[:, 1] ^ (word[..., None] & 0xFFFFFFFF)))
        best_ham = ham.amin(dim=-1)  # [B, K]
        pos = torch.arange(ham.shape[-1], device=ham.device)
        best = torch.where(ham == best_ham[..., None], pos,
                           ham.shape[-1]).amin(dim=-1)  # first argmin
        tag_id = (best // 4).to(torch.int32)
        ok = quad_valid & contrast_ok & (best_ham <= self.bits_corrected)
        order = self.rolls[best % 4]  # [B, K, 4]
        corners_out = corners.gather(-2, order[..., None].expand(*order.shape, 2))
        return Decoded(
            tag_id=torch.where(ok, tag_id, -1),
            hamming=best_ham.to(torch.int32),
            decision_margin=margin,
            corners=corners_out,
            valid=ok,
        )


def make_decoder(family: TagFamily, bits_corrected: int = 2,
                 device: str | torch.device = "cuda") -> Decoder:
    """The family's ``Decoder`` with its tables on ``device`` (the card
    unless the caller asks for the CPU)."""
    return Decoder(family, bits_corrected).to(device)
