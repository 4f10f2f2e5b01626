# Frozen copy of chalkydri_tpu_torch/ops/linalg.py for the benchmark's plain
# reference; imports rewritten to this package. Do not edit to follow
# the program: the reference is held still while the program changes.
"""Small-matrix linear algebra (port of ``chalkydri_tpu/ops/linalg.py``).

Unpivoted elimination for small SPD systems, written out the same way as
the JAX package so both sides run the same arithmetic: one select per
pivot step, with a 1e-30 pivot floor.
"""

from __future__ import annotations

import torch


def _eliminate(m: torch.Tensor, n: int) -> torch.Tensor:
    """Gauss-Jordan elimination without pivoting on the augmented
    [..., n, n + k] matrix ``m``."""
    rows = torch.arange(n, device=m.device)[:, None]
    for k in range(n):
        piv = m[..., k, k:k + 1]
        piv = torch.where(torch.abs(piv) < 1e-30, torch.full_like(piv, 1e-30), piv)
        row = (m[..., k, :] / piv)[..., None, :]
        col = m[..., :, k:k + 1]
        m = torch.where(rows == k, row, m - col * row)
    return m


def spd_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve a x = b for small SPD a [..., n, n], b [..., n]."""
    n = a.shape[-1]
    return _eliminate(torch.cat([a, b[..., None]], dim=-1), n)[..., :, -1]


def spd_solve_many(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve a x = b with a matrix right-hand side b [..., n, k]: one
    augmented elimination for all k columns."""
    n = a.shape[-1]
    return _eliminate(torch.cat([a, b], dim=-1), n)[..., :, n:]


def lstsq_spd(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Least squares via the SPD normal equations (a^T a) x = a^T b; only
    for well-conditioned a."""
    ata = torch.einsum("...ij,...ik->...jk", a, a)
    atb = torch.einsum("...ij,...i->...j", a, b)
    return spd_solve(ata, atb)
