# Frozen copy of chalkydri_tpu_torch/solver/sqpnp.py for the benchmark's plain
# reference; imports rewritten to this package. Do not edit to follow
# the program: the reference is held still while the program changes.
"""Batched SQPnP core (port of ``chalkydri_tpu/solver/sqpnp.py``).

Every function takes a leading batch of frames. The routines that produce
the rotation candidates (``_analytic_eigh3``, ``_jacobi_eigh_small``,
``smallest_eigvecs``, ``nearest_so3``, ``newton_refine``) are ported as
they are, with no library eigensolver, because the candidates come from
these exact routines. ``newton_refine`` runs a fixed loop of ``MAX_ITER``
masked steps: the JAX package's chunked while-loop also runs until every
candidate of the batch is done, and steps after convergence are masked
no-ops, so the result is the same.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from .linalg import spd_solve, spd_solve_many

MAX_ITER = 15
TOL_SQ = 1e-16
NUM_CANDIDATES = 6  # the JAX package's exported constant


class SqPnPResult(NamedTuple):
    rotation: torch.Tensor  # [..., 3, 3] world->cam
    translation: torch.Tensor  # [..., 3] world->cam
    energy: torch.Tensor  # [...] pure geometric energy r^T omega r
    valid: torch.Tensor  # [...] bool: a cheirality-passing candidate existed


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1))


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _det3(m: torch.Tensor) -> torch.Tensor:
    return _dot(m[..., 0, :], _cross(m[..., 1, :], m[..., 2, :]))


def _first_index(mask: torch.Tensor) -> torch.Tensor:
    """Lowest index along the last dim where ``mask`` holds (0 if none)."""
    n = mask.shape[-1]
    pos = torch.arange(n, device=mask.device)
    first = torch.where(mask, pos, n).amin(dim=-1)
    return torch.where(first == n, 0, first)


def _argmin(x: torch.Tensor) -> torch.Tensor:
    """argmin over the last dim, the first index on ties."""
    return _first_index(x == x.amin(dim=-1, keepdim=True))


def _argmax(x: torch.Tensor) -> torch.Tensor:
    return _first_index(x == x.amax(dim=-1, keepdim=True))


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx, ...] along dim idx.dim() for per-batch indices idx."""
    d = idx.dim()
    shape = list(x.shape)
    shape[d] = 1
    i = idx.reshape(*idx.shape, *([1] * (x.dim() - d)))
    return x.gather(d, i.expand(*shape)).squeeze(d)


def build_linear_system(points_3d: torch.Tensor, points_2d: torch.Tensor,
                        mask: torch.Tensor):
    """The SQPnP least-squares system over masked points.

    points_3d [..., N, 3] centered world points; points_2d [..., N, 3]
    camera rays; mask [..., N]. With P = I - v v^T / |v|^2 per ray:
    Q_tt = sum P, Q_rt[3i:3i+3] = sum p_i P, Q_rr[3i+a, 3j+b] =
    sum p_i p_j P[a, b]; omega = Q_rr - Q_rt Q_tt^-1 Q_rt^T.
    Returns (omega [..., 9, 9], q_tt_inv [..., 3, 3], q_rt [..., 9, 3]).
    """
    dtype = points_3d.dtype
    lead = points_3d.shape[:-2]
    m = mask.to(dtype)[..., None, None]
    sq_norm = torch.sum(points_2d * points_2d, dim=-1)
    inv_norm = torch.where(sq_norm > 0, 1.0 / torch.clamp(sq_norm, min=1e-30),
                           torch.zeros_like(sq_norm))
    v_vt = points_2d[..., :, None] * points_2d[..., None, :]
    eye = torch.eye(3, dtype=dtype, device=points_3d.device)
    proj = (eye - v_vt * inv_norm[..., None, None]) * m  # [..., N, 3, 3]
    q_tt = proj.sum(dim=-3)
    p = points_3d
    q_rt = torch.einsum("...ni,...nab->...iab", p, proj).reshape(*lead, 9, 3)
    q_rr = torch.einsum("...ni,...nj,...nab->...iajb", p, p,
                        proj).reshape(*lead, 9, 9)
    q_tt_inv = robust_inv3(q_tt)
    omega = q_rr - q_rt @ q_tt_inv @ q_rt.transpose(-1, -2)
    return omega, q_tt_inv, q_rt


def robust_inv3(m: torch.Tensor) -> torch.Tensor:
    """3x3 inverse by the adjugate; zeros when singular."""
    det = _det3(m)
    ok = torch.abs(det) > 1e-30
    safe = torch.where(ok, det, torch.ones_like(det))
    inv = _adjugate3(m) / safe[..., None, None]
    return torch.where(ok[..., None, None], inv, torch.zeros_like(m))


def _adjugate3(m: torch.Tensor) -> torch.Tensor:
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    cof = torch.stack([
        e * i - f * h, c * h - b * i, b * f - c * e,
        f * g - d * i, a * i - c * g, c * d - a * f,
        d * h - e * g, b * g - a * h, a * e - b * d,
    ], dim=-1)
    return cof.reshape(*m.shape[:-2], 3, 3)


def _round_robin_pairs(n: int):
    """Tournament schedule: the n(n-1)/2 index pairs in rounds of disjoint
    pairs (circle method; odd n gets a bye per round)."""
    m = n + (n % 2)
    rounds = []
    circle = list(range(m - 1))
    for r in range(m - 1):
        pairs = []
        a0 = circle[r]
        if m - 1 < n:
            pairs.append((min(a0, m - 1), max(a0, m - 1)))
        for i in range(1, m // 2):
            p = circle[(r + i) % (m - 1)]
            q = circle[(r - i) % (m - 1)]
            if p < n and q < n:
                pairs.append((min(p, q), max(p, q)))
        rounds.append(pairs)
    return rounds


@functools.lru_cache(maxsize=16)
def _jacobi_schedule(n: int, device: torch.device):
    """The round-robin schedule's (p, q) index tensors per round, made once
    per device so that a solve copies nothing from the host."""
    return [(torch.tensor([p for p, _ in pairs], device=device),
             torch.tensor([q for _, q in pairs], device=device))
            for pairs in _round_robin_pairs(n)]


def _jacobi_eigh_small(a: torch.Tensor, sweeps: int = 5):
    """Symmetric [..., n, n] eigendecomposition by parallel cyclic Jacobi:
    each round applies a round-robin schedule's disjoint Givens rotations
    as one compound rotation G, with all angles from the pre-round matrix.
    Returns (eigenvalues [..., n] unsorted, eigenvectors as columns)."""
    n = a.shape[-1]
    dtype, dev = a.dtype, a.device
    eye = torch.eye(n, dtype=dtype, device=dev)
    v = eye.expand_as(a)
    for _ in range(sweeps):
        for ps, qs in _jacobi_schedule(n, dev):
            app = a[..., ps, ps]
            aqq = a[..., qs, qs]
            apq = a[..., ps, qs]
            theta = 0.5 * torch.atan2(2.0 * apq, app - aqq)
            c, s = torch.cos(theta), torch.sin(theta)
            g = eye.expand_as(a).clone()
            g[..., ps, ps] = 1.0 + (c - 1.0)
            g[..., qs, qs] = 1.0 + (c - 1.0)
            g[..., qs, ps] = s
            g[..., ps, qs] = -s
            a = g.transpose(-1, -2) @ a @ g
            v = v @ g
    return torch.diagonal(a, dim1=-2, dim2=-1), v


def _analytic_eigh3(a: torch.Tensor):
    """Closed-form symmetric 3x3 eigendecomposition (trigonometric
    eigenvalues, cross-product eigenvectors), branch-free. Returns
    (eigenvalues [..., 3] descending, eigenvectors as columns [..., 3, 3],
    right-handed: v2 = v3 x v1)."""
    dtype, dev = a.dtype, a.device
    eye = torch.eye(3, dtype=dtype, device=dev)
    q = torch.diagonal(a, dim1=-2, dim2=-1).sum(dim=-1) / 3.0
    b = a - q[..., None, None] * eye
    p2 = torch.sum(b * b, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=0.0))
    safe_p = torch.clamp(p, min=1e-30)
    r = torch.clamp(_det3(b) / (2.0 * safe_p * safe_p * safe_p), -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    lam1 = q + 2.0 * p * torch.cos(phi)
    lam3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam2 = 3.0 * q - lam1 - lam3
    e0 = eye[0]

    def eigvec(lam):
        m = a - lam[..., None, None] * eye
        cs = torch.stack([_cross(m[..., 0, :], m[..., 1, :]),
                          _cross(m[..., 1, :], m[..., 2, :]),
                          _cross(m[..., 2, :], m[..., 0, :])], dim=-2)
        n2 = torch.sum(cs * cs, dim=-1)  # [..., 3]
        v = _take(cs, _argmax(n2))
        nv = _norm(v)
        return torch.where((nv > 1e-30)[..., None],
                           v / torch.clamp(nv, min=1e-30)[..., None], e0)

    v1 = eigvec(lam1)
    v3raw = eigvec(lam3)
    w3 = v3raw - _dot(v1, v3raw)[..., None] * v1
    nw3 = _norm(w3)
    ek = eye[_argmin(torch.abs(v1))]
    fb = ek - _dot(v1, ek)[..., None] * v1
    fb = fb / torch.clamp(_norm(fb), min=1e-30)[..., None]
    v3 = torch.where((nw3 > 1e-6)[..., None],
                     w3 / torch.clamp(nw3, min=1e-30)[..., None], fb)
    v2 = _cross(v3, v1)
    return (torch.stack([lam1, lam2, lam3], dim=-1),
            torch.stack([v1, v2, v3], dim=-1))


def nearest_so3(r_vec: torch.Tensor) -> torch.Tensor:
    """Project 9-vectors [..., 9] (column-major 3x3) onto SO(3): U V^T from
    the closed-form eigendecomposition of M^T M, with the two dominant
    singular directions orthonormalized and the third their cross product
    (which is also the det < 0 fix), with orthonormal fallbacks for the
    rank-deficient inputs the candidate guesses routinely are."""
    m = r_vec.reshape(*r_vec.shape[:-1], 3, 3).transpose(-1, -2)
    dtype, dev = m.dtype, m.device
    eye = torch.eye(3, dtype=dtype, device=dev)
    _, v_s = _analytic_eigh3(m.transpose(-1, -2) @ m)
    a1 = (m @ v_s[..., :, 0:1])[..., 0]
    a2 = (m @ v_s[..., :, 1:2])[..., 0]
    n1 = _norm(a1)
    scale = torch.clamp(n1, min=1e-20)
    u1 = torch.where((n1 > 1e-12)[..., None], a1 / scale[..., None], eye[0])
    w2 = a2 - _dot(u1, a2)[..., None] * u1
    n2 = _norm(w2)
    proj1 = eye - u1[..., :, None] * u1[..., None, :]
    cn = _norm(proj1.transpose(-1, -2))  # column norms
    fb2 = (_take(proj1.transpose(-1, -2), _argmax(cn))
           / torch.clamp(cn.amax(dim=-1), min=1e-20)[..., None])
    u2 = torch.where((n2 > 1e-5 * scale)[..., None],
                     w2 / torch.clamp(n2, min=1e-20)[..., None], fb2)
    u3 = _cross(u1, u2)
    u_s = torch.stack([u1, u2, u3], dim=-1)
    rot = u_s @ v_s.transpose(-1, -2)
    return rot.transpose(-1, -2).reshape(*r_vec.shape[:-1], 9)


@functools.lru_cache(maxsize=16)
def _constraint_tables(dtype: torch.dtype, device: torch.device):
    """(e_p [6, 3], e_q [6, 3], [p == q] [6]) for constraint k on columns
    (p_k, q_k) of R: the three unit norms, then the three orthogonalities;
    made once per device."""
    eye = torch.eye(3, dtype=dtype)
    diag = torch.tensor([1.0, 1.0, 1.0, 0.0, 0.0, 0.0], dtype=dtype)
    return (eye[[0, 1, 2, 0, 0, 1]].to(device),
            eye[[0, 1, 2, 1, 2, 2]].to(device), diag.to(device))


def constraints_and_jacobian(r: torch.Tensor):
    """SO(3) orthonormality constraints h [..., 6] and Jacobian [..., 6, 9]
    of column-major 9-vectors r: h_k = c_p . c_q - [p == q],
    jac_k = e_p (x) c_q + e_q (x) c_p."""
    c = r.reshape(*r.shape[:-1], 3, 3)  # row i = column i of R
    e1, e2, diag = _constraint_tables(r.dtype, r.device)
    g = c @ c.transpose(-1, -2)
    h = torch.sum((e1 @ g) * e2, dim=-1) - diag
    cq = e2 @ c  # [..., 6, 3]
    cp = e1 @ c
    jac = (e1[:, :, None] * cq[..., :, None, :]
           + e2[:, :, None] * cp[..., :, None, :])
    return h, jac.reshape(*r.shape[:-1], 6, 9)


def regularized_omega_inv(omega: torch.Tensor, eps_rel: float = 1e-4):
    """(omega + eps I)^-1 with a trace-relative shift eps."""
    dtype, dev = omega.dtype, omega.device
    eye = torch.eye(9, dtype=dtype, device=dev)
    tr = torch.diagonal(omega, dim1=-2, dim2=-1).sum(dim=-1)
    eps = eps_rel * torch.clamp(tr / 9.0, min=1e-12)
    return spd_solve_many(omega + eps[..., None, None] * eye,
                          eye.expand_as(omega))


def smallest_eigvecs(omega: torch.Tensor, omega_inv: torch.Tensor,
                     k: int = 3, apps: int = 4, block: int = 5):
    """The ``k`` smallest eigenvectors of symmetric PSD [..., 9, 9] (columns,
    ascending) by inverse subspace iteration on a 9 x ``block`` basis, then
    Rayleigh-Ritz by parallel Jacobi."""
    dtype, dev = omega.dtype, omega.device
    eye9 = torch.eye(9, dtype=dtype, device=dev)
    x = eye9[:, :block].expand(*omega.shape[:-2], 9, block)

    def orthonormalize(x):
        cols = []
        for j in range(block):
            c = x[..., :, j]
            for q in cols:
                c = c - _dot(q, c)[..., None] * q
            n = _norm(c)
            cols.append(torch.where((n > 1e-20)[..., None],
                                    c / torch.clamp(n, min=1e-20)[..., None],
                                    eye9[j]))
        return torch.stack(cols, dim=-1)

    for _ in range(apps):
        x = orthonormalize(omega_inv @ x)
    s = x.transpose(-1, -2) @ (omega @ x)
    w, u = _jacobi_eigh_small(s)
    order = torch.argsort(w, dim=-1, stable=True)[..., :k]
    u_k = u.gather(-1, order[..., None, :].expand(*u.shape[:-1], k))
    return x @ u_k


def newton_refine(r0: torch.Tensor, omega: torch.Tensor,
                  max_iter: int = MAX_ITER, tol_sq: float = TOL_SQ,
                  omega_inv: torch.Tensor | None = None):
    """Refine rotation 9-vectors [..., 9] by ``max_iter`` masked SQP Newton
    steps on the Schur complement of the trace-regularized KKT system:

        (J W J^T) mu = J W rhs1 + h,  dr = W (rhs1 - J^T mu),
        W = (omega + eps I)^-1,  rhs1 = -omega r.

    A converged (|dr|^2 < tol_sq) or non-finite step freezes the iterate.
    Returns (r, energy r^T omega r)."""
    if omega_inv is None:
        omega_inv = regularized_omega_inv(omega)
    r = r0
    done = torch.zeros(r0.shape[:-1], dtype=torch.bool, device=r0.device)

    def mv(m, v):
        return (m @ v[..., None])[..., 0]

    for _ in range(max_iter):
        h, jac = constraints_and_jacobian(r)
        rhs1 = -mv(omega, r)
        b = jac @ omega_inv  # [..., 6, 9]
        schur = b @ jac.transpose(-1, -2)
        mu = spd_solve(schur, mv(b, rhs1) + h)
        delta = mv(omega_inv, rhs1 - mv(jac.transpose(-1, -2), mu))
        finite = torch.isfinite(delta).all(dim=-1)
        step_ok = finite & ~done
        r = torch.where(step_ok[..., None], r + delta, r)
        converged = _dot(delta, delta) < tol_sq
        done = done | ~finite | (step_ok & converged)
    return r, _dot(r, mv(omega, r))


def solve_candidates(omega, fwd_in_cam, gyro_cos, gyro_sin, sign_change_error,
                     max_iter: int = MAX_ITER, n_eigvecs: int = 4):
    """The 2 * n_eigvecs rotation candidates per frame: the smallest
    eigenvectors of omega x {-1, +1}, projected to SO(3), Newton-refined,
    with the gyro heading penalty ``sign_change_error * max(0, 1 - cos)``.
    omega [B, 9, 9], fwd_in_cam [B, 3], gyro_cos/sin [B]. Returns
    (r_vecs [B, 2k, 9], penalized energy [B, 2k], pure energy [B, 2k])."""
    omega_inv = regularized_omega_inv(omega)
    base = smallest_eigvecs(omega, omega_inv, k=n_eigvecs).transpose(-1, -2)
    guesses = torch.stack([-base, base], dim=-2).reshape(
        *base.shape[:-2], 2 * n_eigvecs, 9)  # each eigenvector x {-1, +1}
    r_start = nearest_so3(guesses)
    r, energy = newton_refine(r_start, omega[..., None, :, :],
                              max_iter=max_iter,
                              omega_inv=omega_inv[..., None, :, :])
    d = fwd_in_cam[..., None, :]
    fwd_x = r[..., 0] * d[..., 0] + r[..., 1] * d[..., 1] + r[..., 2] * d[..., 2]
    fwd_y = r[..., 3] * d[..., 0] + r[..., 4] * d[..., 1] + r[..., 5] * d[..., 2]
    dot = fwd_x * gyro_cos[..., None] + fwd_y * gyro_sin[..., None]
    angle_error = torch.clamp(1.0 - dot, min=0.0)
    return r, energy + sign_change_error * angle_error, energy


def solve_sqpnp(points_3d, points_2d, mask, fwd_in_cam, gyro_cos, gyro_sin,
                sign_change_error, max_iter: int = MAX_ITER,
                plaus_fn=None) -> SqPnPResult:
    """Batched SQPnP with fixed-capacity masked points [B, N, 3]: centroid
    shift, omega, candidates, cheirality filter, best penalized energy
    (re-ranked by ``plaus_fn(r_mats, t_all)`` inside the energy
    resolution band when given), translation t = t_local - R c."""
    dtype = points_3d.dtype
    finite = (torch.isfinite(points_3d).all(dim=-1)
              & torch.isfinite(points_2d).all(dim=-1))
    mask = mask & finite
    safe_ray = torch.zeros_like(points_2d)
    safe_ray[..., 2] = 1.0
    points_3d = torch.where(mask[..., None], points_3d, 0.0)
    points_2d = torch.where(mask[..., None], points_2d, safe_ray)

    n = mask.sum(dim=-1)
    enough = n >= 3
    mf = mask.to(dtype)[..., None]
    centroid = ((points_3d * mf).sum(dim=-2)
                / torch.clamp(n.to(dtype), min=1.0)[..., None])
    centered = (points_3d - centroid[..., None, :]) * mf
    omega, q_tt_inv, q_rt = build_linear_system(centered, points_2d, mask)
    r_vecs, penalized, pure = solve_candidates(
        omega, fwd_in_cam, gyro_cos, gyro_sin, sign_change_error,
        max_iter=max_iter)

    # per candidate: t_local = -Q_tt^-1 Q_rt^T r; t = t_local - R c
    t_local = -(q_tt_inv[..., None, :, :]
                @ (q_rt.transpose(-1, -2)[..., None, :, :] @ r_vecs[..., None]))
    r_mats = r_vecs.reshape(*r_vecs.shape[:-1], 3, 3).transpose(-1, -2)
    t_all = (t_local - r_mats @ centroid[..., None, :, None])[..., 0]

    p_cam_z = (torch.einsum("...cj,...nj->...cn", r_mats[..., 2, :], points_3d)
               + t_all[..., :, None, 2])  # [B, C, N]
    in_front = ((p_cam_z > 0.0) | ~mask[..., None, :]).all(dim=-1)
    score = torch.where(in_front, penalized, torch.full_like(penalized, math.inf))
    if plaus_fn is None:
        best = _argmin(score)
    else:
        tr = torch.diagonal(omega, dim1=-2, dim2=-1).sum(dim=-1)
        eps = 1e-4 * torch.clamp(tr / 9.0, min=1e-12)
        tied = score <= score.amin(dim=-1, keepdim=True) + 3.0 * eps[..., None]
        plaus = plaus_fn(r_mats, t_all)
        best = _argmin(torch.where(tied, plaus, torch.full_like(plaus, math.inf)))
    return SqPnPResult(
        rotation=_take(r_mats, best),
        translation=_take(t_all, best),
        energy=_take(pure, best),
        valid=torch.isfinite(_take(score, best)) & enough,
    )
