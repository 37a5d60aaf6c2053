"""Complex QZ: generalized Schur decomposition of a pencil (A, B).

Counterpart of `feast_tpu/ops/qz.py`, the general-pencil path behind
`companion(method="qz")` and `gen_feast(pencil="qz")`: where `eig.gen_eig`
reduces through B^{-1} A, this handles a singular or ill-conditioned B
and infinite eigenvalues.

  1. B = Q R (Householder); A <- Q^H A, so B is triangular;
  2. Hessenberg-triangular reduction by Givens rotations: row pairs zero
     A below its subdiagonal, column pairs restore B's triangularity;
  3. single-shift implicit QZ sweeps, the bulge chased from the top of
     the unreduced block holding the active bottom row; deflation when
     |H[i+1, i]| <= eps max(|H[i, i]| + |H[i+1, i+1]|, ||H||_F);
  4. eigenvalues as (alpha, beta) = (diag S, diag T): beta ~ 0 marks an
     infinite eigenvalue instead of overflowing;
  5. right eigenvectors by back-substitution on beta_i S - alpha_i T, and
     a two-sided Rayleigh-quotient refinement of (alpha, beta).

Each rotation touches two rows or two columns; the loops are Python loops
over the active window, as the JAX package's masked fori/while loops.
"""

from __future__ import annotations

import math

import torch

from .. import cx
from .eig import _givens


def _lrot(M: torch.Tensor, i: int, c, s) -> None:
    """Left Givens on rows (i, i+1) by [c, s; -conj(s), c], in place."""
    top, bot = M[i].clone(), M[i + 1].clone()
    M[i] = top * c + s * bot
    M[i + 1] = bot * c - s.conj() * top


def _rrot(M: torch.Tensor, j: int, c, s) -> None:
    """Right Givens on columns (j, j+1) by [c, s; -conj(s), c]^H, in place."""
    left, right = M[:, j].clone(), M[:, j + 1].clone()
    M[:, j] = left * c + s.conj() * right
    M[:, j + 1] = right * c - s * left


def _givens_zero_first(a: torch.Tensor, b: torch.Tensor):
    """(c, s) for `_rrot` that maps a row pair [a, b] to [0, r]: kills T's
    subdiagonal fill with a column rotation (b the diagonal entry)."""
    na2, nb2 = cx.abs2(a), cx.abs2(b)
    r2 = na2 + nb2
    a_zero = na2 == 0
    r = torch.sqrt(torch.where(r2 > 0, r2, 1.0))
    c = torch.where(a_zero, 1.0, torch.sqrt(nb2) / r)
    s = cx.phase(b) * a.conj()
    s = torch.where(a_zero, torch.zeros_like(s), -s / r)
    return c, s


def _kill_fill(H, T, Z, i: int) -> None:
    """Zero T[i+1, i] by a column rotation of (H, T, Z) on columns i, i+1."""
    cr, sr = _givens_zero_first(T[i + 1, i], T[i + 1, i + 1])
    for M in (T, H, Z):
        _rrot(M, i, cr, sr)


def hessenberg_triangular(A: torch.Tensor, B: torch.Tensor):
    """(H upper Hessenberg, T upper triangular, Q, Z) with H = Q^H A Z and
    T = Q^H B Z."""
    from . import qr as qrmod

    n = A.shape[0]
    Q, T = qrmod.householder_qr(B)
    H = Q.mH @ A
    T = T.clone()
    Z = torch.eye(n, dtype=A.dtype, device=A.device)
    for j in range(n - 2):
        for i in range(n - 2, j, -1):          # rows (i, i+1), bottom up
            c, s = _givens(H[i, j], H[i + 1, j])
            _lrot(H, i, c, s)
            _lrot(T, i, c, s)
            _rrot(Q, i, c, s)                  # Q <- Q G^H
            _kill_fill(H, T, Z, i)
    return H, T, Q, Z


def _trailing_shift(H, T, k: int, stagnation: int):
    """Eigenvalue of the trailing active 2x2 of T^{-1} H closest to its
    bottom-right entry; the exceptional shift every 10 stalled sweeps."""
    h11, h12, h21, h22 = H[k - 1, k - 1], H[k - 1, k], H[k, k - 1], H[k, k]
    t11, t12, t22 = T[k - 1, k - 1], T[k - 1, k], T[k, k]
    eps = torch.finfo(cx.real_dtype(H.dtype)).eps

    def guard(t):                               # a near-infinite eigenvalue
        return torch.where(cx.abs2(t) > eps * eps, t, torch.full_like(t, eps))

    it11 = cx.creciprocal(guard(t11))
    it22 = cx.creciprocal(guard(t22))
    it12 = t12 * it11 * it22
    m11 = h11 * it11
    m12 = h12 * it22 - h11 * it12
    m21 = h21 * it11
    m22 = h22 * it22 - h21 * it12
    if stagnation > 0 and stagnation % 10 == 0:
        return torch.complex(m22.real + 0.75 * cx.cabs(m21), m22.imag)
    delta = (m11 - m22) * 0.5
    bg = m12 * m21
    t_ = cx.csqrt(delta * delta + bg)
    den1, den2 = delta + t_, delta - t_
    den = torch.where(cx.abs2(den1) >= cx.abs2(den2), den1, den2)
    small = cx.abs2(den) <= 0.0
    quot = cx.cdiv(bg, torch.where(small, torch.ones_like(den), den))
    return m22 - torch.where(small, torch.zeros_like(quot), quot)


def _qz_sweep(H, T, Q, Z, lo: int, k: int, sigma) -> None:
    """One implicit single-shift QZ sweep on rows lo..k, in place.  `lo` is
    the top of the unreduced block holding row k: a bulge cannot cross a
    zero subdiagonal, so the chase starts there."""
    for i in range(lo, k):
        if i == lo:
            x, y = H[lo, lo] - sigma * T[lo, lo], H[lo + 1, lo]
        else:
            x, y = H[i, i - 1], H[i + 1, i - 1]
        c, s = _givens(x, y)
        _lrot(H, i, c, s)
        _lrot(T, i, c, s)
        _rrot(Q, i, c, s)
        _kill_fill(H, T, Z, i)


def qz(A: torch.Tensor, B: torch.Tensor, max_sweeps_per_eig: int = 30):
    """Complex generalized Schur form A = Q S Z^H, B = Q T Z^H with S, T
    upper triangular; returns (S, T, Q, Z)."""
    n = A.shape[0]
    if n == 1:
        eye = torch.ones_like(A)
        return A.clone(), B.clone(), eye, eye.clone()
    H, T, Q, Z = hessenberg_triangular(A, B)
    eps = torch.finfo(cx.real_dtype(H.dtype)).eps
    fnorm = cx.fro_norm(H)
    sub_r = torch.arange(1, n, device=A.device)
    sub_c = torch.arange(n - 1, device=A.device)

    def deflate():
        # LAPACK zhgeqz style: the tolerance floored at eps ||H||_F, since
        # H's diagonal (the alpha values) can be far below ||H||
        dabs = cx.cabs(torch.diagonal(H))
        tol = eps * torch.maximum(dabs[:-1] + dabs[1:],
                                  torch.where(fnorm > 0, fnorm, 1.0))
        sub = H[sub_r, sub_c]
        conv = cx.cabs(sub) <= tol
        H[sub_r, sub_c] = torch.where(conv, torch.zeros_like(sub), sub)
        flags = (~conv).cpu()
        nz = torch.nonzero(flags)
        return int(nz[-1]) + 1 if len(nz) else 0, flags

    k, flags = deflate()
    it = stag = 0
    while k > 0 and it < max_sweeps_per_eig * n:
        # first exactly zero subdiagonal above k (deflate zeroes converged ones)
        zero_above = torch.nonzero(~flags[:k])
        lo = int(zero_above[-1]) + 1 if len(zero_above) else 0
        sigma = _trailing_shift(H, T, k, stag)
        _qz_sweep(H, T, Q, Z, lo, k, sigma)
        k_new, flags = deflate()
        stag = 0 if k_new < k else stag + 1
        k = k_new
        it += 1
    return torch.triu(H), torch.triu(T), Q, Z


def _triangular_pencil_solve(S, T, forward: bool):
    """Columns i of the solution of the triangular pencil systems
    (beta_i S - alpha_i T) y_i = 0, y_i[i] = 1: back-substitution over rows
    for the right vectors (forward=False) or forward substitution over
    columns for the conjugated left ones (forward=True).  A denominator
    below eps max(||S||_F + ||T||_F, 1) is replaced by that floor."""
    n = S.shape[0]
    alpha, beta = torch.diagonal(S), torch.diagonal(T)
    eps = torch.finfo(cx.real_dtype(S.dtype)).eps
    smln = eps * torch.clamp(cx.fro_norm(S) + cx.fro_norm(T), min=1.0)
    Y = torch.eye(n, dtype=S.dtype, device=S.device)
    idx = torch.arange(n, device=S.device)
    order = range(1, n) if forward else range(n - 2, -1, -1)
    for j in order:
        mask = (idx < j) if forward else (idx > j)
        if forward:
            numS = (S[:, j] * mask) @ Y
            numT = (T[:, j] * mask) @ Y
        else:
            numS = (S[j] * mask) @ Y
            numT = (T[j] * mask) @ Y
        num = beta * numS - alpha * numT
        den = beta * S[j, j] - alpha * T[j, j]
        den = torch.where(cx.cabs(den) < smln, smln.to(den.dtype), den)
        Y[j] = torch.where(mask, cx.cdiv(-num, den), Y[j])
    return Y


def pencil_eigvecs(S: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Right eigenvectors of the triangular pencil (S, T) by back-substitution
    on beta_i S - alpha_i T (no division by beta: infinite eigenvalues
    degrade gracefully)."""
    return _triangular_pencil_solve(S, T, forward=False)


def pencil_left_nullvecs(S: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Conjugated left null vectors of the triangular pencil (S, T): column
    i, h_i[i] = 1 with support on rows [i, n), solves
    (beta_i S[j, j] - alpha_i T[j, j]) h[j] = -sum_{l<j} (beta_i S[l, j]
    - alpha_i T[l, j]) h[l].  Then Q conj(h_i) is a left eigenvector of
    (A, B) = (Q S Z^H, Q T Z^H)."""
    return _triangular_pencil_solve(S, T, forward=True)


def gen_eig_qz(A: torch.Tensor, B: torch.Tensor, refine_rq: bool = True,
               kappa_max: float = 1e4):
    """Generalized eigenpairs by QZ: (alpha, beta, V) with
    A V diag(beta) = B V diag(alpha); lam = alpha / beta, beta ~ 0 for an
    infinite eigenvalue.

    refine_rq replaces each pair by the two-sided Rayleigh quotient
    (u^H A v, u^H B v), division-free, unless the pair's condition number
    exceeds kappa_max."""
    S, T, Q, Z = qz(A, B)
    alpha, beta = torch.diagonal(S), torch.diagonal(T)
    V = Z @ pencil_eigvecs(S, T)
    if refine_rq:
        U = Q @ pencil_left_nullvecs(S, T).conj()
        num = cx.cdot_cols(U, A @ V)
        den = cx.cdot_cols(U, B @ V)
        mag = torch.sqrt(cx.abs2(num) + cx.abs2(den))
        scale = (cx.fro_norm(A) + cx.fro_norm(B)) / math.sqrt(A.shape[0])
        safe = mag > 0
        kappa = (cx.col_norms(U) * cx.col_norms(V) * scale
                 / torch.where(safe, mag, 1.0))
        use = safe & (kappa < kappa_max)
        alpha = torch.where(use, num, alpha)
        beta = torch.where(use, den, beta)
    return alpha, beta, cx.normalize_cols(V)
