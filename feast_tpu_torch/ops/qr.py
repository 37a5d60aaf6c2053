"""Tall-skinny orthonormalization: shifted CholeskyQR2/3 with the small
Cholesky factor and triangular solves.

Counterpart of `feast_tpu/ops/qr.py` on native complex tensors, with the
same guards: a relative pivot floor and the phase-preserving clamp of the
Cholesky columns (a rank-deficient Gram stays finite), eps^2 substitution
of zero diagonals in the triangular solves, and the max-abs column
pre-scaling of `colscale_unit`; and Householder QR for subspaces whose
Gram CholeskyQR cannot factor.

`psum_axis` (the JAX spelling): A is this rank's row block of a taller
matrix, and the Gram, the column max-abs and the squared column norms are
reduced over that dimension of the mesh bound by
`parallel.mesh.bind_mesh` (the TSQR pattern).  None: an unsharded A.
"""

from __future__ import annotations

import torch

from .. import cx


def cholesky(G: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor L of a Hermitian positive (semi)definite G,
    over leading batch dims (each matrix its own floor and cap).

    A breakdown pivot (not finite or below eps^2 * max(max|diag|, 1)) gets
    diagonal sqrt(floor) and zeros below it; other entries are clamped to
    2 sqrt(g0) in magnitude."""
    m = G.shape[-1]
    G = G.clone()
    rows = torch.arange(m, device=G.device)
    eps = torch.finfo(cx.real_dtype(G.dtype)).eps
    g0 = torch.clamp(torch.amax(torch.abs(torch.diagonal(G, dim1=-2, dim2=-1).real),
                                dim=-1), min=1.0)[..., None]
    floor = eps * eps * g0
    cap = 2.0 * torch.sqrt(g0)
    for k in range(m):
        dkk = G[..., k, k, None].real
        deficient = ~(torch.isfinite(dkk) & (dkk > floor))
        d = torch.sqrt(torch.where(deficient, floor, dkk))
        col = G[..., :, k]
        below, at_k, at_or_below = rows > k, rows == k, rows >= k
        cre = torch.where(below & deficient, 0.0,
                          torch.where(at_k & deficient, d * d, col.real))
        cim = torch.where(at_or_below & deficient, 0.0, col.imag)
        col = torch.complex(cre, cim)
        newcol = torch.where(at_or_below, col / d, col)
        mag = cx.cabs(newcol)
        scale_dn = torch.where(mag > cap, cap / torch.where(mag > cap, mag, 1.0), 1.0)
        newcol = torch.where(below, newcol * scale_dn, newcol)
        G[..., :, k] = newcol
        lk = torch.where(below, newcol, 0.0)
        G -= lk[..., :, None] * lk.conj()[..., None, :]
    return torch.tril(G)


def solve_lower(L: torch.Tensor, B: torch.Tensor, unit: bool = False) -> torch.Tensor:
    """Solve L X = B, L (..., m, m) lower triangular, B (..., m, k)."""
    m = L.shape[-1]
    X = B.clone()
    eps = torch.finfo(cx.real_dtype(L.dtype)).eps
    for i in range(m):
        rhs = X[..., i, :] - (L[..., i, None, :i] @ X[..., :i, :])[..., 0, :]
        if not unit:
            d = L[..., i, i, None]
            d = torch.where(cx.abs2(d) > 0, d, torch.full_like(d, eps * eps))
            rhs = cx.cdiv(rhs, d)
        X[..., i, :] = rhs
    return X


def solve_upper(U: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve U X = B, U (m, m) upper triangular, B (m, k)."""
    m = U.shape[-1]
    X = B.clone()
    eps = torch.finfo(cx.real_dtype(U.dtype)).eps
    for i in range(m - 1, -1, -1):
        rhs = X[i] - U[i, i + 1:] @ X[i + 1:]
        d = U[i, i]
        d = torch.where(cx.abs2(d) > 0, d, torch.full_like(d, eps * eps))
        X[i] = cx.cdiv(rhs, d)
    return X


def right_solve_upper(A: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """A R^{-1} (A (..., n, m), R (..., m, m) upper) via R^H Y = A^H."""
    return solve_lower(R.mH, A.mH).mH.resolve_conj()


def _trace(G: torch.Tensor) -> torch.Tensor:
    """The trace of each matrix of (..., m, m), each by torch.trace: a
    batch's shifts round as its matrices' alone (a sum over the diagonal
    adds in another order)."""
    if G.dim() == 2:
        return torch.trace(G)
    return torch.stack([torch.trace(g) for g in G.reshape((-1,) + G.shape[-2:])]
                       ).reshape(G.shape[:-2])


def _psum(x: torch.Tensor, psum_axis) -> torch.Tensor:
    if psum_axis is None:
        return x
    from ..parallel import mesh as pmesh

    return pmesh.psum(x, psum_axis)


def cholqr(A: torch.Tensor, shift: bool = True, psum_axis=None):
    """One (shifted) CholeskyQR pass: (Q, R) with A = Q R.

    psum_axis: A is a row block, its Gram summed over that mesh dimension;
    the shift then uses the block's own row count, as the JAX package's
    does.  A may carry leading batch dims, each matrix shifted by its own
    trace."""
    n, m = A.shape[-2:]
    G = _psum(cx.cgram(A), psum_axis)
    if shift:
        eps = torch.finfo(cx.real_dtype(A.dtype)).eps
        # shifted CholeskyQR (Fukaya et al. 2020)
        s = 11.0 * (m * n + n * (n + 1)) * eps * _trace(G.real) / m
        G = G + s[..., None, None] * torch.eye(m, dtype=G.dtype, device=G.device)
    R = cholesky(G).mH.resolve_conj()
    return right_solve_upper(A, R), R


def cholqr2(A: torch.Tensor, psum_axis=None):
    """Shifted CholeskyQR2."""
    Q1, R1 = cholqr(A, shift=True, psum_axis=psum_axis)
    Q2, R2 = cholqr(Q1, shift=False, psum_axis=psum_axis)
    return Q2, R2 @ R1


def cholqr3(A: torch.Tensor, psum_axis=None):
    """Shifted CholeskyQR3."""
    Q1, R1 = cholqr(A, shift=True, psum_axis=psum_axis)
    Q2, R2 = cholqr(Q1, shift=True, psum_axis=psum_axis)
    Q3, R3 = cholqr(Q2, shift=False, psum_axis=psum_axis)
    return Q3, R3 @ (R2 @ R1)


def _reflector_beta(v: torch.Tensor) -> torch.Tensor:
    """2 / ||v||^2, and 0 for a vector below eps in norm (no reflection)."""
    eps = torch.finfo(cx.real_dtype(v.dtype)).eps
    vnorm2 = torch.sum(cx.abs2(v))
    return torch.where(vnorm2 > eps * eps,
                       2.0 / torch.where(vnorm2 > 0, vnorm2, 1.0), 0.0)


def householder_qr(A: torch.Tensor):
    """Thin Householder QR of (n, m), n >= m: returns (Q (n, m), R (m, m)).

    m reflections in order, each a rank-1 update of the whole matrix; the
    thin Q is formed by applying them backwards to the first m columns of
    the identity."""
    n, m = A.shape
    A = A.clone()
    V = torch.zeros_like(A)
    rows = torch.arange(n, device=A.device)
    for k in range(m):
        x = torch.where(rows >= k, A[:, k], 0.0)
        normx = torch.sqrt(torch.sum(cx.abs2(x)))
        v = x.clone()
        v[k] = v[k] + cx.phase(x[k]) * normx
        beta = _reflector_beta(v)
        A -= beta * torch.outer(v, v.conj() @ A)
        V[:, k] = v
    R = torch.triu(A[:m])
    Q = torch.eye(n, m, dtype=A.dtype, device=A.device)
    for k in range(m - 1, -1, -1):
        v = V[:, k]
        Q -= _reflector_beta(v) * torch.outer(v, v.conj() @ Q)
    return Q, R


def colscale_unit(A: torch.Tensor, psum_axis=None) -> torch.Tensor:
    """Scale columns to unit 2-norm with a max-abs pre-scale, so columns
    with tiny entries do not underflow the squared-norm sum.  (..., n, m).
    psum_axis: A is a row block; the max-abs is the max and the squared
    norm the sum over that mesh dimension, so each block is scaled as the
    whole matrix would be."""
    tiny = torch.finfo(cx.real_dtype(A.dtype)).tiny
    amax = torch.amax(torch.maximum(A.real.abs(), A.imag.abs()), dim=-2, keepdim=True)
    if psum_axis is not None:
        from ..parallel import mesh as pmesh

        amax = pmesh.pmax(amax, psum_axis)
    As = A * (1.0 / torch.where(amax > tiny, amax, 1.0))
    nrm = torch.sqrt(_psum(torch.sum(cx.abs2(As), dim=-2, keepdim=True), psum_axis))
    return As * (1.0 / torch.where(nrm > tiny, nrm, 1.0))


def orthonormalize(A: torch.Tensor, method: str = "cholqr2", psum_axis=None) -> torch.Tensor:
    """Orthonormal basis of range(A) after `colscale_unit`; A (..., n, m)
    with "cholqr2" / "cholqr3".  psum_axis: A is a row block (see the
    module docstring); "householder" has no row-reduced form and raises
    with one."""
    if method == "householder" and psum_axis is not None:
        raise ValueError("householder QR has no row-reduced form (psum_axis)")
    A = colscale_unit(A, psum_axis)
    if method == "cholqr2":
        return cholqr2(A, psum_axis)[0]
    if method == "cholqr3":
        return cholqr3(A, psum_axis)[0]
    if method == "householder":
        return householder_qr(A)[0]
    raise ValueError(f"unknown method {method}")
