"""Tensor-product fast-diagonalization direct solver / preconditioner.

Counterpart of `feast_tpu/ops/fastdiag.py`.  For separable 2-D pencils the
shifted operator S(z) = A - z B diagonalizes in a Kronecker product of two
1-D eigenbases, so S(z)^{-1} applies as four dense transforms plus one
elementwise complex divide at any shift: no Krylov iteration, no
multigrid.  The JAX package measured SA-AMG stalling on deep interior
slices of dense-spectrum operators, where a direct method is required.

Two separable forms (n = n1 * n2, row index i = i1 * n2 + i2):

  form="fem":   A = A1 (x) M2  +  M1 (x) A2,   B = M1 (x) M2
     Per-axis generalized eigenbases A_k W_k = M_k W_k diag(lam_k) with
     W_k^T M_k W_k = I give (W1 (x) W2)^T S(z) (W1 (x) W2) = lam1 (+) lam2 - z I.

  form="kron":  A = A1 (x) I   +  I (x) A2,    B = B1 (x) B2
     with [A_k, B_k] = 0 (commuting pairs, e.g. tridiagonal Toeplitz
     stiffness and mass sharing the sine basis).  The orthogonal
     eigenbases S_k of A_k diagonalize B_k too; `build` checks the
     commutation numerically and refuses otherwise.

Both reduce to transform bases and diagonal grids (dA, dB) with S(z)
diagonal dA - z dB.  The grids are stored and shifted in float64 (on
interior slices the denominator cancels to about |r| << |dA|, which an
fp32 subtraction would resolve only to about 1e-3 relative); the
transforms run in the `dtype` given (float32 by default: as a
preconditioner inside the complex128 Krylov refinement, an apply accurate
to about 1e-6 contracts the residual by as much per outer iteration).

Layout: the JAX package transposes to (n1, m, n2) so that the TPU's
128-lane minor dimension is n2, not m.  The card has no such padding, so
the port keeps X as (..., n1, n2, m) and runs each transform as one real
(batched, on axis 1) GEMM on the complex block through
`torch.view_as_real`: the bases are real, so S^T (X_re + i X_im) is S^T
applied to the interleaved (re, im) planes at once.  These transforms are plain matrix products in the JAX package too
(no Pallas kernel), so `torch.matmul` is their port.

Usage with the sparse driver:

    fd = fastdiag.build(A1=T1, B1=M1, form="kron")
    feast_iterative(K, B, X0, ..., precondition=fastdiag.preconditioner(fd),
                    solver="bicgstab_rr")
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import cx


class FastDiag(NamedTuple):
    """Separable diagonalization of (A, B): device tensors."""

    S1: torch.Tensor   # (n1, n1) axis-0 basis; forward transform = S1^T @ .
    S2: torch.Tensor   # (n2, n2) axis-1 basis
    dA: torch.Tensor   # (n1, n2) float64 diagonal of A in the tensor basis
    dB: torch.Tensor   # (n1, n2) float64 diagonal of B in the tensor basis


def _dense(M):
    return np.asarray(M.todense() if hasattr(M, "todense") else M, dtype=float)


def _eigh_host(A, M=None):
    import scipy.linalg as sla

    return sla.eigh(_dense(A), None if M is None else _dense(M))


def build(A1, A2=None, B1=None, B2=None, *, form: str = "kron",
          dtype=torch.float32, commute_tol: float = 1e-10,
          device="cuda") -> FastDiag:
    """Host-side build (one small dense scipy eigh per axis).

    A2 defaults to A1.  B2 defaults to B1 only when A2 is A1 (the symmetric
    grid); B2 = None with a distinct A2 means the identity on axis 1, as
    does B1 = None on axis 0 (the JAX package's rule, kept).  `dtype` is
    the real transform dtype; the grids are always float64."""
    from .._device import resolve_device

    dev = resolve_device(device)
    if A2 is None:
        A2 = A1
    if B2 is None and B1 is not None and A2 is A1:
        B2 = B1
    axes = []
    for Ak, Mk in ((A1, B1), (A2, B2)):
        if form == "fem":
            lam, W = _eigh_host(Ak, Mk)       # W^T Mk W = I, W^T Ak W = lam
            axes.append((W, lam, np.ones_like(lam)))
        elif form == "kron":
            lam, S = _eigh_host(Ak)           # orthogonal S
            if Mk is None:
                m = np.ones_like(lam)
            else:
                G = S.T @ _dense(Mk) @ S
                m = np.diag(G).copy()
                rel = np.abs(G - np.diag(m)).max() / max(np.abs(m).max(), 1e-300)
                if rel > commute_tol:
                    raise ValueError(
                        f"form='kron' needs commuting (A_k, B_k): "
                        f"off-diagonal of S^T B S is {rel:.2e} relative "
                        f"(tol {commute_tol:g}); use form='fem' for "
                        f"A = A1(x)M2 + M1(x)A2 pencils")
            axes.append((S, lam, m))
        else:
            raise ValueError(f"unknown form {form!r} (use 'fem' or 'kron')")
    (S1, t1, m1), (S2, t2, m2) = axes

    def put(x, dt):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dt, device=dev)

    return FastDiag(put(S1, dtype), put(S2, dtype),
                    put(t1[:, None] + t2[None, :], torch.float64),
                    put(m1[:, None] * m2[None, :], torch.float64))


def solve(fd: FastDiag, z, X: torch.Tensor) -> torch.Tensor:
    """(A - z B)^{-1} X through the tensor diagonalization.

    X is (..., n, m) complex with n = n1 n2; z a scalar, or a tensor whose
    shape is X's leading dims (one shift per node of a node batch)."""
    n1, n2 = fd.dA.shape
    m = X.shape[-1]
    lead = X.shape[:-2]
    tdt = fd.S1.dtype

    def planes(Y):   # (..., n1, n2, m) complex -> (..., n1, n2, 2 m) real
        return torch.view_as_real(Y).reshape(Y.shape[:-1] + (2 * m,))

    def cplx(P):     # the inverse of planes
        return torch.view_as_complex(P.reshape(P.shape[:-1] + (m, 2)).contiguous())

    Y = planes(X.to(cx.complex_dtype(tdt)).reshape(lead + (n1, n2, m)))
    # forward: (S1^T (x) S2^T) X, one GEMM per axis on the planes
    Y = torch.matmul(fd.S1.T, Y.reshape(lead + (n1, n2 * 2 * m)))
    Y = torch.matmul(fd.S2.T, Y.reshape(lead + (n1, n2, 2 * m)))
    # the diagonal divide: denominator in float64, its reciprocal applied
    # in the transform dtype
    zt = torch.as_tensor(z, dtype=torch.complex128, device=fd.dA.device)
    zt = zt.reshape(zt.shape + (1, 1))
    rec = cx.creciprocal(fd.dA - zt * fd.dB).to(cx.complex_dtype(tdt))
    Y = planes(cplx(Y) * rec[..., None])
    # backward: (S1 (x) S2) Y
    Y = torch.matmul(fd.S2, Y)
    Y = torch.matmul(fd.S1, Y.reshape(lead + (n1, n2 * 2 * m)))
    return cplx(Y.reshape(lead + (n1, n2, 2 * m))).reshape(lead + (n1 * n2, m)).to(X.dtype)


def preconditioner(fd: FastDiag):
    """`precondition=` callable for feast_iterative: z -> (X -> S(z)^{-1} X),
    z the (chunk,) shifts of a node chunk and X (chunk, n, m)."""
    def make(z):
        def M(X: torch.Tensor) -> torch.Tensor:
            return solve(fd, z, X)
        return M
    return make
