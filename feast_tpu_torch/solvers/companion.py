"""Companion linearization for polynomial eigenproblems.

Counterpart of `feast_tpu/solvers/companion.py`: P(lam) x = 0 with
P(z) = sum_j A_j z^(j-1) becomes the N L x N L pencil C1 y = lam C2 y with
y = [x; lam x; ...; lam^(L-1) x]; eigenvectors are read from the last
block row, residuals are relative to ||P(lam)||_F (through the SPMF Gram
tensor).  The exact dense anchor of the nonlinear solvers.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from .. import cx
from .._device import as_tensor, resolve_device
from ..nep import PolynomialNEP
from ..ops import eig as eigmod
from .nlfeast import C128, _residuals


class CompanionResult(NamedTuple):
    lam: torch.Tensor
    X: torch.Tensor
    res: torch.Tensor


def companion(coeffs: Sequence, method: str = "auto", device="cuda") -> CompanionResult:
    """All N L eigenpairs of the polynomial EVP through its companion pencil,
    with relative residuals.

    coeffs: [A_1, ..., A_{L+1}], P(z) = sum_j A_j z^(j-1).
    method: "eig" (alias "lu") reduces through C2^{-1} C1 and needs a
    nonsingular leading coefficient; "qz" runs the full QZ (a singular
    A_{L+1} gives infinite eigenvalues as huge alpha/beta, the ggev
    convention); "auto" takes "qz" when cond(A_{L+1}) > 1/sqrt(eps), as
    the JAX package tests it (a host SVD of the leading coefficient)."""
    dev = resolve_device(device)
    mats = [np.asarray(A, dtype=np.complex128) for A in coeffs]
    N = mats[0].shape[0]
    L = len(mats) - 1
    NL = N * L
    C1 = np.zeros((NL, NL), dtype=np.complex128)
    C2 = np.zeros((NL, NL), dtype=np.complex128)
    C1[:N, :N] = mats[0]
    for i in range(N, NL):
        C1[i, i] = 1.0
        C2[i, i - N] = 1.0
    for i in range(L):
        C2[:N, N * i:N * (i + 1)] = -mats[i + 1]
    if method == "auto":
        s = np.linalg.svd(mats[-1], compute_uv=False)
        cond = s[0] / s[-1] if s[-1] > 0 else np.inf
        method = "qz" if cond > 1.0 / np.sqrt(np.finfo(np.float64).eps) else "eig"
    C1t, C2t = as_tensor(C1, C128, dev), as_tensor(C2, C128, dev)
    if method == "qz":
        from ..ops import qz as qzmod

        alpha, beta, V = qzmod.gen_eig_qz(C1t, C2t)
        lam = cx.cdiv(alpha, beta)
    elif method in ("eig", "lu"):
        lam, V = eigmod.gen_eig(C1t, C2t)
    else:
        raise ValueError(f"unknown method {method!r} (auto|eig|qz)")
    X, _, res = _residuals(PolynomialNEP(mats, dev), V[(L - 1) * N:], lam)
    return CompanionResult(lam, X, res)
