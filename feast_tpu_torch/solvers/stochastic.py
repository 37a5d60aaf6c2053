"""Stochastic contour-based eigenvalue counting.

Counterpart of `feast_tpu/solvers/stochastic.py`: the Hutchinson estimate
of the trace of the spectral projector,

    E[#eig inside] = (1/samples) sum_i Re(w_i tr(X^H (z_i B - A)^{-1} X)),

with real Gaussian probes X from np.random.default_rng(seed).  The node
matrices are factored as one batch; mixed_prec factors and solves in
complex64 (the panel kernel on the card).  It sizes m0 or a spectral
slice before a FEAST run.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import contour as ct
from .._device import as_tensor, resolve_device
from ..ops import lu as lumod

C64, C128 = torch.complex64, torch.complex128


def contour_estimate_eig(A, contour: ct.Contour, B=None, *,
                         samples: Optional[int] = None, seed: int = 0,
                         mixed_prec: bool = False, device="cuda") -> float:
    """Expected number of eigenvalues of (A, B) inside the contour."""
    dev = resolve_device(device)
    A = as_tensor(A, C128, dev)
    n = A.shape[0]
    m0 = samples if samples is not None else min(100, n)
    rng = np.random.default_rng(seed)
    X = as_tensor(rng.standard_normal((n, m0)).astype(np.float64) + 0j, C128, dev)
    z = contour.device_nodes(C128, dev)
    w = contour.device_weights(C128, dev)
    dt = C64 if mixed_prec else C128
    # z B - A (the sign of the reference), formed in complex128 and cast
    S = lumod.factor_buffer(z.shape, n, dt, dev)
    Bm = torch.eye(n, dtype=C128, device=dev) if B is None else as_tensor(B, C128, dev)
    for i in range(z.shape[0]):
        S[i, :n, :n] = z[i] * Bm - A
    del Bm
    LU, perm = lumod.lu_factor_inplace(S, n)
    Xs = X.to(dt)
    temp = lumod.lu_solve(LU, perm, Xs)
    tr = torch.sum(Xs.conj() * temp, dim=(-2, -1)).to(C128)     # tr(X^H temp)
    return float(torch.sum((tr * w).real) / m0)
