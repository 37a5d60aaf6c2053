"""Single-shot contour solvers: Beyn's method and block Sakurai-Sugiura.

Counterpart of `feast_tpu/solvers/beyn.py`: one batched factorization over
the node axis (in chunks), the moment sums, then Beyn's SVD extraction, or
for block SS the left-projected block-Hankel pencils of 2K + 1 moments
with the rank cut sigma / sigma_1 > rank_tol realized with static shapes
(the directions below the cut deflated to far-away eigenvalues, which the
caller filters out by contour membership or residual).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import contour as ct
from .. import cx
from .. import nep as nepmod
from .._device import as_tensor
from ..ops import eig as eigmod
from ..ops import lu as lumod
from ..ops import qr as qrmod
from ..ops import svd as svdmod
from .nlfeast import (C128, _factor_all, _residuals, _scaled,
                      _setup, _unscale, _zeta_powers, beyn_svd_extract)


class BeynResult(NamedTuple):
    lam: torch.Tensor
    X: torch.Tensor
    res: torch.Tensor

    def sorted_numpy(self):
        """Host numpy (lam, X, res) sorted by residual."""
        lam, X, res = (t.cpu().numpy() for t in self)
        p = np.argsort(res)
        return lam[p], X[:, p], res[p]


def _moment_blocks(T, X, z, zeta, w, count: int):
    """sum_i w_i zeta_i^p T(z_i)^{-1} X for p = 0 .. count-1: (count, n, m)."""
    S = None
    for ch in _factor_all(T, z, False):
        t = lumod.lu_solve(ch.LU, ch.perm, X, dinv=ch.dinv) * w[ch.sl][:, None, None]
        part = _zeta_powers(t, zeta[ch.sl], count).sum(1)
        S = part if S is None else S + part
    return S


def beyn(T, X0, nodes: int = 16, *, c: complex = 0.0 + 0.0j, r: float = 1.0,
         contour: Optional[ct.Contour] = None, relative_res: bool = False,
         device="cuda") -> BeynResult:
    """Beyn's single-shot contour method: the moments Q0 = sum w_i
    T(z_i)^{-1} X and Q1 (centered-scaled first moment), then the SVD
    extraction.  Residuals are absolute column norms ||T(lam) x|| unless
    relative_res."""
    T, X, contour, z, w = _setup(T, X0, contour, c, r, nodes, device)
    zeta, scale = _scaled(contour, z)
    S = _moment_blocks(T, X, z, zeta, w, 2)
    mu, X = beyn_svd_extract(S[0], S[1])
    lam = _unscale(mu, scale)
    X = cx.normalize_cols(X)
    if isinstance(T, nepmod.CallableNEP):
        lamh, Xh = lam.cpu().numpy(), X.cpu().numpy()
        res = np.linalg.norm(T.host_apply_cols(Xh, lamh), axis=0)
        if relative_res:
            res = res / T.host_fro_norms(lamh)
        return BeynResult(lam, X, torch.as_tensor(res))
    res = cx.col_norms(T.apply_cols(X, lam))
    if relative_res:
        res = res / torch.clamp(T.fro_norms(lam), min=torch.finfo(res.dtype).tiny)
    return BeynResult(lam, X, res)


def _deflated_pencil(Q0, Q1, rank_tol: float, far: float):
    """(H1, H0, V) of the rank-cut Hankel pencil: U^H Q V of the SVD of Q0,
    the directions below the cut with a unit diagonal in H0 and `far` in
    H1."""
    U, s, Vh = svdmod.svd(Q0)
    keep = s / torch.clamp(s[0], min=torch.finfo(s.dtype).tiny) > rank_tol
    V = Vh.mH
    H1 = U.mH @ (Q1 @ V)
    H0 = U.mH @ (Q0 @ V)
    dmask = keep.to(s.dtype)
    omask = dmask[:, None] * dmask[None, :]
    eye = torch.eye(H0.shape[0], dtype=s.dtype, device=H0.device)
    H0 = torch.complex(H0.real * omask + (1.0 - dmask) * eye, H0.imag * omask)
    H1 = torch.complex(H1.real * omask + (1.0 - dmask) * eye * far, H1.imag * omask)
    return H1, H0, V


def block_ss(T, X0, nodes: int = 16, moments: int = 2, *,
             c: complex = 0.0 + 0.0j, r: float = 1.0,
             contour: Optional[ct.Contour] = None, rank_tol: float = 1e-13,
             seed: int = 0, device="cuda") -> BeynResult:
    """Block Sakurai-Sugiura with higher moments (the reference's
    block_SS!): Hankel pencils of the moments projected on a random probe
    block Y, drawn from np.random.default_rng(seed) as in the JAX package;
    eigenvectors through the first K moment blocks."""
    T, X, contour, z, w = _setup(T, X0, contour, c, r, nodes, device)
    n, m0 = X.shape
    K = int(moments)
    if isinstance(T, nepmod.CallableNEP):
        raise TypeError("block_ss needs an SPMF/polynomial NEP")
    X, _ = qrmod.cholqr2(X)
    rng = np.random.default_rng(seed)
    Y = as_tensor(rng.standard_normal((n, m0)) + 1j * rng.standard_normal((n, m0)),
                  C128, X.device)
    zeta, scale = _scaled(contour, z)
    S = _moment_blocks(T, X, z, zeta, w, 2 * K + 1)
    proj = [Y.mH @ S[j] for j in range(2 * K + 1)]
    Q0 = torch.cat([torch.cat([proj[i + j + 1] for j in range(K)], dim=1)
                    for i in range(K)])
    Q1 = torch.cat([torch.cat([proj[i + j + 2] for j in range(K)], dim=1)
                    for i in range(K)])
    # far in scaled coordinates: |mu| <= 1 inside the contour
    H1, H0, V = _deflated_pencil(Q0, Q1, rank_tol, far=1e6)
    mu, Xq = eigmod.gen_eig(H1, H0)
    lam = _unscale(mu, scale)
    Sflat = torch.cat([S[j] for j in range(K)], dim=1)
    Xout, _, res = _residuals(T, Sflat @ (V @ Xq), lam)
    return BeynResult(lam, Xout, res)
