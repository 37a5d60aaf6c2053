"""Research variants of the moment NLFEAST family.

Counterpart of `feast_tpu/solvers/nlfeast_experimental.py`:

* `nlfeast_moments_all`: as `nlfeast_moments`, but the RII update refines
  with the whole K m0 Ritz set, accumulated moment-split
  (Q_j += zeta^j U[:, :m0], Q_{j+K} += zeta^{j+K} U[:, :m0]).
* `nlfeast_moments_ss`: Sakurai-Sugiura style left-projected Hankel
  pencils (X^H S blocks at start-up, a fresh random probe from
  np.random.default_rng(seed) every refinement), rank cut
  sigma / sigma_1 > 1e-13, eigenvectors through the first K moment blocks;
  the update is applied to the solve output before accumulation.
* `nlfeast_rr`: X^H-projected Rayleigh-Ritz pencils (X^H Q1, X^H Q0)
  solved by the generalized eigensolver instead of the SVD extraction,
  with a residual-based stop.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import contour as ct
from .. import cx
from .. import nep as nepmod
from .._device import as_tensor
from ..ops import eig as eigmod
from ..ops import lu as lumod
from .beyn import _deflated_pencil
from .feast import _in_mask
from .nlfeast import (C128, NlfeastResult, _dbg, _factor_all,
                      _filter_terms, _hankel, _moment_stack, _residuals,
                      _scaled, _setup, _sorted_by_residual, _stop, _unscale,
                      _zeta_powers, beyn_svd_extract)


def _setup_moments(T, X0, nodes, c, r, contour, device):
    T, X, contour, z, w = _setup(T, X0, contour, c, r, nodes, device)
    if isinstance(T, nepmod.CallableNEP):
        raise TypeError("moment solvers need an SPMF/polynomial NEP")
    return T, X, contour, z, w, _factor_all(T, z, False)


def nlfeast_moments_all(T, X0, nodes: int = 16, iters: int = 10, *,
                        moments: int = 2, c: complex = 0.0 + 0.0j,
                        r: float = 1.0, contour: Optional[ct.Contour] = None,
                        tol: float = 1e-11, spurious: float = 1e-5,
                        debug: bool = False, device="cuda") -> NlfeastResult:
    T, X, contour, z, w, chunks = _setup_moments(T, X0, nodes, c, r, contour, device)
    n, m0 = X.shape
    K = int(moments)
    zeta, scale = _scaled(contour, z)
    Y = torch.zeros((n, K * m0), dtype=C128, device=X.device)
    R = torch.zeros_like(Y)
    lam = torch.zeros(K * m0, dtype=C128, device=X.device)
    res = inside = None
    n_iter, converged = 0, False
    for nit in range(iters + 1):
        n_iter = nit
        if nit == 0:
            Qm = _moment_stack(chunks, z, zeta, w, X, R, lam, True, 2 * K)
        else:
            Qm = 0
            for ch in chunks:
                # full-width RII: solve against all K m0 residual columns
                t = lumod.lu_solve(ch.LU, ch.perm, R, dinv=ch.dinv)
                lead = _filter_terms(t, z[ch.sl], w[ch.sl], Y, lam, False)[:, :, :m0]
                zc = zeta[ch.sl]
                Qm = Qm + torch.cat([_zeta_powers(lead, zc, K),
                                     _zeta_powers(lead, zc, K, start=K)]).sum(1)
        Q0, Q1 = _hankel(Qm, K)
        mu, Ynew = beyn_svd_extract(Q0, Q1, top_rows=n)
        lam = _unscale(mu, scale)
        Ynew, Rnew, res = _residuals(T, Ynew, lam)
        lam, Y, R, res = _sorted_by_residual(lam, Ynew, Rnew, res)
        X = Y[:, :m0]
        inside = _in_mask(lam, contour.kind, contour.params)
        res_h, inside_h = res.cpu().numpy(), inside.cpu().numpy()
        if debug:
            _dbg(nit, res_h, inside_h, spurious)
        if _stop(nit, res_h, inside_h, tol, spurious):
            converged = True
            break
    return NlfeastResult(lam, cx.normalize_cols(Y), res, inside, n_iter, converged)


def _ss_extract(T, Sm, probe, K: int, shift: int, scale, rank_tol: float = 1e-13):
    """Left-projected Hankel extraction of a (2K+1, n, m0) moment stack on
    an (n, m0) probe; shift is the moment offset of the Hankel blocks (1 at
    start-up, 0 in refinement).  Returns the residual-sorted (lam, Y, R,
    res)."""
    proj = [probe.mH @ Sm[j] for j in range(2 * K + 1)]
    Q0 = torch.cat([torch.cat([proj[i + j + shift] for j in range(K)], dim=1)
                    for i in range(K)])
    Q1 = torch.cat([torch.cat([proj[i + j + shift + 1] for j in range(K)], dim=1)
                    for i in range(K)])
    H1, H0, V = _deflated_pencil(Q0, Q1, rank_tol, far=1e8)
    mu, Xq = eigmod.gen_eig(H1, H0)
    lam = _unscale(mu, scale)
    Sflat = torch.cat([Sm[j] for j in range(K)], dim=1)
    Yout, Rfull, res = _residuals(T, Sflat @ (V @ Xq), lam)
    return _sorted_by_residual(lam, Yout, Rfull, res)


def nlfeast_moments_ss(T, X0, nodes: int = 16, iters: int = 10, *,
                       moments: int = 2, c: complex = 0.0 + 0.0j,
                       r: float = 1.0, contour: Optional[ct.Contour] = None,
                       tol: float = 1e-11, spurious: float = 1e-5,
                       seed: int = 0, debug: bool = False,
                       device="cuda") -> NlfeastResult:
    T, X, contour, z, w, chunks = _setup_moments(T, X0, nodes, c, r, contour, device)
    n, m0 = X.shape
    K = int(moments)
    rng = np.random.default_rng(seed)
    zeta, scale = _scaled(contour, z)
    R = torch.zeros_like(X)
    lam_m0 = torch.zeros(m0, dtype=C128, device=X.device)
    lam_all = Y = res = inside = None
    n_iter, converged = 0, False
    for nit in range(iters + 1):
        n_iter = nit
        # start-up projects on X itself; each refinement on a fresh probe
        probe = X if nit == 0 else as_tensor(
            rng.standard_normal((n, m0)) + 1j * rng.standard_normal((n, m0)),
            C128, X.device)
        Sm = _moment_stack(chunks, z, zeta, w, X, R, lam_m0, nit == 0, 2 * K + 1)
        lam_all, Y, Rf, res = _ss_extract(T, Sm, probe, K, 1 if nit == 0 else 0, scale)
        X, R, lam_m0 = Y[:, :m0], Rf[:, :m0], lam_all[:m0]
        inside = _in_mask(lam_all, contour.kind, contour.params)
        res_h, inside_h = res.cpu().numpy()[:m0], inside.cpu().numpy()[:m0]
        if debug:
            _dbg(nit, res_h, inside_h, spurious)
        if _stop(nit, res_h, inside_h, tol, spurious):
            converged = True
            break
    return NlfeastResult(lam_all, cx.normalize_cols(Y), res, inside, n_iter, converged)


def nlfeast_rr(T, X0, nodes: int = 16, iters: int = 10, *,
               c: complex = 0.0 + 0.0j, r: float = 1.0,
               contour: Optional[ct.Contour] = None, tol: float = 1e-11,
               spurious: float = 1e-5, debug: bool = False,
               device="cuda") -> NlfeastResult:
    """NLFEAST with projected-pencil (ggev-style) extraction: the
    reference's exported but never included nlfeast_opt!, made callable."""
    T, X, contour, z, w, chunks = _setup_moments(T, X0, nodes, c, r, contour, device)
    zeta, scale = _scaled(contour, z)
    R = torch.zeros_like(X)
    lam = torch.zeros(X.shape[1], dtype=C128, device=X.device)
    res = inside = None
    n_iter, converged = 0, False
    for nit in range(iters + 1):
        n_iter = nit
        Q0, Q1 = _moment_stack(chunks, z, zeta, w, X, R, lam, nit == 0, 2)
        mu, Vr = eigmod.gen_eig(X.mH @ Q1, X.mH @ Q0)
        lam = _unscale(mu, scale)
        X, R, res = _residuals(T, Q0 @ Vr, lam)
        inside = _in_mask(lam, contour.kind, contour.params)
        res_h, inside_h = res.cpu().numpy(), inside.cpu().numpy()
        if debug:
            _dbg(nit, res_h, inside_h, spurious)
        if _stop(nit, res_h, inside_h, tol, spurious):
            converged = True
            break
    return NlfeastResult(lam, cx.normalize_cols(X), res, inside, n_iter, converged)
