"""Nonlinear FEAST: contour-moment solvers with residual-inverse refinement.

Counterpart of `feast_tpu/solvers/nlfeast.py`:

  * the node loop is a batch over a leading node axis (in chunks of
    `factor_chunk` nodes with mixed_prec or store=False): evaluate T(z_i)
    into one buffer, factor it (the panel kernel for complex64 on the card,
    zero-padded to a multiple of 128), solve, refine, and add the chunk's
    moment terms;
  * the first pass applies the plain filter T(z_i)^{-1} X w_i, later ones
    the RII form (X - T(z_i)^{-1} R) diag(w_i / (z_i - lam));
  * extraction is Beyn's SVD step: SVD(Q0), project Q1, eig of the small
    matrix (the Schur kernel seeds it on the card), X = U W;
  * `nlfeast_moments` accumulates 2K moments, assembles the block-Hankel
    pair and keeps the residual-sorted best m0 of the K m0 Ritz pairs;
  * the two-tier stop: all inside below tol, or after the first
    refinement the non-spurious subset (res < spurious) below tol;
  * any `Contour` is accepted; moments use the centered-scaled node
    (z - c)/r (`_scaled`), mapped back by `_unscale`.

With mixed_prec the node matrices are evaluated and factored in complex64
and each solve is refined by 2 steps of complex128 iterative refinement
whose residual is applied in SPMF form (`apply_block`: d matrix products,
no complex128 node matrix).  store=False re-evaluates and re-factors every
chunk in every pass (peak memory one chunk), store=True keeps the chunks'
factors.  Every solve goes through the diagonal-block inverses
(`lu_diag_inv`), so a substitution is a few matrix products.  A
`CallableNEP` runs in host mode: its residuals are formed on the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import contour as ct
from .. import cx
from .. import nep as nepmod
from .._device import as_tensor, resolve_device
from ..ops import eig as eigmod
from ..ops import lu as lumod
from ..ops import qr as qrmod
from ..ops import svd as svdmod
from ..utils import tracing
from .feast import _in_mask

C64, C128 = torch.complex64, torch.complex128


class NlfeastResult(NamedTuple):
    lam: torch.Tensor
    X: torch.Tensor
    res: torch.Tensor
    inside: torch.Tensor
    n_iter: int
    converged: bool

    def filtered(self, spurious: Optional[float] = None):
        """Host numpy (lam, X, res) inside the contour (and below
        `spurious` in residual when given)."""
        mask = self.inside.cpu().numpy()
        res = self.res.cpu().numpy()
        if spurious is not None:
            mask = mask & (res < spurious)
        return self.lam.cpu().numpy()[mask], self.X.cpu().numpy()[:, mask], res[mask]


def beyn_svd_extract(Q0: torch.Tensor, Q1: torch.Tensor,
                     top_rows: Optional[int] = None, rank_tol: float = 1e-13):
    """Beyn's SVD extraction: (lam, X), X = U eigvecs(U^H Q1 V diag(1/s)),
    U cut to its first `top_rows` rows when given (block-Hankel case).

    Directions with s < rank_tol s_max are deflated with static shapes:
    their rows and columns of the projected matrix are zeroed and the
    diagonal set far away (1e3), so a rank-deficient Q0 injects no
    1/eps-scale noise into the small eigenproblem."""
    U, s, Vh = svdmod.svd(Q0)
    eps = torch.finfo(s.dtype).eps
    keep = s > torch.clamp(s[0], min=eps) * rank_tol
    M = (U.mH @ (Q1 @ Vh.mH)) / torch.where(keep, s, 1.0)[None, :]
    kmask = keep.to(s.dtype)
    omask = kmask[:, None] * kmask[None, :]
    eye = torch.eye(M.shape[0], dtype=s.dtype, device=M.device)
    far = 1e3
    M = torch.complex(M.real * omask + (1.0 - kmask) * eye * far, M.imag * omask)
    lam, W = eigmod.eig(M)
    Utop = U if top_rows is None else U[:top_rows]
    return lam, Utop @ W


def beyn_qr_extract(Q0: torch.Tensor, Q1: torch.Tensor):
    """QR-based Beyn step: eig of Q^H Q1 R^{-1} with Q0 = Q R."""
    Q, Rf = qrmod.cholqr2(Q0)
    lam, W = eigmod.eig(qrmod.right_solve_upper(Q.mH @ Q1, Rf))
    return lam, Q @ W


def beyn_rr_extract(Q0: torch.Tensor, Q1: torch.Tensor, X: torch.Tensor):
    """Projected-pencil Beyn step: generalized eig of (X^H Q1, X^H Q0),
    vectors through Q0."""
    lam, W = eigmod.gen_eig(X.mH @ Q1, X.mH @ Q0)
    return lam, Q0 @ W


def beyn_rr2_extract(Q0: torch.Tensor, Q1: torch.Tensor):
    """Self-projected pencil: generalized eig of (Q0^H Q1, Q0^H Q0)."""
    lam, W = eigmod.gen_eig(Q0.mH @ Q1, Q0.mH @ Q0)
    return lam, Q0 @ W


def _residuals(T, X: torch.Tensor, lam: torch.Tensor):
    """Unit columns and relative residuals ||T(lam) x|| / ||T(lam)||_F."""
    X = cx.normalize_cols(X)
    R = T.apply_cols(X, lam)
    tiny = torch.finfo(cx.real_dtype(R.dtype)).tiny
    return X, R, cx.col_norms(R) / torch.clamp(T.fro_norms(lam), min=tiny)


def _scaled(contour: ct.Contour, z: torch.Tensor):
    """Centered-scaled nodes zeta = (z - c)/r and the scale (c_re, c_im, r).

    Every moment solver accumulates powers of zeta, not of z: the Hankel
    pencil then gives mu = (lam - c)/r, mapped back by `_unscale`.  With z
    itself, a contour such as loaded_string's (c = 800, r = 790) has z^5
    near 1e16 and the block-Hankel conditioning collapses."""
    c = complex(contour.center)
    r = float(contour.radius) or 1.0
    zeta = torch.complex((z.real - c.real) / r, (z.imag - c.imag) / r)
    return zeta, (c.real, c.imag, r)


def _unscale(mu: torch.Tensor, scale) -> torch.Tensor:
    c_re, c_im, r = scale
    return torch.complex(c_re + r * mu.real, c_im + r * mu.imag)


def _stop(nit, res_h, inside_h, tol, spurious) -> bool:
    """Two-tier stop: every inside residual below tol, or (after the first
    refinement) every non-spurious inside residual below tol."""
    if inside_h.any():
        res_in = res_h[inside_h]
        if res_in.max() < tol:
            return True
        if nit > 1:
            non_spur = res_in[res_in < spurious]
            if len(non_spur) > 0 and non_spur.max() < tol:
                return True
    return False


def _dbg(nit, res, inside, spurious):
    n_in = int(inside.sum())
    if n_in:
        ri = res[inside]
        ns = ri[ri < spurious]
        extra = f" ({ns.max():.3e})" if len(ns) else ""
        print(f"{nit}: {n_in} ({len(ns)}) {ri.max():.3e}{extra}")
    else:
        print(f"{nit}: 0 inside")


def _setup(T, X0, contour, c, r, nodes, device):
    """(T, X, contour, z, w) on the resolved device, complex128."""
    dev = resolve_device(device)
    X = as_tensor(X0, C128, dev)
    T = nepmod.as_nep(T, n=X.shape[0], device=dev)
    if contour is None:
        contour = ct.circular_contour_trapezoidal(complex(c), float(r), int(nodes))
    return T, X, contour, contour.device_nodes(C128, dev), contour.device_weights(C128, dev)


# ---------------------------------------------------------------------------
# node factors and solves, a chunk of nodes at a time
# ---------------------------------------------------------------------------

class _Chunk(NamedTuple):
    sl: slice           # the chunk's nodes
    LU: torch.Tensor
    perm: torch.Tensor
    dinv: tuple


@tracing.spanned("nlfeast.factor", "z")
def _factor_chunk(T, z: torch.Tensor, sl: slice, mixed: bool) -> _Chunk:
    """Evaluate T at the chunk's nodes straight into a factor buffer
    (zero-padded for the panel kernel on the card) and factor it.  Spans:
    "nlfeast.factor", inside it "nlfeast.factor.form" (T at the nodes),
    "nlfeast.factor.lu" and "nlfeast.factor.diag_inv" (with `blocks` and
    `kernel_blocks`, `lumod.lu_diag_inv`)."""
    dt = C64 if mixed else C128
    n = T.n
    buf = lumod.factor_buffer((z[sl].shape[0],), n, dt, z.device)
    with tracing.span("nlfeast.factor.form", z.device):
        T.eval_nodes(z[sl], out_dtype=dt, out=buf[:, :n, :n])
    with tracing.span("nlfeast.factor.lu", z.device) as sp:
        LU, perm = lumod.lu_factor_inplace(buf, n, span=sp)
    with tracing.span("nlfeast.factor.diag_inv", z.device) as sp:
        dinv = lumod.lu_diag_inv(LU, lumod._solve_block(n), span=sp)
    return _Chunk(sl, LU, perm, dinv)


def _factor_all(T, z: torch.Tensor, mixed: bool, chunk: Optional[int] = None):
    """The factors of every node, in chunks of `chunk` nodes (all in one
    batch by default, as the JAX package's drivers factor them)."""
    chunk = chunk or z.shape[0]
    return [_factor_chunk(T, z, slice(i0, i0 + chunk), mixed)
            for i0 in range(0, z.shape[0], chunk)]


def _node_solve(T, ch: _Chunk, z: torch.Tensor, Bm: torch.Tensor, mixed: bool,
                refine: int = 2) -> torch.Tensor:
    """T(z_i)^{-1} Bm for the chunk's nodes: (N, n, m).  Mixed: complex64
    solves plus `refine` steps of complex128 refinement with the residual
    Bm - T(z_i) t_i in SPMF form."""
    if not mixed:
        return lumod.lu_solve(ch.LU, ch.perm, Bm, dinv=ch.dinv)
    t = lumod.lu_solve(ch.LU, ch.perm, Bm.to(C64), dinv=ch.dinv).to(C128)
    for _ in range(refine):
        resid = Bm - T.apply_block(z[ch.sl], t)
        t = t + lumod.lu_solve(ch.LU, ch.perm, resid.to(C64), dinv=ch.dinv).to(C128)
    return t


def _filter_terms(t, z, w, X, lam, first: bool):
    """Per-node filter terms: t w_i (first pass) or (X - t) w_i/(z_i - lam)."""
    if first:
        return t * w[:, None, None]
    resv = cx.cdiv(w[:, None].expand(-1, lam.shape[0]), z[:, None] - lam[None, :])
    return (X[None] - t) * resv[:, None, :]


def _moment_pair(T, chunks, z, zeta, w, X, R, lam, first, mixed, chunk):
    """Q0 = sum_i term_i and Q1 = sum_i zeta_i term_i over all nodes, from
    the stored chunk factors, or (chunks None) factoring each chunk anew.
    Span: "nlfeast.node_solve" around a chunk's solves and filter terms."""
    Q0 = torch.zeros_like(X)
    Q1 = torch.zeros_like(X)
    for i0 in range(0, z.shape[0], chunk):
        sl = slice(i0, i0 + chunk)
        ch = chunks[i0 // chunk] if chunks is not None else _factor_chunk(T, z, sl, mixed)
        with tracing.span("nlfeast.node_solve", X.device):
            t = _node_solve(T, ch, z, X if first else R, mixed)
            term = _filter_terms(t, z[sl], w[sl], X, lam, first)
        Q0 += term.sum(0)
        Q1 += (term * zeta[sl][:, None, None]).sum(0)
        del ch, t, term
    return Q0, Q1


@tracing.spanned("nlfeast.extract", "Q0")
def _extract(T, Q0, Q1, contour, scale):
    """Beyn extraction, unscaled values, residuals and the inside mask.
    A CallableNEP forms its residuals on the host.  Span:
    "nlfeast.extract"."""
    mu, Xn = beyn_svd_extract(Q0, Q1)
    lam = _unscale(mu, scale)
    if isinstance(T, nepmod.CallableNEP):
        Xn = cx.normalize_cols(Xn)
        Xh, lamh = Xn.cpu().numpy(), lam.cpu().numpy()
        Rh = T.host_apply_cols(Xh, lamh)
        resh = np.linalg.norm(Rh, axis=0) / np.maximum(T.host_fro_norms(lamh), 1e-300)
        inside = torch.as_tensor(np.asarray(ct.in_contour(lamh, contour)))
        return Xn, as_tensor(Rh, Xn.dtype, Xn.device), lam, torch.as_tensor(resh), inside
    Xn, Rn, res = _residuals(T, Xn, lam)
    return Xn, Rn, lam, res, _in_mask(lam, contour.kind, contour.params)


@tracing.spanned("nlfeast.solve", "device")
def nlfeast(T, X0, nodes: int = 16, iters: int = 10, *,
            c: complex = 0.0 + 0.0j, r: float = 1.0,
            contour: Optional[ct.Contour] = None, tol: float = 1e-11,
            spurious: float = 1e-5, mixed_prec: bool = False,
            store: bool = True, factor_chunk: int = 4,
            debug: bool = False, device="cuda") -> NlfeastResult:
    """Nonlinear FEAST (the reference's nlfeast!).

    T: an SPMF/PolynomialNEP (on `device`), a list of polynomial
    coefficients, or a host callable z -> matrix.  X0: (n, m0) initial
    subspace.  mixed_prec (SPMF only): complex64 node factors (the panel
    kernel on the card) and complex128 refinement in SPMF form.  store=False
    (SPMF only): re-evaluate and re-factor `factor_chunk` nodes at a time in
    every pass, so the peak holds one chunk's factors.  The span
    "nlfeast.solve" is the root of the solve's spans."""
    T, X, contour, z, w = _setup(T, X0, contour, c, r, nodes, device)
    n, m0 = X.shape
    host_mode = isinstance(T, nepmod.CallableNEP)
    if mixed_prec and host_mode:
        raise ValueError("mixed_prec needs an SPMF/polynomial T (the "
                         "refinement residual is applied in SPMF form)")
    if not store and host_mode:
        raise ValueError("store=False needs an SPMF/polynomial T")
    mixed = bool(mixed_prec)
    # as the JAX package: chunks of factor_chunk nodes with mixed_prec or
    # store=False, all nodes in one batch otherwise
    chunk = int(factor_chunk) if (mixed or not store) else z.shape[0]
    chunks = _factor_all(T, z, mixed, chunk) if store else None
    X, _ = qrmod.cholqr2(X)
    zeta, scale = _scaled(contour, z)
    lam = torch.zeros(m0, dtype=C128, device=X.device)
    R = torch.zeros_like(X)
    res = inside = None
    n_iter, converged = 0, False
    for nit in range(iters + 1):
        n_iter = nit
        Q0, Q1 = _moment_pair(T, chunks, z, zeta, w, X, R, lam, nit == 0,
                              mixed, chunk)
        X, R, lam, res, inside = _extract(T, Q0, Q1, contour, scale)
        res_h, inside_h = res.cpu().numpy(), inside.cpu().numpy()
        if debug:
            _dbg(nit, res_h, inside_h, spurious)
        if _stop(nit, res_h, inside_h, tol, spurious):
            converged = True
            break
    return NlfeastResult(lam, cx.normalize_cols(X), res, inside, n_iter, converged)


# ---------------------------------------------------------------------------
# nlfeast_moments (block Hankel, K moments)
# ---------------------------------------------------------------------------

def _zeta_powers(term: torch.Tensor, zeta: torch.Tensor, count: int,
                 start: int = 0) -> torch.Tensor:
    """term_i zeta_i^p for p = start .. start+count-1: (count, N, n, m), the
    powers by repeated products as the JAX package forms them."""
    zp = cx.cpow_scalar(zeta, start) if start else torch.ones_like(zeta)
    out = []
    for _ in range(count):
        out.append(term * zp[:, None, None])
        zp = zp * zeta
    return torch.stack(out)


def _moment_stack(chunks, z, zeta, w, X, R, lam, first, count):
    """sum over nodes of term_i zeta_i^p, p = 0 .. count-1: (count, n, m)."""
    S = None
    for ch in chunks:
        t = lumod.lu_solve(ch.LU, ch.perm, X if first else R, dinv=ch.dinv)
        term = _filter_terms(t, z[ch.sl], w[ch.sl], X, lam, first)
        part = _zeta_powers(term, zeta[ch.sl], count).sum(1)
        S = part if S is None else S + part
    return S


def _hankel(Qm: torch.Tensor, K: int):
    """Q0 = [Q_{i+j}], Q1 = [Q_{i+j+1}] (K n, K m0) from the moment stack
    Qm (2K, n, m0)."""
    Q0 = torch.cat([torch.cat([Qm[i + j] for j in range(K)], dim=1) for i in range(K)])
    Q1 = torch.cat([torch.cat([Qm[i + j + 1] for j in range(K)], dim=1) for i in range(K)])
    return Q0, Q1


def _sorted_by_residual(lam, Y, R, res):
    p = torch.argsort(res, stable=True)
    return lam[p], Y[:, p], R[:, p], res[p]


def nlfeast_moments(T, X0, nodes: int = 16, iters: int = 10, *,
                    moments: int = 2, c: complex = 0.0 + 0.0j, r: float = 1.0,
                    contour: Optional[ct.Contour] = None, tol: float = 1e-11,
                    spurious: float = 1e-5, debug: bool = False,
                    device="cuda") -> NlfeastResult:
    """Higher-moment NLFEAST (the reference's nlfeast_moments!).

    The search space is K m0 (block Hankel); the residual-best m0 columns
    are refined by the node solves.  Returns the whole K m0 Ritz set sorted
    by residual.  As in the reference, the two-tier stop accepts the
    non-spurious subset, so keep m0 at or above the expected count."""
    T, X, contour, z, w = _setup(T, X0, contour, c, r, nodes, device)
    n, m0 = X.shape
    K = int(moments)
    if isinstance(T, nepmod.CallableNEP):
        raise TypeError("nlfeast_moments needs an SPMF/polynomial NEP")
    chunks = _factor_all(T, z, False)
    zeta, scale = _scaled(contour, z)
    lam_m0 = torch.zeros(m0, dtype=C128, device=X.device)
    R = torch.zeros_like(X)
    lam_all = Y = res = inside = None
    n_iter, converged = 0, False
    for nit in range(iters + 1):
        n_iter = nit
        Qm = _moment_stack(chunks, z, zeta, w, X, R, lam_m0, nit == 0, 2 * K)
        Q0, Q1 = _hankel(Qm, K)
        mu, Y = beyn_svd_extract(Q0, Q1, top_rows=n)
        lam_all = _unscale(mu, scale)
        Y, Ry, res = _residuals(T, Y, lam_all)
        lam_all, Y, Ry, res = _sorted_by_residual(lam_all, Y, Ry, res)
        X, R, lam_m0 = Y[:, :m0], Ry[:, :m0], lam_all[:m0]
        inside = _in_mask(lam_all, contour.kind, contour.params)
        res_h, inside_h = res.cpu().numpy()[:m0], inside.cpu().numpy()[:m0]
        if debug:
            _dbg(nit, res_h, inside_h, spurious)
        if _stop(nit, res_h, inside_h, tol, spurious):
            converged = True
            break
    return NlfeastResult(lam_all, cx.normalize_cols(Y), res, inside, n_iter, converged)


# ---------------------------------------------------------------------------
# nlfeast_it: Krylov node solves
# ---------------------------------------------------------------------------

def nlfeast_it(T, X0, nodes: int = 16, iters: int = 10, *,
               c: complex = 0.0 + 0.0j, r: float = 1.0,
               contour: Optional[ct.Contour] = None, tol: float = 1e-11,
               spurious: float = 1e-5, solve_tol: float = 1e-8,
               solve_iters: int = 500, debug: bool = False,
               device="cuda") -> NlfeastResult:
    """NLFEAST with BiCGStab node solves (the reference's nlfeast_it!),
    every node warm-started from its previous solution; all nodes and
    columns advance together, each node frozen when its own solve stops."""
    from ..ops import krylov

    T, X, contour, z, w = _setup(T, X0, contour, c, r, nodes, device)
    n, m0 = X.shape
    if isinstance(T, nepmod.CallableNEP):
        raise TypeError("nlfeast_it needs an SPMF/polynomial NEP")
    Tz = T.eval_nodes(z)                       # (N, n, n) operands
    X, _ = qrmod.cholqr2(X)
    zeta, scale = _scaled(contour, z)
    warm = torch.zeros((z.shape[0], n, m0), dtype=C128, device=X.device)
    lam = torch.zeros(m0, dtype=C128, device=X.device)
    R = torch.zeros_like(X)
    res = inside = None
    n_iter, converged = 0, False
    for nit in range(iters + 1):
        n_iter = nit
        first = nit == 0
        rhs = (X if first else R).expand(z.shape[0], n, m0).contiguous()
        sol = krylov.bicgstab(lambda V: Tz @ V, rhs, x0=warm, tol=solve_tol,
                              maxiter=solve_iters)
        warm = sol.x
        term = _filter_terms(sol.x, z, w, X, lam, first)
        Q0 = term.sum(0)
        Q1 = (term * zeta[:, None, None]).sum(0)
        mu, Xn = beyn_svd_extract(Q0, Q1)
        lam = _unscale(mu, scale)
        X, R, res = _residuals(T, Xn, lam)
        inside = _in_mask(lam, contour.kind, contour.params)
        res_h, inside_h = res.cpu().numpy(), inside.cpu().numpy()
        if debug:
            _dbg(nit, res_h, inside_h, spurious)
        if _stop(nit, res_h, inside_h, tol, spurious):
            converged = True
            break
    return NlfeastResult(lam, cx.normalize_cols(X), res, inside, n_iter, converged)
