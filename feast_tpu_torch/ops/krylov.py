"""Batched matrix-free Krylov solvers on complex tensors.

Counterpart of `feast_tpu/ops/krylov.py`.  All right-hand sides advance at
once: B is (..., n, m), each iteration is block matvecs plus column-wise
scalar recurrences, and converged columns freeze.  The operator is a
callable X -> A @ X, the optional preconditioner M: X -> M^{-1} X is
applied on the right.

Leading dimensions of B are independent systems (the contour-node axis of
`feast_iterative`; the JAX package `vmap`s a `lax.while_loop`
over it).  The loop runs until the last system stops; a system whose own
stop test has fired is frozen whole from then on, and inside a running
system each converged column is frozen, so every system gets exactly the
iterates and the iteration count of a solve on its own.  Per-column
scalars are (..., m), `iters` is (...,).  The stop test reads one small
tensor on the host per iteration.

The systems are solved in column-scaled form (each b_k normalized to unit
norm, the solution unscaled at the end), which keeps every recurrence
quantity O(1) whatever the scale of the right-hand side.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from .. import cx
from . import lu as lumod


class KrylovResult(NamedTuple):
    x: torch.Tensor          # (..., n, m)
    resnorm: torch.Tensor    # (..., m) final relative residual norms
    iters: torch.Tensor      # (...,) iterations used
    converged: torch.Tensor  # (..., m) bool


def _safe_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ok = cx.abs2(b) > torch.finfo(cx.real_dtype(a.dtype)).tiny
    out = cx.cdiv(a, torch.where(ok, b, torch.ones_like(b)))
    return torch.where(ok, out, torch.zeros_like(out))


def _scaled_system(B, x0):
    """Column-scaled right-hand side and start: (B / |b_k|, x0 / |b_k|,
    |b_k|, 1 / |b_k|) with a zero column scaled by 1."""
    tiny = torch.finfo(cx.real_dtype(B.dtype)).tiny
    cn = cx.col_norms(B)
    bn_true = torch.where(cn > tiny, cn, 1.0)
    inv = 1.0 / bn_true
    x = torch.zeros_like(B) if x0 is None else cx.scale_cols(x0, inv)
    return cx.scale_cols(B, inv), x, bn_true, inv


def _running(active, it=None, cap=None):
    """Per-system stop test from the per-column `active` mask and the
    iteration cap: (on (...,) bool, any on, all on); one host read."""
    on = active.any(dim=-1)
    if cap is not None:
        on = on & (it < cap)
    on_h = on.cpu()
    return on, bool(on_h.any()), bool(on_h.all())


def bicgstab(matvec: Callable, B: torch.Tensor, x0: Optional[torch.Tensor] = None,
             tol: float = 1e-8, maxiter: int = 1000,
             M: Optional[Callable] = None, bnorm=None) -> KrylovResult:
    """Unpreconditioned / right-preconditioned BiCGStab for a block of
    right-hand sides; per-column scalars (rho, alpha, omega) are (..., m).

    bnorm: optional (..., m) override for the per-column norms the relative
    tolerance is measured against (`bicgstab_rr`'s restart passes solve
    correction systems but stop relative to the original right-hand side).
    """
    rdt = cx.real_dtype(B.dtype)
    ident = (lambda v: v) if M is None else M
    tiny = torch.finfo(rdt).tiny
    B, x, bn_true, inv = _scaled_system(B, x0)
    ref = bn_true if bnorm is None else torch.clamp(bnorm, min=tiny)
    r = B - matvec(x)
    # ||r|| / ref in original units equals ||r_scaled|| * bn_true / ref
    rscale = torch.clamp(ref * inv, min=tiny)
    rhat = r
    p = v = torch.zeros_like(B)
    rho = alpha = omega = torch.ones(B.shape[:-2] + B.shape[-1:], dtype=B.dtype,
                                     device=B.device)
    it = torch.zeros(B.shape[:-2], dtype=torch.int64, device=B.device)

    def resrel(r):
        return cx.col_norms(r) / rscale

    while True:
        active = resrel(r) > tol
        on, any_on, all_on = _running(active, it, maxiter)
        if not any_on:
            break
        rho_new = cx.cdot_cols(rhat, r)
        beta = _safe_div(rho_new * alpha, rho * omega)
        p_new = r + cx.scale_cols(p - cx.scale_cols(v, omega), beta)
        ph = ident(p_new)
        v_new = matvec(ph)
        alpha_new = _safe_div(rho_new, cx.cdot_cols(rhat, v_new))
        s = r - cx.scale_cols(v_new, alpha_new)
        sh = ident(s)
        t = matvec(sh)
        omega_new = _safe_div(cx.cdot_cols(t, s), cx.cdot_cols(t, t))
        x_new = x + cx.scale_cols(ph, alpha_new) + cx.scale_cols(sh, omega_new)
        r_new = s - cx.scale_cols(t, omega_new)
        if all_on:
            upd = active.unsqueeze(-2)
            p, v, rho, alpha, omega = p_new, v_new, rho_new, alpha_new, omega_new
        else:
            col, blk = on[..., None], on[..., None, None]
            upd = (active & col).unsqueeze(-2)
            p, v = torch.where(blk, p_new, p), torch.where(blk, v_new, v)
            rho = torch.where(col, rho_new, rho)
            alpha = torch.where(col, alpha_new, alpha)
            omega = torch.where(col, omega_new, omega)
        x = torch.where(upd, x_new, x)       # converged columns stay frozen
        r = torch.where(upd, r_new, r)
        it = it + on
    rel = resrel(r)
    return KrylovResult(cx.scale_cols(x, bn_true), rel, it, rel <= tol)


def bicgstab_rr(matvec: Callable, B: torch.Tensor, x0: Optional[torch.Tensor] = None,
                tol: float = 1e-8, maxiter: int = 1000,
                M: Optional[Callable] = None,
                replace_every: int = 30) -> KrylovResult:
    """BiCGStab with residual replacement ("reliable updates"): restart from
    a freshly computed true residual b - A x every `replace_every`
    iterations.  The recursively updated residual of plain BiCGStab drifts
    from the true one by about eps * kappa(A) over a long solve; restarting
    from the true residual resets the drift each pass, so the attainable
    accuracy is that of a direct solve.  A stale warm start only seeds the
    first pass's true residual."""
    tiny = torch.finfo(cx.real_dtype(B.dtype)).tiny
    bnorm = torch.clamp(cx.col_norms(B), min=tiny)
    x = torch.zeros_like(B) if x0 is None else x0
    npass = max(1, -(-maxiter // replace_every))
    it_total = torch.zeros(B.shape[:-2], dtype=torch.int64, device=B.device)
    rel = torch.full_like(bnorm, float("inf"))
    for _ in range(npass):
        on, any_on, _ = _running(rel > tol)
        if not any_on:
            break
        sol = bicgstab(matvec, B - matvec(x), x0=None, tol=tol,
                       maxiter=replace_every, M=M, bnorm=bnorm)
        x = torch.where(on[..., None, None], x + sol.x, x)
        it_total = it_total + torch.where(on, sol.iters, 0)
        rel = torch.where(on[..., None], sol.resnorm, rel)
    # final true relative residual, the difference scaled before the norm
    rel = cx.col_norms(cx.scale_cols(B - matvec(x), 1.0 / bnorm))
    return KrylovResult(x, rel, it_total, rel <= tol)


def gmres(matvec: Callable, B: torch.Tensor, x0: Optional[torch.Tensor] = None,
          tol: float = 1e-8, restart: int = 30, maxrestart: int = 20,
          M: Optional[Callable] = None) -> KrylovResult:
    """Restarted block-column GMRES(restart): each column runs its own
    Arnoldi recurrence on a basis batched over columns.  Memory:
    (restart + 1) blocks of B's size.  `iters` counts restart cycles."""
    rdt = cx.real_dtype(B.dtype)
    ident = (lambda v: v) if M is None else M
    tiny = torch.finfo(rdt).tiny
    B, x, bn_true, _ = _scaled_system(B, x0)
    k = restart
    cols = B.shape[:-2] + B.shape[-1:]

    def arnoldi_cycle(x):
        r = B - matvec(x)
        beta = cx.col_norms(r)
        V = [r / torch.clamp(beta, min=tiny).unsqueeze(-2)]
        H = torch.zeros((k + 1, k) + cols, dtype=B.dtype, device=B.device)
        for j in range(k):
            w = matvec(ident(V[j]))
            for i in range(j + 1):           # modified Gram-Schmidt
                h = cx.cdot_cols(V[i], w)
                w = w - cx.scale_cols(V[i], h)
                H[i, j] = h
            hnext = cx.col_norms(w)
            H[j + 1, j] = hnext
            V.append(w / torch.clamp(hnext, min=tiny).unsqueeze(-2))
        # least squares per column, H (k+1, k) y = beta e1, by complex
        # Givens QR (normal equations would square the conditioning)
        g = torch.zeros((k + 1,) + cols, dtype=B.dtype, device=B.device)
        g[0] = beta
        one = torch.ones(cols, dtype=B.dtype, device=B.device)
        for j in range(k):
            a, b = H[j, j], H[j + 1, j]
            rr = torch.sqrt(cx.abs2(a) + cx.abs2(b))
            safe = rr > 0
            inv = torch.where(safe, 1.0 / torch.where(safe, rr, 1.0), 0.0)
            c = torch.where(safe, a.conj() * inv, one)
            s = b.conj() * inv
            ca = torch.where(safe, a * inv, one)
            cb = b * inv
            rowj, rowj1 = H[j].clone(), H[j + 1].clone()
            H[j] = c * rowj + s * rowj1
            H[j + 1] = ca * rowj1 - cb * rowj
            gj, gj1 = g[j].clone(), g[j + 1].clone()
            g[j] = c * gj + s * gj1
            g[j + 1] = ca * gj1 - cb * gj
        U = H[:k].movedim((0, 1), (-2, -1))            # (..., m, k, k)
        rhs = g[:k].movedim(0, -1).unsqueeze(-1)       # (..., m, k, 1)
        y = lumod._upper_solve_small(U, rhs)[..., 0]   # (..., m, k)
        upd = torch.zeros_like(B)
        for j in range(k):
            upd = upd + cx.scale_cols(V[j], y[..., j])
        return x + (ident(upd) if M is not None else upd)

    def resrel(x):
        return cx.col_norms(B - matvec(x))

    it = torch.zeros(B.shape[:-2], dtype=torch.int64, device=B.device)
    while True:
        on, any_on, _ = _running(resrel(x) > tol, it, maxrestart)
        if not any_on:
            break
        x = torch.where(on[..., None, None], arnoldi_cycle(x), x)
        it = it + on
    rel = resrel(x)
    return KrylovResult(cx.scale_cols(x, bn_true), rel, it, rel <= tol)


def bicgstab_l(matvec: Callable, B: torch.Tensor, x0: Optional[torch.Tensor] = None,
               ell: int = 2, tol: float = 1e-8, maxiter: int = 500,
               M: Optional[Callable] = None) -> KrylovResult:
    """BiCGStab(l) (Sleijpen-Fokkema) for a block of right-hand sides: the
    l-degree minimal-residual polynomial smooths BiCGStab's erratic
    convergence on complex / indefinite spectra.  Storage is two stacks of
    l + 1 blocks.  Right-preconditioned via M; x0 lives in true
    coordinates, the iteration accumulates increments in the preconditioned
    variable and maps them back at the end.  maxiter counts BiCGStab(l)
    cycles (2 l matvecs each)."""
    ident = (lambda v: v) if M is None else M

    def mv(v):
        return matvec(ident(v))

    B, x_init, bn_true, _ = _scaled_system(B, x0)
    cols = B.shape[:-2] + B.shape[-1:]
    x = torch.zeros_like(B)
    r0 = B - matvec(x_init)
    rhat = r0
    rs = [r0] + [torch.zeros_like(B) for _ in range(ell)]
    us = [torch.zeros_like(B) for _ in range(ell + 1)]
    rho0 = omega = torch.ones(cols, dtype=B.dtype, device=B.device)
    alpha = torch.zeros(cols, dtype=B.dtype, device=B.device)
    it = torch.zeros(B.shape[:-2], dtype=torch.int64, device=B.device)

    while True:
        on, any_on, all_on = _running(cx.col_norms(rs[0]) > tol, it, maxiter)
        if not any_on:
            break
        old = (x, list(rs), list(us), rho0, alpha, omega)
        rho0 = -(omega * rho0)
        for j in range(ell):                                  # BiCG part
            rho1 = cx.cdot_cols(rhat, rs[j])
            beta = _safe_div(alpha * rho1, rho0)
            rho0 = rho1
            for i in range(j + 1):
                us[i] = rs[i] - cx.scale_cols(us[i], beta)
            us[j + 1] = mv(us[j])
            alpha = _safe_div(rho0, cx.cdot_cols(rhat, us[j + 1]))
            for i in range(j + 1):
                rs[i] = rs[i] - cx.scale_cols(us[i + 1], alpha)
            rs[j + 1] = mv(rs[j])
            x = x + cx.scale_cols(us[0], alpha)
        # MR part: min ||r_0 - sum_j g_j r_j|| per column, normal equations
        # Z g = y with Z_ij = <r_i, r_j>, y_i = <r_i, r_0>
        Z = torch.stack([torch.stack([cx.cdot_cols(rs[i], rs[j])
                                      for j in range(1, ell + 1)], dim=-1)
                         for i in range(1, ell + 1)], dim=-2)   # (..., m, l, l)
        Y = torch.stack([cx.cdot_cols(rs[i], rs[0])
                         for i in range(1, ell + 1)], dim=-1)   # (..., m, l)
        g = lumod.solve(Z, Y.unsqueeze(-1), block=ell)[..., 0]
        for j in range(1, ell + 1):
            gj = g[..., j - 1]
            x = x + cx.scale_cols(rs[j - 1], gj)
            rs[0] = rs[0] - cx.scale_cols(rs[j], gj)
            us[0] = us[0] - cx.scale_cols(us[j], gj)
        omega = g[..., ell - 1]
        if not all_on:            # a stopped system keeps its whole state
            col, blk = on[..., None], on[..., None, None]
            x = torch.where(blk, x, old[0])
            rs = [torch.where(blk, a, b) for a, b in zip(rs, old[1])]
            us = [torch.where(blk, a, b) for a, b in zip(us, old[2])]
            rho0 = torch.where(col, rho0, old[3])
            alpha = torch.where(col, alpha, old[4])
            omega = torch.where(col, omega, old[5])
        it = it + on
    xfin = x_init + (ident(x) if M is not None else x)
    # the true residual (the recursive one can drift)
    rel = cx.col_norms(B - matvec(xfin))
    return KrylovResult(cx.scale_cols(xfin, bn_true), rel, it, rel <= tol)
