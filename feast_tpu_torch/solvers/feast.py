"""Linear FEAST drivers: standard, generalized, and the two-tier
mixed-precision `feast_compiled`.

Counterpart of `feast_tpu/solvers/feast.py`.  The refinement update keeps
the reference's residual-inverse-iteration form

    Q = sum_i (X - (A - z_i B)^{-1} R) diag(w_i / (z_i - lam))

with the node factorizations computed once per solve (store=True) or once
per sweep (store=False).  The contour-node axis is a batch dimension: all
nodes are factored, solved and refined together (16 x 4096^2 complex64 is
2.1 GB).  `lax.scan` and `lax.while_loop` become Python loops.  With
mixed_prec the node matrices are factored in complex64 (the panel kernel
on the card) and each solve is refined by 2 steps of complex128 iterative
refinement, each residual one wide matmul over all nodes.

Not ported yet (they raise NotImplementedError): `mesh`, `node_loop=True`,
`rr="host"`, `pencil="hermitian"` (and `hermitian=True`), and
`dual_gen_feast`.  `node_scan` only chose a memory layout in the JAX
package; the batched layout here serves every size it did, so the flag is
accepted and has no effect.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import contour as ct
from .. import cx
from .._device import as_tensor, resolve_device
from ..ops import eig as eigmod
from ..ops import lu as lumod
from ..ops import qr as qrmod


class FeastResult(NamedTuple):
    """Full-width result; `inside` masks the contour."""

    lam: torch.Tensor      # (m0,) Ritz values
    X: torch.Tensor        # (n, m0) Ritz vectors (unit columns)
    res: torch.Tensor      # (m0,) absolute residual norms
    inside: torch.Tensor   # (m0,) bool
    n_iter: int
    converged: bool
    Q: Optional[torch.Tensor] = None     # final moment subspace (keep_q)
    n_sweeps: int = 0                    # node-solve sweeps (feast_iterative)
    warm: Optional[torch.Tensor] = None  # (nodes, n, m0) Krylov warm starts

    def filtered(self):
        """Host numpy (lam, X, res) restricted to the contour."""
        mask = self.inside.cpu().numpy()
        return (self.lam.cpu().numpy()[mask], self.X.cpu().numpy()[:, mask],
                self.res.cpu().numpy()[mask])


def _unported(what: str):
    raise NotImplementedError(f"feast_tpu_torch: {what} is not ported yet")


def validate_dims(A, B, X, what: str = "feast"):
    """Driver-entry shape validation."""
    n = A.shape[0]
    if A.shape[0] != A.shape[1]:
        raise ValueError(f"{what}: A must be square, got {tuple(A.shape)}")
    if B is not None and tuple(B.shape) != tuple(A.shape):
        raise ValueError(f"{what}: B shape {tuple(B.shape)} != A shape "
                         f"{tuple(A.shape)}")
    if X.ndim != 2 or X.shape[0] != n:
        raise ValueError(f"{what}: X0 must be (n, m0) with n={n}, got "
                         f"{tuple(X.shape)}")
    if X.shape[1] > n:
        raise ValueError(f"{what}: subspace m0={X.shape[1]} exceeds n={n}")


def _prepare(A, B, X0, contour, c, r, nodes, device):
    dev = resolve_device(device)
    dt = torch.complex128
    A = as_tensor(A, dt, dev)
    B = None if B is None else as_tensor(B, dt, dev)
    X = as_tensor(X0, dt, dev)
    validate_dims(A, B, X)
    if contour is None:
        contour = ct.circular_contour_trapezoidal(complex(c), float(r), int(nodes))
    return A, B, X, contour, contour.device_nodes(dt, dev), contour.device_weights(dt, dev)


def _resolve_tol(tol: float, tol_mode: str, contour) -> float:
    """"abs": absolute residuals; "contour": tol * max(max|z|, 1)."""
    if tol_mode == "abs":
        return float(tol)
    if tol_mode == "contour":
        return float(tol) * max(contour.spectral_scale, 1.0)
    raise ValueError(f"unknown tol_mode {tol_mode!r} (abs|contour)")


def _in_mask(lam: torch.Tensor, kind: str, params) -> torch.Tensor:
    if kind not in ("circle", "rect", "ellipse"):
        raise ValueError("feast drivers need a circle/rect/ellipse contour")
    return ct.in_region(lam, kind, params)


def _resolvent(wi: torch.Tensor, zi: torch.Tensor, lam: torch.Tensor):
    """w_i / (z_i - lam) with a relative floor on the denominator (a Ritz
    value exactly on a node gives a huge-but-finite term, not NaN).
    Broadcasts: (N, 1) nodes against (m0,) values give (N, m0)."""
    den = zi - lam
    eps = torch.finfo(cx.real_dtype(lam.dtype)).eps
    floor = eps * torch.clamp(cx.cabs(zi), min=1.0)
    safe = torch.where(cx.abs2(den) >= floor * floor, den, floor.to(den.dtype))
    return cx.cdiv(wi.expand_as(safe), safe)


def _shifted_single(A, B, zi):
    """S = A - z B for one node (B=None means the identity)."""
    if B is None:
        S = A.clone()
        S.diagonal().sub_(zi)
        return S
    return A - zi * B


def _factor_scan(A, B, z, solve_f32: bool):
    """Factor every node matrix A - z_i B, stacked on a leading node axis,
    plus the diagonal-block inverses for the repeated solves.  Each node
    matrix is formed in complex128 and cast, as in the JAX package."""
    n = A.shape[0]
    sblock = 512 if n > 4096 else lumod._auto_block(n)
    dt = torch.complex64 if solve_f32 else A.dtype
    S = torch.empty((z.shape[0], n, n), dtype=dt, device=A.device)
    for i in range(z.shape[0]):
        S[i] = _shifted_single(A, B, z[i])
    LU, perm = lumod.lu_factor(S)
    del S
    return LU, perm, lumod.lu_diag_inv(LU, sblock)


def _apply_op_batch(A, B, T, z):
    """S_i T_i = (A - z_i B) T_i for node-stacked T (N, n, m0), as one wide
    matmul A [T_1 | ... | T_N] minus the per-node shift."""
    k, n, m0 = T.shape
    flat = T.permute(1, 0, 2).reshape(n, k * m0)
    AT = (A @ flat).reshape(n, k, m0).permute(1, 0, 2)
    BT = T if B is None else (B @ flat).reshape(n, k, m0).permute(1, 0, 2)
    return AT - z[:, None, None] * BT


def _node_update_scan(LUb, permb, z, w, X, R, lam, solve_dtype, A, B,
                      refine: int = 2, dinvb=None):
    """RII update over all nodes at once.  Mixed precision: complex64
    solves, then `refine` steps of complex128 iterative refinement whose
    residuals R - S_i T_i are one wide matmul (`_apply_op_batch`)."""
    mixed = solve_dtype is not None and solve_dtype != R.dtype
    temps = lumod.lu_solve(LUb, permb, R.to(solve_dtype) if mixed else R,
                           dinv=dinvb)
    if mixed:
        temps = temps.to(X.dtype)
        for _ in range(refine):
            resid = R[None] - _apply_op_batch(A, B, temps, z)
            temps = temps + lumod.lu_solve(LUb, permb, resid.to(solve_dtype),
                                           dinv=dinvb).to(X.dtype)
    phi = _resolvent(w[:, None], z[:, None], lam[None, :])      # (N, m0)
    return torch.sum((X[None] - temps) * phi[:, None, :], dim=0)


def _rayleigh_ritz(Q, A, B, pencil: str = "lu"):
    """Orthonormal-basis Rayleigh-Ritz: (lam, X, R, res).  pencil="qz"
    solves the projected pencil by QZ instead of the B^{-1} A reduction."""
    if pencil not in ("lu", "qz"):
        _unported(f'pencil="{pencil}"')
    Aq = cx.cgram(Q, A @ Q)
    if B is None:
        lam, Xq = eigmod.eig(Aq)
    elif pencil == "qz":
        from ..ops import qz as qzmod

        alpha, beta, Xq = qzmod.gen_eig_qz(Aq, cx.cgram(Q, B @ Q))
        lam = cx.cdiv(alpha, beta)
    else:
        lam, Xq = eigmod.gen_eig(Aq, cx.cgram(Q, B @ Q))
    X = cx.normalize_cols(Q @ Xq)
    BX = X if B is None else B @ X
    R = A @ X - cx.scale_cols(BX, lam)
    return lam, X, R, cx.col_norms(R)


def _check_unported(mesh=None, rr="device", node_loop=None, pencil="lu"):
    if mesh is not None:
        _unported("mesh (node sharding across devices)")
    if node_loop:
        _unported("node_loop=True")
    if rr != "device":
        _unported(f'rr="{rr}"')
    if pencil not in ("lu", "qz"):
        _unported(f'pencil="{pencil}"')


def feast(A, X0, contour: Optional[ct.Contour] = None, *,
          c: complex = 0.0 + 0.0j, r: float = 1.0, nodes: int = 8,
          iters: int = 10, tol: float = 1e-12, store: bool = True,
          mixed_prec: bool = False, ortho: str = "cholqr2",
          block: int = 64, debug: bool = False, mesh=None, rr: str = "device",
          hermitian: bool = False, node_scan: Optional[bool] = None,
          node_loop: Optional[bool] = None, tol_mode: str = "abs",
          callback: Optional[Callable] = None,
          device="cuda") -> FeastResult:
    """Standard linear FEAST: eigenpairs of A inside the contour.

    X0 (n, m0) spans the search subspace (a previous X warm-restarts).
    numpy inputs are moved to `device` (default "cuda"; raises when CUDA
    is absent, pass "cpu" for the plain path)."""
    return _drive(A, None, X0, contour, c, r, nodes, iters, tol, store,
                  mixed_prec, ortho, debug, callback, mesh, rr,
                  "hermitian" if hermitian else "lu", node_loop, tol_mode,
                  device)


def gen_feast(A, B, X0, contour: Optional[ct.Contour] = None, *,
              c: complex = 0.0 + 0.0j, r: float = 1.0, nodes: int = 8,
              iters: int = 10, tol: float = 1e-12, store: bool = True,
              mixed_prec: bool = False, ortho: str = "cholqr2",
              block: int = 64, debug: bool = False, mesh=None,
              rr: str = "device", pencil: str = "lu",
              node_scan: Optional[bool] = None,
              node_loop: Optional[bool] = None, tol_mode: str = "abs",
              callback: Optional[Callable] = None,
              device="cuda") -> FeastResult:
    """Generalized linear FEAST: A x = lam B x inside the contour."""
    if B is None:
        raise ValueError("gen_feast requires B; use feast() for B=I")
    return _drive(A, B, X0, contour, c, r, nodes, iters, tol, store,
                  mixed_prec, ortho, debug, callback, mesh, rr, pencil,
                  node_loop, tol_mode, device)


def dual_gen_feast(*args, **kwargs):
    """Two-sided generalized FEAST: not ported yet."""
    _unported("dual_gen_feast")


def _drive(A, B, X0, contour, c, r, nodes, iters, tol, store, mixed_prec,
           ortho, debug, callback, mesh, rr, pencil, node_loop, tol_mode,
           device) -> FeastResult:
    _check_unported(mesh, rr, node_loop, pencil)
    A, B, Q, contour, z, w = _prepare(A, B, X0, contour, c, r, nodes, device)
    tol = _resolve_tol(tol, tol_mode, contour)
    solve_dtype = torch.complex64 if mixed_prec else None
    if store:
        LUb, permb, dinvb = _factor_scan(A, B, z, bool(mixed_prec))
    lam = X = res = inside = None
    n_iter, converged = 0, False
    for nit in range(iters + 1):
        n_iter = nit
        Qo = qrmod.orthonormalize(Q, method=ortho)
        lam, X, R, res = _rayleigh_ritz(Qo, A, B, pencil)
        inside = _in_mask(lam, contour.kind, contour.params)
        res_h, inside_h = res.cpu().numpy(), inside.cpu().numpy()
        if debug:
            _debug_print(nit, res_h, inside_h)
        if callback is not None:
            callback(nit, lam, res_h, inside_h)
        if inside_h.any() and res_h[inside_h].max() < tol:
            converged = True
            break
        if nit == iters:
            break  # the reference skips the final update too
        if not store:
            LUb, permb, dinvb = _factor_scan(A, B, z, bool(mixed_prec))
        Q = _node_update_scan(LUb, permb, z, w, X, R, lam, solve_dtype, A, B,
                              dinvb=dinvb)
    if not inside.any():
        print("no eigenvalues found in contour!")
    return FeastResult(lam, X, res, inside, n_iter, converged)


def _debug_print(nit, res, inside, spurious_tol=1e-5):
    """Per-iteration count inside / non-spurious and max residuals."""
    n_in = int(inside.sum())
    if n_in:
        res_in = res[inside]
        non_spur = res_in < spurious_tol
        best = res_in[non_spur].max() if non_spur.any() else float("nan")
        print(f"{nit}: {n_in} ({int(non_spur.sum())}) {res_in.max():.3e} ({best:.3e})")
    else:
        print(f"{nit}: 0 inside")


def feast_compiled(A, X0, contour: Optional[ct.Contour] = None, *,
                   c: complex = 0.0 + 0.0j, r: float = 1.0, nodes: int = 8,
                   iters: int = 10, tol: float = 1e-12,
                   ortho: str = "cholqr2", B=None, mesh=None,
                   mixed_prec: bool = False, pencil: str = "lu",
                   hermitian: bool = False,
                   node_scan: Optional[bool] = None,
                   two_tier: Optional[bool] = None,
                   tol_mode: str = "abs", device="cuda") -> FeastResult:
    """feast/gen_feast (store=True) with the convergence test of the JAX
    package's single-jit loop, and its two tiers.

    two_tier (default on with mixed_prec): a coarse all-complex64 loop
    (orthonormalization, Rayleigh-Ritz, plain complex64 solves, no
    refinement) runs while its worst inside residual at least halves per
    sweep and stays above 2 eps32 ||A||_F / sqrt(n); its subspace then
    seeds the complex128 loop, which alone sets the final accuracy."""
    if hermitian:
        pencil = "hermitian"
    _check_unported(mesh, "device", None, pencil)
    A, B, Q, contour, z, w = _prepare(A, B, X0, contour, c, r, nodes, device)
    tol = _resolve_tol(tol, tol_mode, contour)
    mixed = bool(mixed_prec)
    LUb, permb, dinvb = _factor_scan(A, B, z, mixed)
    if two_tier is None:
        two_tier = mixed
    kind, params = contour.kind, contour.params
    n, m0 = Q.shape
    it = 0
    if two_tier and mixed:
        f32 = torch.complex64
        A32 = A.to(f32)
        B32 = None if B is None else B.to(f32)
        z32, w32 = z.to(f32), w.to(f32)
        floor32 = 2.0 * torch.finfo(torch.float32).eps * float(cx.fro_norm(A32)) / np.sqrt(n)
        Qc, prev, c_it, stop = Q.to(f32), np.inf, 0, False
        while not stop and c_it < iters:
            Qo = qrmod.orthonormalize(Qc, method=ortho)
            lam, X, R, res = _rayleigh_ritz(Qo, A32, B32, pencil)
            inside = _in_mask(lam, kind, params)
            worst = float(torch.max(torch.where(inside, res, 0.0)))
            any_in = bool(inside.any())
            stop = ((c_it > 0 and worst > 0.5 * prev)
                    or (any_in and worst <= floor32)
                    or (c_it > 1 and not any_in))
            Qc = Qo if stop else _node_update_scan(
                LUb, permb, z32, w32, X, R, lam, None, A32, B32, refine=0,
                dinvb=dinvb)
            prev = worst
            c_it += 1
        Q = Qc.to(A.dtype)
        it = max(c_it - 1, 0)  # the stopping sweep did no update
    solve_dtype = torch.complex64 if mixed else None
    lam = torch.zeros(m0, dtype=Q.dtype, device=Q.device)
    X = torch.zeros((n, m0), dtype=Q.dtype, device=Q.device)
    res = torch.zeros(m0, dtype=torch.float64, device=Q.device)
    inside = torch.zeros(m0, dtype=torch.bool, device=Q.device)
    done = False
    while not done and it <= iters:
        Qo = qrmod.orthonormalize(Q, method=ortho)
        lam, X, R, res = _rayleigh_ritz(Qo, A, B, pencil)
        inside = _in_mask(lam, kind, params)
        worst = float(torch.max(torch.where(inside, res, 0.0)))
        done = bool(inside.any()) and worst < tol
        if not done and it < iters:  # the last allowed sweep's update is dead
            Q = _node_update_scan(LUb, permb, z, w, X, R, lam, solve_dtype,
                                  A, B, dinvb=dinvb)
        it += 1
    return FeastResult(lam, X, res, inside, it, done)
