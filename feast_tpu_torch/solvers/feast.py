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

`feast_compiled` is the JAX package's single-program loop, one sweep
program (`_SweepProgram`) with the stop rules and the eig guard decided on
the device: on the card its sweeps are CUDA graphs, captured once per
signature and replayed (under `mesh=` the node all-reduce is a graph of
its own after the update's); the CPU and the options `_graph_scope` names
run the same steps eagerly.  The sweep steps take a leading slice axis
too, which `parallel/slicing.py`'s stacked-slice program runs.

`pencil="hermitian"` (and `hermitian=True`) reduces through the complex
`torch.linalg.eigh` (`ops/eigh.py`); `rr="host"` solves the m0 x m0
reduced problem with LAPACK on the host (the code `feast_iterative`'s host
Rayleigh-Ritz shares); `node_loop=True` keeps each node's factor as its own
buffer (on the card, one panel-kernel launch of batch one per panel and
node) and composes the per-node solves on the host; `dual_gen_feast` is
the two-sided driver.

Differences kept on purpose: `node_loop=None` stays the stacked path at
every size.  The JAX package switches to the node loop once the stacked
factor store passes 6 GB and drops `store` above 9 GB, thresholds sized
for a 16 GB TPU; the card's 80 GB holds the stacked store of every size
those served.  `node_scan` only chose a memory layout in the JAX package;
the batched layout here serves every size it did, so the flag is accepted
and has no effect.

`mesh=` (a `torch.distributed` DeviceMesh with a "node" dimension,
`parallel.node_mesh`) gives each rank nodes / ranks of the contour nodes:
it factors them (on the card, K1 with that batch), forms their share of
the resolvent-weighted node sum, and one all-reduce over "node" gives the
moment block (span "feast.node_sum", with the tier, the payload's `bytes`
and the `ranks`).  Every rank repeats the Rayleigh-Ritz phase (K2 seed on
the card), so every rank returns the same result.  X0 is broadcast from rank
0; A and B are the caller's on every rank.
"""

from __future__ import annotations

import inspect
import math
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import contour as ct
from .. import cx
from .._device import as_tensor, resolve_device
from ..ops import eig as eigmod
from ..ops import eigh as eighmod
from ..ops import lu as lumod
from ..ops import qr as qrmod
from ..kernels import _build
from ..utils import tracing


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


def _prepare(A, B, X0, contour, c, r, nodes, device, mesh=None):
    """Inputs on the device, the contour and its nodes and weights, and the
    node-sum reduction: under `mesh` this rank's share of the nodes and X0
    as rank 0 holds it."""
    dt = torch.complex128
    if mesh is None:
        dev = resolve_device(device)
    else:
        from ..parallel import mesh as pmesh

        dev = pmesh.mesh_device(mesh, device)
    A = as_tensor(A, dt, dev)
    B = None if B is None else as_tensor(B, dt, dev)
    X = as_tensor(X0, dt, dev)
    validate_dims(A, B, X)
    if contour is None:
        contour = ct.circular_contour_trapezoidal(complex(c), float(r), int(nodes))
    z, w = contour.device_nodes(dt, dev), contour.device_weights(dt, dev)
    if mesh is None:
        return A, B, X, contour, z, w, lambda Q: Q
    X = pmesh.replicate(X, mesh)
    return (A, B, X, contour, pmesh.shard_nodes(z, mesh), pmesh.shard_nodes(w, mesh),
            lambda Q: pmesh.node_sum(Q, mesh))


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


@tracing.spanned("feast.factor", "A", attrs=lambda A, B, z, solve_f32: {"nodes": z.shape[0]})
def _factor_scan(A, B, z, solve_f32: bool):
    """Factor every node matrix A - z_i B, stacked on a leading node axis,
    plus the diagonal-block inverses for the repeated solves, in a
    `lumod.factor_buffer` of its own (`_factor_into`): LU is a view of that
    buffer, and the node matrices are never held twice.  Span:
    "feast.factor" (with `nodes`, the node matrices this rank factors)
    around `_factor_into`'s."""
    dt = torch.complex64 if solve_f32 else A.dtype
    return _factor_into(lumod.factor_buffer(z.shape, A.shape[0], dt, A.device), A, B, z)


def _factor_into(buf, A, B, z):
    """The node matrices A - z_i B factored in `buf`, a `lumod.factor_buffer`
    of z's length: each formed in complex128 and cast into the buffer, as
    in the JAX package, then factored in place.  Returns (LU, a view of
    `buf`; perm; the diagonal-block inverses).  A padded buffer may be
    factored again: a factor leaves its padding zero.
    Spans: "feast.factor.form" (the node matrices), "feast.factor.lu" (with
    the row swaps' `moved_rows` and `gathered_rows` on the kernel route,
    `lumod.lu_factor_inplace`) and "feast.factor.diag_inv" (with `blocks`
    and `kernel_blocks`, `lumod.lu_diag_inv`)."""
    n = A.shape[0]
    with tracing.span("feast.factor.form", A.device):
        for i in range(z.shape[0]):
            buf[i, :n, :n] = _shifted_single(A, B, z[i])
    with tracing.span("feast.factor.lu", A.device) as sp:
        LU, perm = lumod.lu_factor_inplace(buf, n, span=sp)
    with tracing.span("feast.factor.diag_inv", A.device) as sp:
        dinv = lumod.lu_diag_inv(LU, lumod._solve_block(n), span=sp)
    return LU, perm, dinv


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
    residuals R - S_i T_i are one wide matmul (`_apply_op_batch`).

    Stacked slices: X, R (S, n, m0), lam (S, m0) and z, w (S, N) against
    slice-major factors (S N, n, n); every solve is one batch over the
    S N nodes, every refinement residual one matmul over S N m0 columns,
    and each slice sums its own N nodes."""
    mixed = solve_dtype is not None and solve_dtype != R.dtype
    if R.dim() > 2:
        R = R[:, None].expand(z.shape + R.shape[-2:]).reshape((-1,) + R.shape[-2:])
    zf = z.reshape(-1)
    temps = lumod.lu_solve(LUb, permb, R.to(solve_dtype) if mixed else R,
                           dinv=dinvb)
    if mixed:
        temps = temps.to(X.dtype)
        for _ in range(refine):
            resid = R - _apply_op_batch(A, B, temps, zf)
            temps = temps + lumod.lu_solve(LUb, permb, resid.to(solve_dtype),
                                           dinv=dinvb).to(X.dtype)
    return _accum_update(X, temps.reshape(z.shape + temps.shape[-2:]), z, w, lam)


def _hermitize(M: torch.Tensor) -> torch.Tensor:
    return (M + M.mH) / 2


def _reduced_eig(Aq, Bq, pencil: str):
    """Eigenpairs (lam, Xq) of the m0 x m0 reduced problem on the device.

    pencil: "lu" reduces Bq^{-1} Aq; "qz" runs the QZ iteration (robust to
    singular or indefinite Bq); "hermitian" takes Aq Hermitian and Bq
    Hermitian positive definite: with Bq = L L^H, the eigenpairs of
    L^{-1} Aq L^{-H} by eigh, then Xq = L^{-H} Y."""
    if pencil == "hermitian":        # eigh_cx hermitizes its argument
        if Bq is None:
            wr, Xq = eighmod.eigh_cx(Aq)
        else:
            L = qrmod.cholesky(_hermitize(Bq))
            Ct = qrmod.solve_lower(L, _hermitize(Aq))         # L^-1 Aq
            C = qrmod.solve_lower(L, Ct.mH).mH                # L^-1 Aq L^-H
            wr, Y = eighmod.eigh_cx(C)
            Xq = qrmod.solve_upper(L.mH.resolve_conj(), Y)    # L^-H Y
        return wr.to(Aq.dtype), Xq
    if Bq is None:
        return eigmod.eig(Aq)
    if pencil == "qz":
        from ..ops import qz as qzmod

        alpha, beta, Xq = qzmod.gen_eig_qz(Aq, Bq)
        return cx.cdiv(alpha, beta), Xq
    if pencil == "lu":
        return eigmod.gen_eig(Aq, Bq)
    raise ValueError(f"unknown pencil {pencil!r} (lu|qz|hermitian)")


def _host_eig(a: np.ndarray, b=None, pencil: str = "lu"):
    """m0 x m0 reduced eig with host LAPACK on numpy arrays: (lam, V).

    "hermitian" runs (z)heev / (z)hegv on the hermitized matrices; "lu" and
    "qz" both run (z)geev / (z)ggev (ggev is the QZ algorithm).  Shared by
    the dense drivers' and `feast_iterative`'s rr="host"."""
    import scipy.linalg as sla

    if pencil == "hermitian":
        lam, V = sla.eigh((a + a.conj().T) / 2,
                          None if b is None else (b + b.conj().T) / 2)
        return lam.astype(np.complex128), V
    return sla.eig(a) if b is None else sla.eig(a, b)


def _ritz_pairs(Qo, A, B, lam, Xq):
    """Ritz pairs of the orthonormal basis Qo from the reduced eigenpairs
    (lam, Xq): (lam, X, R, res), X with unit columns, R the residual block."""
    X = cx.normalize_cols(Qo @ Xq)
    BX = X if B is None else B @ X
    R = A @ X - cx.scale_cols(BX, lam)
    return lam, X, R, cx.col_norms(R)


def _rayleigh_ritz(Q, A, B, pencil: str = "lu"):
    """Orthonormal-basis Rayleigh-Ritz: (lam, X, R, res); see `_reduced_eig`
    for the pencil strategies."""
    Bq = None if B is None else cx.cgram(Q, B @ Q)
    return _ritz_pairs(Q, A, B, *_reduced_eig(cx.cgram(Q, A @ Q), Bq, pencil))


def _rr_full(Q, A, B, ortho: str, pencil: str, kind: str, params, rr: str):
    """Orthonormalize, then Rayleigh-Ritz with the reduced eig on the device
    (rr="device") or in host LAPACK (rr="host": only the m0 x m0 matrices
    cross); returns (lam, X, R, res, inside)."""
    Qo = qrmod.orthonormalize(Q, method=ortho)
    if rr == "device":
        lam, X, R, res = _rayleigh_ritz(Qo, A, B, pencil)
    elif rr == "host":
        Aq = cx.cgram(Qo, A @ Qo).cpu().numpy()
        Bq = None if B is None else cx.cgram(Qo, B @ Qo).cpu().numpy()
        lam, V = _host_eig(Aq, Bq, pencil)
        lam, X, R, res = _ritz_pairs(
            Qo, A, B, torch.as_tensor(lam, dtype=Q.dtype, device=Q.device),
            torch.as_tensor(V, dtype=Q.dtype, device=Q.device))
    else:
        raise ValueError(f"unknown rr {rr!r} (device|host)")
    return lam, X, R, res, _in_mask(lam, kind, params)


# ---------------------------------------------------------------------------
# host-composed per-node pipeline (node_loop=True): every node's factor is
# its own buffer, never stacked on a node axis
# ---------------------------------------------------------------------------

def _factor_one(A, B, zi, solve_f32: bool, sblock: int):
    """(LU, perm, diagonal-block inverses) of one node matrix A - z_i B,
    formed in complex128 and cast as in `_factor_scan`; on the card a
    complex64 factor is the panel kernel with a batch of one."""
    Si = _shifted_single(A, B, zi)
    LU, perm = lumod.lu_factor(Si.to(torch.complex64) if solve_f32 else Si)
    return LU, perm, lumod.lu_diag_inv(LU, sblock)


def _factor_hostloop(A, B, z, solve_f32: bool):
    """Per-node factors as a list of separate buffers."""
    sblock = lumod._solve_block(A.shape[0])
    return [_factor_one(A, B, z[i], solve_f32, sblock) for i in range(z.shape[0])]


def _solve_one(LU, perm, dinv, rhs, out_dtype=None):
    out = lumod.lu_solve(LU, perm, rhs, dinv=dinv)
    return out if out_dtype is None else out.to(out_dtype)


def _solve_corr_one(LU, perm, dinv, resid_i, temp_i, solve_dtype):
    """temp_i plus the solve_dtype correction S_i^{-1} resid_i."""
    corr = lumod.lu_solve(LU, perm, resid_i.to(solve_dtype), dinv=dinv)
    return temp_i + corr.to(temp_i.dtype)


def _ir_resid_split(A, B, T, z, R):
    """Refinement residuals R - S_i T_i as one wide product over the
    node-stacked T, returned as per-node (n, m0) blocks."""
    return list(R[None] - _apply_op_batch(A, B, T, z))


def _accum_update(X, T, z, w, lam):
    """sum_i (X - T_i) diag(w_i / (z_i - lam)), over leading slice dims:
    X (..., n, m0), T (..., N, n, m0), z, w (..., N), lam (..., m0)."""
    phi = _resolvent(w[..., :, None], z[..., :, None], lam[..., None, :])  # (..., N, m0)
    return torch.sum((X[..., None, :, :] - T) * phi[..., :, None, :], dim=-3)


def _node_update_hostloop(facts, z, w, X, R, lam, solve_dtype, A, B,
                          refine: int = 2):
    """RII update over per-node factor buffers: per-node solves, each
    refinement residual one wide complex128 product (`_ir_resid_split`)."""
    mixed = solve_dtype is not None and solve_dtype != R.dtype
    R_s = R.to(solve_dtype) if mixed else R
    temps = [_solve_one(LU, perm, dinv, R_s, out_dtype=X.dtype)
             for LU, perm, dinv in facts]
    if mixed:
        for _ in range(refine):
            resid = _ir_resid_split(A, B, torch.stack(temps), z, R)
            temps = [_solve_corr_one(LU, perm, dinv, ri, ti, solve_dtype)
                     for (LU, perm, dinv), ri, ti in zip(facts, resid, temps)]
    return _accum_update(X, torch.stack(temps), z, w, lam)


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


def _drive(A, B, X0, contour, c, r, nodes, iters, tol, store, mixed_prec,
           ortho, debug, callback, mesh, rr, pencil, node_loop, tol_mode,
           device) -> FeastResult:
    A, B, Q, contour, z, w, node_sum = _prepare(A, B, X0, contour, c, r, nodes,
                                                device, mesh)
    tol = _resolve_tol(tol, tol_mode, contour)
    solve_f32 = bool(mixed_prec)
    solve_dtype = torch.complex64 if solve_f32 else None

    def factor():
        if node_loop:
            return _factor_hostloop(A, B, z, solve_f32)
        return _factor_scan(A, B, z, solve_f32)

    if store:
        facts = factor()
    lam = X = res = inside = None
    n_iter, converged = 0, False
    for nit in range(iters + 1):
        n_iter = nit
        lam, X, R, res, inside = _rr_full(Q, A, B, ortho, pencil, contour.kind,
                                          contour.params, rr)
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
            facts = factor()
        if node_loop:
            Q = _node_update_hostloop(facts, z, w, X, R, lam, solve_dtype, A, B)
        else:
            LUb, permb, dinvb = facts
            Q = _node_update_scan(LUb, permb, z, w, X, R, lam, solve_dtype,
                                  A, B, dinvb=dinvb)
        Q = node_sum(Q)
    if not inside.any():
        print("no eigenvalues found in contour!")
    return FeastResult(lam, X, res, inside, n_iter, converged)


# ---------------------------------------------------------------------------
# two-sided FEAST
# ---------------------------------------------------------------------------

class DualFeastResult(NamedTuple):
    lam: torch.Tensor      # (m0,) Ritz values
    Xr: torch.Tensor       # (n, m0) right Ritz vectors (unit columns)
    Xl: torch.Tensor       # (n, m0) left Ritz vectors, y^H A = lam y^H B
    res: torch.Tensor      # (m0,) right residual norms
    inside: torch.Tensor   # (m0,) bool
    n_iter: int
    converged: bool

    def filtered(self):
        """Host numpy (lam, Xr, Xl, res) restricted to the contour."""
        mask = self.inside.cpu().numpy()
        return (self.lam.cpu().numpy()[mask], self.Xr.cpu().numpy()[:, mask],
                self.Xl.cpu().numpy()[:, mask], self.res.cpu().numpy()[mask])


def _dual_pre(Qr, Ql, A, B):
    """Bi-orthonormalize and build the oblique reduced pencil: from the SVD
    U S V^H of Ql^H B Qr, Qr V S^{-1/2} and Ql U S^{-1/2} give
    Ql^H B Qr = I.  Returns (Qr, Ql, Aq, Bq)."""
    from ..ops import svd as svdmod

    U, s, Vh = svdmod.svd(cx.cgram(Ql, B @ Qr))
    eps = torch.finfo(s.dtype).eps
    s_inv_sqrt = (1.0 / torch.sqrt(torch.clamp(s, min=eps * max(float(s[0]), 1.0)))
                  ).to(Qr.dtype)
    Qr = cx.scale_cols(Qr @ Vh.mH, s_inv_sqrt)
    Ql = cx.scale_cols(Ql @ U, s_inv_sqrt)
    return Qr, Ql, cx.cgram(Ql, A @ Qr), cx.cgram(Ql, B @ Qr)


def _dual_post(Qr, Ql, A, B, AH, BH, Bq, lam, Xq, kind: str, params):
    """Ritz recovery and residuals of both sides: (lam, Xr, Xl, Rr, Rl,
    res, inside).  The left reduced vectors paired with lam: W^H Aq =
    lam W^H Bq has the closed form W = Bq^{-H} (Xq^{-1})^H."""
    m0 = Xq.shape[0]
    Xq_inv = lumod.solve(Xq, torch.eye(m0, dtype=Xq.dtype, device=Xq.device))
    LUbq, permbq = lumod.lu_factor(Bq.mH.resolve_conj())
    Xql = lumod.lu_solve(LUbq, permbq, Xq_inv.mH.resolve_conj())
    Xr = cx.normalize_cols(Qr @ Xq)
    Xl = cx.normalize_cols(Ql @ Xql)
    Rr = A @ Xr - cx.scale_cols(B @ Xr, lam)
    Rl = AH @ Xl - cx.scale_cols(BH @ Xl, lam.conj())
    return lam, Xr, Xl, Rr, Rl, cx.col_norms(Rr), _in_mask(lam, kind, params)


def _dual_update(facts_r, facts_l, z, w, Xr, Xl, Rr, Rl, lam, solve_dtype,
                 A, B, AH, BH):
    """The two-sided node update; the left one runs on the adjoint
    S_i^H = A^H - conj(z_i) B^H with conjugated weights and Ritz values."""
    Qr = _node_update_scan(*facts_r[:2], z, w, Xr, Rr, lam, solve_dtype,
                           A, B, dinvb=facts_r[2])
    Ql = _node_update_scan(*facts_l[:2], z.conj(), w.conj(), Xl, Rl,
                           lam.conj(), solve_dtype, AH, BH, dinvb=facts_l[2])
    return Qr, Ql


def dual_gen_feast(A, B, Xr0, Xl0, contour: Optional[ct.Contour] = None, *,
                   c: complex = 0.0 + 0.0j, r: float = 1.0, nodes: int = 8,
                   iters: int = 10, tol: float = 1e-12, store: bool = True,
                   mixed_prec: bool = False, rr: str = "device", mesh=None,
                   tol_mode: str = "abs", debug: bool = False,
                   device="cuda") -> DualFeastResult:
    """Two-sided generalized FEAST: refines right and left subspaces, with
    node solves on A - z B and on its adjoint (two factor sets, twice the
    solve cost), and an SVD bi-orthonormalization every sweep.

    store=False refactors both sets every sweep; mixed_prec factors them in
    complex64 (the panel kernel on the card) with complex128 iterative
    refinement; rr="host" solves the m0 x m0 oblique pencil with host
    LAPACK."""
    A, B, Qr, contour, z, w, node_sum = _prepare(A, B, Xr0, contour, c, r, nodes,
                                                 device, mesh)
    if B is None:
        raise ValueError("dual_gen_feast requires B")
    tol = _resolve_tol(tol, tol_mode, contour)
    Ql = as_tensor(Xl0, Qr.dtype, Qr.device)
    if mesh is not None:
        from ..parallel import mesh as pmesh

        Ql = pmesh.replicate(Ql, mesh)
    validate_dims(A, B, Ql, "dual_gen_feast(left)")
    solve_f32 = bool(mixed_prec)
    solve_dtype = torch.complex64 if solve_f32 else None
    AH, BH = A.mH.resolve_conj().contiguous(), B.mH.resolve_conj().contiguous()

    def factor():
        return (_factor_scan(A, B, z, solve_f32),
                _factor_scan(AH, BH, z.conj(), solve_f32))

    if store:
        facts_r, facts_l = factor()
    lam = Xr = Xl = res = inside = None
    n_iter, converged = 0, False
    for nit in range(iters + 1):
        n_iter = nit
        Qrb, Qlb, Aq, Bq = _dual_pre(Qr, Ql, A, B)
        if rr == "host":
            lam_h, V_h = _host_eig(Aq.cpu().numpy(), Bq.cpu().numpy())
            lam_i = torch.as_tensor(lam_h, dtype=Aq.dtype, device=Aq.device)
            Xq_i = torch.as_tensor(V_h, dtype=Aq.dtype, device=Aq.device)
        elif rr == "device":
            lam_i, Xq_i = eigmod.gen_eig(Aq, Bq)
        else:
            raise ValueError(f"unknown rr {rr!r} (device|host)")
        lam, Xr, Xl, Rr, Rl, res, inside = _dual_post(
            Qrb, Qlb, A, B, AH, BH, Bq, lam_i, Xq_i, contour.kind, contour.params)
        res_h, inside_h = res.cpu().numpy(), inside.cpu().numpy()
        if debug:
            _debug_print(nit, res_h, inside_h)
        if inside_h.any() and res_h[inside_h].max() < tol:
            converged = True
            break
        if nit == iters:
            break  # the last allowed sweep's update is dead
        if not store:
            facts_r, facts_l = factor()
        Qr, Ql = map(node_sum, _dual_update(facts_r, facts_l, z, w, Xr, Xl, Rr,
                                            Rl, lam, solve_dtype, A, B, AH, BH))
    if not inside.any():
        print("no eigenvalues found in contour!")
    return DualFeastResult(lam, Xr, Xl, res, inside, n_iter, converged)


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




# ---------------------------------------------------------------------------
# feast_compiled: the JAX package's single-program loop
# ---------------------------------------------------------------------------

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
    seeds the complex128 loop, which alone sets the final accuracy.

    On the card the loop is the JAX package's one compiled program: each
    tier's sweep is two steps, the Rayleigh-Ritz step with the tier's stop
    flag and the eig guard (`_rr_step`) and the node update, each captured
    once as a CUDA graph and replayed (`_SweepProgram`).  The host reads one
    status tensor a sweep where JAX reads none; where the mixed eig's guard
    fails it runs that sweep's Rayleigh-Ritz again with the full eig (JAX's
    lax.cond), and it replays no update for the sweep that stops.  Under
    mesh= the node all-reduce is captured as a graph of its own, replayed
    after each update's.  The program and its graphs are cached for the
    newest signature only (`_program_key`), and hold a copy of the factor
    store.
    Options whose sweep reads the host run the same program's steps
    eagerly, by the rule of `_graph_scope` (the CPU, pencils "qz" and
    "hermitian", an m0 outside 2..128, eig mode "full", Schur backend
    "torch"); a failure inside a capture raises."""
    return _compiled(True, A, X0, contour, c=c, r=r, nodes=nodes, iters=iters,
                     tol=tol, ortho=ortho, B=B, mesh=mesh, mixed_prec=mixed_prec,
                     pencil=pencil, hermitian=hermitian, node_scan=node_scan,
                     two_tier=two_tier, tol_mode=tol_mode, device=device)


def _feast_compiled_steps(*args, **kw) -> FeastResult:
    """`feast_compiled` with its sweep program run eagerly on any device:
    the steps, static buffers and cache of the graphed path, without
    graphs (mesh= too, its all-reduce a step after each update).  Card
    tests hold the graphs to it."""
    return _compiled(False, **_bind(args, kw))


def _bind(args, kw) -> dict:
    bound = inspect.signature(feast_compiled).bind(*args, **kw)
    bound.apply_defaults()
    return bound.arguments


def _graph_scope(device: torch.device, m0: int, pencil: str) -> Optional[str]:
    """None where `feast_compiled` (and `feast_sliced_parallel`, pencil
    "lu") captures its sweeps as CUDA graphs, else why it runs their steps
    eagerly.  This rule decides, never a caught capture error.  mesh= is no
    reason: the dense drivers' one collective a sweep is the node sum, an
    NCCL all-reduce, which a graph of its own holds.
      - off the card there is nothing to capture;
      - pencil "qz": ops/qz.py decides its deflations on the host;
      - pencil "hermitian": torch.linalg.eigh checks its info on the host;
      - m0 outside 2..128, eig mode "full" or Schur backend "torch": the
        reduced eig is the plain Schur iteration, whose sweeps the host
        counts."""
    if device.type != "cuda":
        return "the CPU has no graphs"
    if pencil != "lu":
        return f"pencil {pencil!r} reads the host in its reduced eig"
    if eigmod._SCHUR_BACKEND != "cuda" or not eigmod._mixed_route(torch.complex128, m0,
                                                                 device):
        return (f"the reduced eig at m0={m0} (eig mode {eigmod._EIG_MODE!r}, Schur "
                f"backend {eigmod._SCHUR_BACKEND!r}) is the plain Schur iteration")
    return None


@tracing.spanned("feast.solve", "device")
def _compiled(graphs, A, X0, contour, *, c, r, nodes, iters, tol, ortho, B, mesh,
              mixed_prec, pencil, hermitian, node_scan, two_tier, tol_mode,
              device) -> FeastResult:
    """The sweep program of the solve's signature, its steps captured as
    CUDA graphs where `graphs` is true and `_graph_scope` allows, else run
    eagerly.  The span "feast.solve" is the root of the solve's spans."""
    if hermitian:
        pencil = "hermitian"
    A, B, Q, contour, z, w, _ = _prepare(A, B, X0, contour, c, r, nodes, device, mesh)
    tol = _resolve_tol(tol, tol_mode, contour)
    mixed = bool(mixed_prec)
    two_tier = mixed and (two_tier is None or bool(two_tier))
    iters = int(iters)
    graphs = graphs and _graph_scope(Q.device, Q.shape[1], pencil) is None
    group = None if mesh is None else mesh.get_group("node")
    LUb, permb, dinvb = _factor_scan(A, B, z, mixed)
    key = _program_key(A, B, Q, z, contour, iters, tol, ortho, mixed, two_tier, pencil,
                       graphs, group)
    prog = _PROGRAMS.get(key)
    if prog is None:
        clear_graph_cache()
        prog = _PROGRAMS[key] = _SweepProgram(
            graphs, Q.device, kind=contour.kind, params=contour.params, tol=tol,
            ortho=ortho, mixed=mixed, two_tier=two_tier, pencil=pencil,
            mixed_eig=(pencil == "lu"
                       and eigmod._mixed_route(torch.complex128, Q.shape[1], Q.device)),
            mesh=mesh)
    prog.load(A, B, Q, LUb, permb, dinvb, z, w)
    del LUb, permb, dinvb
    return prog.run(iters)


def _coarse_floor(A32: torch.Tensor) -> torch.Tensor:
    """2 eps32 ||A||_F / sqrt(n), float64 on A's device: the complex64
    tier stops once its worst inside residual is at or below it."""
    n = A32.shape[0]
    return 2.0 * torch.finfo(torch.float32).eps * cx.fro_norm(A32).double() / math.sqrt(n)


# ---------------------------------------------------------------------------
# the sweep program: pure steps on static buffers, captured as CUDA graphs
# ---------------------------------------------------------------------------

def _rr_step(Q, A, B, ortho: str, kind: str, params, mixed_eig: bool,
             pencil: str = "lu"):
    """A sweep's Rayleigh-Ritz: orthonormalize, the reduced matrices, their
    eig (with mixed_eig the flagged mixed form, else `_reduced_eig` of the
    pencil with ok true), the Ritz pairs, the inside mask and the worst
    inside residual.  Returns (Qo, Aq, Bq, lam, X, R, res, inside, worst,
    ok).  Pencil "lu" reads nothing on the host; "qz" and "hermitian" do,
    so their steps run eagerly (`_graph_scope`).

    Stacked slices: Q (S, n, m0) gives every output a leading S (worst and
    ok (S,), one K2 launch for the S reduced matrices on the card), and
    `params` may hold (S, 1) tensors, one region a slice."""
    Qo = qrmod.orthonormalize(Q, method=ortho)
    Bq = None if B is None else cx.cgram(Qo, B @ Qo)
    Aq = cx.cgram(Qo, A @ Qo)
    if mixed_eig:
        lam, Xq, ok = (eigmod._eig_flagged(Aq) if Bq is None
                       else eigmod._gen_eig_flagged(Aq, Bq))
    else:
        if Aq.dim() == 2:
            lam, Xq = _reduced_eig(Aq, Bq, pencil)
        else:   # one slice at a time
            lam, Xq = (torch.stack(p) for p in zip(*(
                _reduced_eig(Aq[s], None if Bq is None else Bq[s], pencil)
                for s in range(Aq.shape[0]))))
        ok = torch.ones(Q.shape[:-2], dtype=torch.bool, device=Q.device)
    lam, X, R, res = _ritz_pairs(Qo, A, B, lam, Xq)
    inside = _in_mask(lam, kind, params)
    worst = torch.amax(torch.where(inside, res, 0.0), dim=-1)
    return Qo, Aq, Bq, lam, X, R, res, inside, worst, ok


def _coarse_stop(worst, inside, prev, it, floor32) -> torch.Tensor:
    """The complex64 tier's stop flag on device tensors, JAX's three-way
    rule (feast_tpu/solvers/feast.py:1037-1039): the worst inside residual
    no longer halves, or is at the floor, or nothing is inside after two
    sweeps.  prev (float64) is the last sweep's worst, `it` the sweep."""
    worst = worst.double()
    any_in = inside.any()
    return (((it > 0) & (worst > 0.5 * prev)) | (any_in & (worst <= floor32))
            | ((it > 1) & ~any_in))


def _status(flag, ok) -> torch.Tensor:
    """The (flag, ok) pair the host reads after a Rayleigh-Ritz step: (2,),
    or (2, S) for stacked slices."""
    return torch.stack([flag, ok]).to(torch.int32)


def _backend_key() -> tuple:
    """The four backend switches that change the captured ops."""
    return (eigmod._SCHUR_BACKEND, eigmod._EIG_MODE, cx._GEMM_BACKEND,
            lumod._PANEL_BACKEND)


def _program_key(A, B, Q, z, contour, iters, tol, ortho, mixed, two_tier, pencil,
                 graphs, group=None):
    """The signature a sweep program and its graphs are cached under, as
    jax.jit caches per static argument and shape: every value the steps
    bake in, every backend switch that changes the captured ops, and under
    mesh= the node group whose all-reduce the node-sum graphs hold (the
    cached program keeps the group alive, so its id is not reused)."""
    return (str(Q.device), Q.dtype, A.shape[0], Q.shape[1], z.shape[0], B is None,
            contour.kind, tuple(contour.params), iters, tol, ortho, mixed, two_tier,
            pencil, graphs, None if group is None else id(group)) + _backend_key()


# the one sweep program of the newest signature, `feast_compiled`'s
# (`_program_key`) or `feast_sliced_parallel`'s (`parallel.slicing`): the
# card holds at most one program and its buffers
_PROGRAMS: dict = {}


def clear_graph_cache():
    """Drop the cached sweep program of `feast_compiled` or
    `feast_sliced_parallel`: its buffers (on the card a copy of the factor
    store, or the stacked slices' store itself), graphs and memory pool."""
    if any(p.graphs for p in _PROGRAMS.values()):
        torch.cuda.synchronize()
    _PROGRAMS.clear()


class _Step:
    """One step of a sweep: its results in static buffers (`out`), and once
    captured its graph and the kernel launches the graph holds.  It keeps
    no reference to its program: a program in a reference cycle could be
    collected, and its graphs destroyed, in the middle of another capture,
    which that would invalidate."""

    def __init__(self):
        self.out = None
        self.graph = None
        self.tally = {}

    def store(self, vals: dict):
        if self.out is None:
            self.out = {k: v.clone() for k, v in vals.items()}
        else:
            for k, v in vals.items():
                self.out[k].copy_(v)


class _Program:
    """What the sweep programs share: static buffers (`buf`), steps run
    eagerly or captured once into a private pool and replayed (`_step`),
    and the host's one status read a sweep (`_read`).  With `graphs`,
    `capture_s` and `instantiate_s` time the captures and `replays` counts
    the replays."""

    def __init__(self, graphs: bool, device):
        self.graphs = graphs
        self.buf: dict = {}
        self.steps: dict = {}
        self.capture_s = self.instantiate_s = 0.0
        self.replays = 0
        self.status = None
        if graphs:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(device)

    def _put(self, name, t, dtype=None):
        buf = self.buf.get(name)
        if buf is None:
            self.buf[name] = t.to(dtype) if dtype is not None else t.clone()
        else:
            buf.copy_(t)

    def _step(self, name: str) -> dict:
        """Run step `name` (method `_<name>`, a dict of tensors): eagerly, or
        with graphs eagerly on its first call (that sweep's own work, and
        under a mesh the communicator's first collective), then captured
        once, then replayed with its launches counted."""
        step = self.steps.setdefault(name, _Step())
        if step.graph is not None:
            step.graph.replay()
            _build.add_launches(step.tally)
            self.replays += 1
            return step.out
        fn = getattr(self, "_" + name)
        step.store(fn())
        if self.graphs:
            step.graph, step.tally = self._capture(step, fn)
        return step.out

    def _capture(self, step: _Step, fn):
        """Capture `fn` into a CUDA graph; returns (graph, launch tally)."""
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()
        # thread_local: another thread's synchronizing call (a process
        # group's watchdog, say) does not invalidate this capture
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                              capture_error_mode="thread_local"), \
                _build.tally_launches() as tally:
            step.store(fn())
        t1 = time.perf_counter()
        graph.instantiate()
        self.capture_s += t1 - t0
        self.instantiate_s += time.perf_counter() - t1
        return graph, tally

    def _read(self, status: torch.Tensor):
        """The host's one read a sweep: the status tensor as a list."""
        if not self.graphs:
            return status.tolist()
        if self.status is None:
            self.status = torch.empty(status.shape, dtype=status.dtype, pin_memory=True)
        self.status.copy_(status, non_blocking=True)
        torch.cuda.current_stream().synchronize()
        return self.status.tolist()


class _SweepProgram(_Program):
    """The sweeps of `feast_compiled` for one signature, on static buffers.

    `load` copies a solve's inputs into the buffers the steps read (A, B
    and their complex64 copies, the factor, the nodes and weights, the
    start subspace, the complex64 tier's floor); `run` drives the tiers.  A
    sweep is two steps: Rayleigh-Ritz with the stop flag, then the node
    update, which writes the next subspace into the state buffer.  Under a
    mesh the update writes this rank's share there, and a third step, the
    node sum, all-reduces it over "node" in place (`pmesh.node_sum_`), so
    the collective and the wait for the other ranks are replayed, and
    timed, apart from the local work.  `sweeps` holds the last run's sweeps
    in each tier (complex64, complex128)."""

    def __init__(self, graphs: bool, device, *, kind, params, tol, ortho, mixed,
                 two_tier, pencil, mixed_eig, mesh=None):
        super().__init__(graphs, device)
        self.kind, self.params, self.tol, self.ortho = kind, params, tol, ortho
        self.mixed, self.two_tier, self.mixed_eig = mixed, two_tier, mixed_eig
        self.pencil = pencil
        self.mesh = mesh
        self.ranks = None if mesh is None else mesh.get_group("node").size()
        self.sweeps = (0, 0)

    def load(self, A, B, Q, LUb, permb, dinvb, z, w):
        for name, t in (("A", A), ("B", B), ("Q", Q), ("LUb", LUb), ("permb", permb),
                        ("invL", dinvb[0]), ("invU", dinvb[1]), ("z", z), ("w", w)):
            if t is not None:
                self._put(name, t)
        if self.two_tier:
            f32 = torch.complex64
            for name, t in (("A32", A), ("B32", B), ("z32", z), ("w32", w)):
                if t is not None:
                    self._put(name, t, f32)
            self._put("floor32", _coarse_floor(self.buf["A32"]))
            if "prev" not in self.buf:
                self.buf["prev"] = torch.empty((), dtype=torch.float64, device=A.device)
                self.buf["c_it"] = torch.empty((), dtype=torch.int64, device=A.device)

    def _coarse_rr(self):
        b = self.buf
        Qo, _, _, lam, X, R, _, inside, worst, ok = _rr_step(
            b["Qc"], b["A32"], b.get("B32"), self.ortho, self.kind, self.params, False,
            self.pencil)
        stop = _coarse_stop(worst, inside, b["prev"], b["c_it"], b["floor32"])
        b["prev"].copy_(worst)
        b["c_it"].add_(1)
        return {"Qo": Qo, "lam": lam, "X": X, "R": R, "status": _status(stop, ok)}

    def _coarse_update(self):
        b, o = self.buf, self.steps["coarse_rr"].out
        b["Qc"].copy_(_node_update_scan(
            b["LUb"], b["permb"], b["z32"], b["w32"], o["X"], o["R"], o["lam"], None,
            b["A32"], b.get("B32"), refine=0, dinvb=(b["invL"], b["invU"])))
        return {}

    def _coarse_sum(self):
        return self._node_sum("Qc")

    def _fine_rr(self):
        b = self.buf
        Qo, Aq, Bq, lam, X, R, res, inside, worst, ok = _rr_step(
            b["Q"], b["A"], b.get("B"), self.ortho, self.kind, self.params,
            self.mixed_eig, self.pencil)
        done = inside.any() & (worst < self.tol)
        out = {"Qo": Qo, "Aq": Aq, "lam": lam, "X": X, "R": R, "res": res,
               "inside": inside, "status": _status(done, ok)}
        if Bq is not None:
            out["Bq"] = Bq
        return out

    def _fine_update(self):
        b, o = self.buf, self.steps["fine_rr"].out
        b["Q"].copy_(_node_update_scan(
            b["LUb"], b["permb"], b["z"], b["w"], o["X"], o["R"], o["lam"],
            torch.complex64 if self.mixed else None, b["A"], b.get("B"),
            dinvb=(b["invL"], b["invU"])))
        return {}

    def _fine_sum(self):
        return self._node_sum("Q")

    def _node_sum(self, name: str) -> dict:
        from ..parallel import mesh as pmesh

        pmesh.node_sum_(self.buf[name], self.mesh)
        return {}

    def _sum_step(self, tier: str):
        """Under a mesh, the node sum after the tier's update: its step,
        replayed in span "feast.node_sum" with the tier, the payload's
        `bytes` and the node `ranks`."""
        if self.mesh is None:
            return
        Q = self.buf["Qc" if tier == "c64" else "Q"]
        with tracing.span("feast.node_sum", Q.device, tier=tier,
                          bytes=Q.numel() * Q.element_size(), ranks=self.ranks):
            self._step("coarse_sum" if tier == "c64" else "fine_sum")

    @tracing.spanned("feast.eig_fallback", lambda self, o: self.buf["Q"].device)
    def _full_rr(self, o: dict) -> bool:
        """The sweep's Rayleigh-Ritz again with the full eig, where the mixed
        eig's guard failed (JAX's lax.cond); returns done.  Span:
        "feast.eig_fallback"."""
        b = self.buf
        if "Bq" in o:
            lam, Xq = eigmod._gen_eig_full(o["Aq"], o["Bq"])
        else:
            lam, Xq = eigmod._eig_full(o["Aq"])
        lam, X, R, res = _ritz_pairs(o["Qo"], b["A"], b.get("B"), lam, Xq)
        inside = _in_mask(lam, self.kind, self.params)
        for name, t in (("lam", lam), ("X", X), ("R", R), ("res", res), ("inside", inside)):
            o[name].copy_(t)
        worst = float(torch.max(torch.where(inside, res, 0.0)))
        return bool(inside.any()) and worst < self.tol

    @tracing.spanned("feast.loop", lambda self, iters: self.buf["Q"].device)
    def run(self, iters: int) -> FeastResult:
        """Both tiers' sweeps.  Spans: "feast.loop" around the call, and
        around each step (a replay, with graphs) "feast.rr", "feast.update"
        or, under a mesh, "feast.node_sum" with the tier ("c64" or "c128");
        never inside a captured step."""
        b = self.buf
        dev = b["Q"].device
        it = c_it = 0
        if self.two_tier:
            self._put("Qc", b["Q"], torch.complex64)
            b["prev"].fill_(math.inf)
            b["c_it"].zero_()
            c_it, stop, o = 0, False, None
            while not stop and c_it < iters:
                with tracing.span("feast.rr", dev, tier="c64"):
                    o = self._step("coarse_rr")
                stop = bool(self._read(o["status"])[0])
                if not stop:
                    with tracing.span("feast.update", dev, tier="c64"):
                        self._step("coarse_update")
                    self._sum_step("c64")
                c_it += 1
            b["Q"].copy_(o["Qo"] if stop else b["Qc"])
            it = max(c_it - 1, 0)  # the stopping sweep did no update
        done, o, it0 = False, None, it
        while not done and it <= iters:
            with tracing.span("feast.rr", dev, tier="c128"):
                o = self._step("fine_rr")
            # under a mesh every rank reads the same status: the all-reduce
            # hands every rank the same bits, and the Rayleigh-Ritz is then
            # replicated work on equal inputs
            flag, ok = self._read(o["status"])
            done = bool(flag) if ok else self._full_rr(o)
            if not done and it < iters:  # the last allowed sweep's update is dead
                with tracing.span("feast.update", dev, tier="c128"):
                    self._step("fine_update")
                self._sum_step("c128")
            it += 1
        self.sweeps = (c_it, it - it0)
        if o is None:
            n, m0 = b["Q"].shape
            return FeastResult(torch.zeros(m0, dtype=b["Q"].dtype, device=dev),
                               torch.zeros((n, m0), dtype=b["Q"].dtype, device=dev),
                               torch.zeros(m0, dtype=torch.float64, device=dev),
                               torch.zeros(m0, dtype=torch.bool, device=dev), it, done)
        return FeastResult(o["lam"].clone(), o["X"].clone(), o["res"].clone(),
                           o["inside"].clone(), it, done)
