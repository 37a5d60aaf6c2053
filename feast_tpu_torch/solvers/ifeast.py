"""Inexact FEAST: iterative (matrix-free) shifted solves.

Counterpart of `feast_tpu/solvers/ifeast.py`.  Two entry points:

* `ifeast`: the reference's experimental plain spectral-projector filter
  Q = sum_i w_i (z_i I - A)^{-1} X via per-node BiCGStab, no
  orthonormalization (the Rayleigh-Ritz keeps Bq = Q^H Q), absolute
  residuals.

* `feast_iterative`: the sparse production path: the full
  residual-inverse-iteration FEAST update (same convergence as `feast` /
  `gen_feast`) with the direct LU replaced by batched matrix-free Krylov
  solves on (A - z_i B), Jacobi- or AMG-preconditioned, warm-started from
  the previous refinement sweep.  Works with dense pairs or sparse
  operators.

The contour-node axis is a leading batch dimension: one Krylov call solves
a chunk of nodes (all of them by default) on (chunk, n, m0) blocks, each
node frozen by its own stop test (`ops/krylov.py`).  Every sweep is
Rayleigh-Ritz, then the convergence test, then the node solves, so the
solves of a converged sweep are never run.  `chunk_ckpt` / `resume_chunk`
hook that loop for the checkpointing orchestrator (`orchestrate.py`), and
`mesh=` spreads the contour nodes over the ranks of a `node` device mesh
(`parallel/mesh.py`), and the pencil's rows over its "row" dimension when
it has one (`parallel/rowsharded.py`).
"""

from __future__ import annotations

import functools
import time
from typing import Optional

import numpy as np
import torch

from .. import contour as ct
from .. import cx
from .._device import as_tensor, resolve_device
from ..ops import eig as eigmod
from ..ops import krylov
from ..ops import qr as qrmod
from ..ops import sparse as spmod
from .feast import (FeastResult, _debug_print, _host_eig, _in_mask,
                    _resolve_tol, _resolvent)

_DT = torch.complex128


def _raw_matrix(A):
    """Recover a scipy / numpy matrix for host-side work (AMG setup, host
    Rayleigh-Ritz) from whatever the caller passed."""
    import scipy.sparse as sp

    if isinstance(A, spmod.DIA):
        D = A.data.cpu().numpy()  # row-indexed (ndiag, n)
        n, m = A.shape
        rows, cols, vals = [], [], []
        for k, off in enumerate(A.offsets):
            i = np.arange(max(0, -off), min(n, m - off))
            rows.append(i)
            cols.append(i + off)
            vals.append(D[k, i])
        return sp.coo_matrix(
            (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
            shape=A.shape).tocsr()
    if isinstance(A, spmod.CSR):
        return sp.coo_matrix(
            (A.data.cpu().numpy(), (A.row_ids.cpu().numpy(), A.indices.cpu().numpy())),
            shape=A.shape).tocsr()
    if isinstance(A, spmod.BELL):
        bs, kmax = A.bs, A.kmax
        nbr = A.colb.shape[0]
        # merged (nbr, bs, kmax bs) layout -> logical (nbr, kmax, bs, bs)
        D = A._blocks4().cpu().numpy()
        colb = A.colb.cpu().numpy()
        ri, ci = np.meshgrid(np.arange(bs), np.arange(bs), indexing="ij")
        rows = np.broadcast_to(np.arange(nbr)[:, None, None, None] * bs + ri, D.shape)
        cols = colb[:, :, None, None] * bs + ci
        M = sp.coo_matrix((D.ravel(), (rows.ravel(), cols.ravel())),
                          shape=(nbr * bs, -(-A.shape[1] // bs) * bs)).tocsr()
        M = sp.csr_matrix(M[:A.shape[0], :A.shape[1]])
        if A.spill is not None:  # the entries of the capped blocks
            M = M + _raw_matrix(A.spill)
        M.eliminate_zeros()
        return M.tocsr()
    if isinstance(A, torch.Tensor):
        return A.cpu().numpy()
    return A


def ifeast(A, X0, nodes: int = 8, iters: int = 10, *,
           c: complex = 0.0 + 0.0j, r: float = 1.0, tol: float = 1e-10,
           solve_tol: float = 1e-8, solve_iters: int = 500,
           debug: bool = False, device="cuda") -> FeastResult:
    """Reference-parity inexact FEAST (plain filter, no orthonormalization)."""
    dev = resolve_device(device)
    A = spmod.as_operator(A, _DT, dev)
    X = as_tensor(X0, _DT, dev)
    n, m0 = X.shape
    k = ct.circular_contour_trapezoidal(complex(c), float(r), nodes)
    z = k.device_nodes(_DT, dev)
    # plain-filter weights e^{i theta} / N; the missing r only rescales Q,
    # which the Bq = Q^H Q Rayleigh-Ritz absorbs
    w = (z - complex(c)) / (float(r) * nodes)

    def z_minus_A(V):  # (z_i I - A) V per node: the reference's sign
        return z[:, None, None] * V - spmod.apply_op(A, V)

    lam = res = inside = None
    n_iter, converged = 0, False
    for nit in range(1, iters + 1):
        n_iter = nit
        sol = krylov.bicgstab(z_minus_A, X.expand(nodes, n, m0), tol=solve_tol,
                              maxiter=solve_iters)
        Q = torch.sum(sol.x * w[:, None, None], dim=0)
        lam, Xq = eigmod.gen_eig(cx.cgram(Q, spmod.apply_op(A, Q)), cx.cgram(Q))
        X = cx.normalize_cols(Q @ Xq)
        res = cx.col_norms(spmod.apply_op(A, X) - cx.scale_cols(X, lam))
        inside = _in_mask(lam, k.kind, k.params)
        res_h, inside_h = res.cpu().numpy(), inside.cpu().numpy()
        if debug:
            _debug_print(nit, res_h, inside_h)
        if inside_h.any() and res_h[inside_h].max() < tol:
            converged = True
            break
    return FeastResult(lam, X, res, inside, n_iter, converged)


def feast_iterative(A, B, X0, contour: Optional[ct.Contour] = None, *,
                    c: complex = 0.0 + 0.0j, r: float = 1.0, nodes: int = 8,
                    iters: int = 20, tol: float = 1e-10,
                    solver: str = "bicgstab", solve_tol: float = 1e-10,
                    solve_iters: int = 1000, precondition="jacobi",
                    gmres_restart: Optional[int] = None,
                    rhs_chunk: Optional[int] = None,
                    amg_opts: Optional[dict] = None,
                    spurious: Optional[float] = None,
                    ortho: str = "cholqr2", mesh=None,
                    node_chunk: Optional[int] = None,
                    rr: str = "device",
                    keep_q: bool = False,
                    warm0=None, keep_warm: bool = False,
                    chunk_ckpt=None, resume_chunk=None,
                    reorder="auto",
                    nit0: int = 0, tol_mode: str = "abs",
                    m0=None, samples: int = 8, seed: int = 0,
                    auto_m0_margin: float = 2.5,
                    debug: bool = False, device="cuda") -> FeastResult:
    """Residual-inverse-iteration FEAST with matrix-free iterative node
    solves.  A, B: scipy-sparse / dense / tensor / CSR / DIA / BELL (B=None
    is the identity); inputs are moved to `device` (default "cuda"; raises when
    CUDA is absent, pass "cpu" for the plain path).  The outer recurrence
    runs in complex128.

    solver: "bicgstab" | "bicgstab_rr" (residual replacement, for deep
    tolerances on ill-conditioned shifts) | "bicgstabl" (l = 2) | "gmres"
    (strongly indefinite interior shifts; `gmres_restart`, and `rhs_chunk`
    bounds the (restart + 1, n, chunk) basis).

    precondition: "jacobi" (diagonal of A - zB), "amg" (smoothed-
    aggregation V-cycle, ops/amg.py, required for edge-of-spectrum slices
    where kappa(A - zB) >= 1e8; `amg_opts` carries its build and apply
    options, among them "dtype": torch.float32 for a complex64 V-cycle
    under the complex128 recurrence, and "damp", a complex-shifted-
    Laplacian style extra imaginary shift relative to |z|), False / None
    (unpreconditioned), or a callable z -> (X -> M^{-1} X) given the
    (chunk,) tensor of node shifts.  True is an alias for "jacobi".

    rr: "device" keeps the Rayleigh-Ritz phase on the device; "host"
    computes it (orthonormalize, Grams, m0 x m0 eig, residual) in numpy /
    LAPACK complex128 and keeps only the node solves on the device.

    keep_q: return the final (post-sweep) moment subspace in
    `FeastResult.Q`; restarting a later call from it (X0 = Q, any iters)
    continues the refinement exactly, which gives single-sweep stepping
    (`iters=0, keep_q=True`) with host checkpoints in between.

    warm0 / keep_warm: per-node Krylov warm-start solutions (nodes, n, m0)
    in the caller's row numbering; keep_warm=True returns the final ones in
    `FeastResult.warm`.

    reorder: "auto" applies a reverse Cuthill-McKee permutation to a
    scipy-sparse pencil when it shrinks the bandwidth (ops/reorder.py),
    "rcm" forces it, None / False disables; vectors are permuted back.
    The permuted pencil then takes DIA when banded, BELL when the block
    cost model prefers it (`sparse.as_operator`).

    m0: subspace sizing when X0 is None: an int draws a random (n, m0)
    start block from `seed`; "auto" sizes it from a matrix-free stochastic
    count of the slice (Hutchinson trace of the spectral projector through
    the same node solves, `samples` real Gaussian probes):
    m0 = max(ceil(margin * est), ceil(est) + 4, 4).

    node_chunk: solve the contour nodes in chunks of this size instead of
    all at once.  Block BiCGStab holds about ten (n, m0) blocks per node,
    so a chunk bounds the peak memory, and a node no longer waits for the
    slowest of its batch; it must divide the node count (the rank's share
    under mesh).

    chunk_ckpt / resume_chunk: sub-sweep checkpoints.  `chunk_ckpt(info)`
    is called once per sweep after the Rayleigh-Ritz phase with
    {nit, ci: -1, rr: (X, lam, R, res, inside)} and after every node chunk
    with {nit, ci, nchunks, Qn (the partial moment sum), warm_chunk}, all
    in the driver's internal (reordered) row numbering; persist them as
    opaque blobs.  `resume_chunk={"ci0", "Qn", "warm_new", "rr"}` restarts
    the first sweep of the call at chunk ci0 with those blobs and skips its
    Rayleigh-Ritz phase when "rr" is given (it is deterministic in Q), so
    the resumed sweep's Q equals the uninterrupted one bit for bit.

    mesh: a `torch.distributed` DeviceMesh with a "node" dimension
    (`parallel.node_mesh`); each rank solves nodes / ranks of the contour
    nodes (in chunks of node_chunk, when given), one all-reduce over
    "node" sums the moment block, and every rank repeats the
    Rayleigh-Ritz phase, whose results rank 0 then broadcasts
    (`parallel.mesh.agree`), so every rank returns the same result.  X0
    is broadcast from rank 0; the operators and the AMG hierarchy are
    built on every rank.  A mesh with a "row" dimension as well
    (`parallel.node_row_mesh`) keeps each rank's rows of the pencil and
    of every AMG level on that rank, and a product gathers the row blocks
    (`parallel.feast_iterative_rows`); its AMG aggregates by strength
    unless amg_opts says otherwise.  It needs X0, rr="device", and no
    chunk_ckpt / resume_chunk.

    nit0: refinement-sweep offset for single-sweep stepping (keeps the
    spurious two-tier stop's nit >= 2 gate continuous across calls)."""
    import scipy.sparse as sp

    if mesh is not None:
        from ..parallel import mesh as pmesh

        if X0 is None:
            raise ValueError("X0=None sizing does not compose with mesh")
        if rr == "host":
            raise ValueError("rr='host' does not compose with mesh")
        if chunk_ckpt is not None or resume_chunk is not None:
            raise ValueError("chunk_ckpt / resume_chunk do not compose with mesh")
        dev = pmesh.mesh_device(mesh, device)
        X0 = pmesh.replicate(as_tensor(X0, _DT, dev), mesh)
    else:
        dev = resolve_device(device)
    if warm0 is not None:
        warm0 = as_tensor(warm0, _DT, dev)
    if X0 is not None:
        X0 = as_tensor(X0, _DT, dev)
    perm = None
    if reorder and sp.issparse(A):
        from ..ops import reorder as rdmod

        B_pat = B if (B is not None and sp.issparse(B)) else None
        if reorder == "rcm":
            perm = rdmod.rcm_permutation(A, B_pat)
        else:
            perm, _ = rdmod.plan_reorder(A, B_pat)
        if perm is not None:
            A = sp.csr_matrix(A)[perm][:, perm].tocsr()
            if B is not None:
                B = (sp.csr_matrix(B)[perm][:, perm].tocsr() if sp.issparse(B)
                     else _raw_matrix(B)[perm][:, perm])
            pt = torch.as_tensor(perm, device=dev)
            if X0 is not None:  # X0=None: the random start is drawn permuted
                X0 = X0[pt]
            if warm0 is not None:
                warm0 = warm0[:, pt]
    A_raw, B_raw = A, B  # (permuted) originals for host-side work
    rows = mesh is not None and "row" in (mesh.mesh_dim_names or ())
    if rows:   # this rank's row blocks (parallel.rowsharded)
        from ..parallel import rowsharded

        A, B = rowsharded.row_operators(_raw_matrix(A_raw),
                                        None if B is None else _raw_matrix(B_raw), mesh, _DT)
    else:
        A = spmod.as_operator(A, _DT, dev)
        B = spmod.as_operator(B, _DT, dev)
    n = A.shape[0]
    if precondition is True:
        precondition = "jacobi"
    amg_apply_only = ("nu", "cycles", "damp")  # "omega" feeds build and apply
    amg_apply = {k: v for k, v in (amg_opts or {}).items()
                 if k in amg_apply_only + ("omega", "dtype")}
    amg_hier = None
    if precondition == "amg":
        from ..ops import amg as amgmod

        # the V-cycle dtype is also the hierarchy's storage dtype
        build_opts = {k: v for k, v in (amg_opts or {}).items()
                      if k not in amg_apply_only}
        build_opts.setdefault("dtype", _DT)
        raw = (_raw_matrix(A_raw), None if B is None else _raw_matrix(B_raw))
        amg_hier = (rowsharded.row_amg(*raw, mesh, device=dev, **build_opts) if rows
                    else amgmod.build_amg(*raw, device=dev, **build_opts))
    if X0 is None and m0 is None:
        raise ValueError("pass X0 or m0= (int or 'auto')")
    if contour is None:
        contour = ct.circular_contour_trapezoidal(complex(c), float(r), nodes)
    tol = _resolve_tol(tol, tol_mode, contour)
    z = contour.device_nodes(_DT, dev)
    w = contour.device_weights(_DT, dev)
    N = len(contour)
    if mesh is not None:
        z, w = pmesh.shard_nodes(z, mesh), pmesh.shard_nodes(w, mesh)
        if warm0 is not None:
            warm0 = pmesh.shard_nodes(warm0, mesh)

    if solver == "bicgstab":
        solve_fn = krylov.bicgstab
    elif solver == "bicgstab_rr":
        solve_fn = krylov.bicgstab_rr
    elif solver == "bicgstabl":
        solve_fn = functools.partial(krylov.bicgstab_l, ell=2)
    elif solver == "gmres":
        restart = gmres_restart or min(40, max(10, n // 8))
        solve_fn = functools.partial(
            krylov.gmres, restart=restart,
            maxrestart=max(1, -(-int(solve_iters) // restart)))
    else:
        raise ValueError(f"unknown solver {solver!r} "
                         "(bicgstab|bicgstab_rr|bicgstabl|gmres)")

    def rr_device(Q):
        Qo = qrmod.orthonormalize(Q, method=ortho)
        Aq = cx.cgram(Qo, spmod.apply_op(A, Qo))
        if B is None:
            lam, Xq = eigmod.eig(Aq)
        else:
            lam, Xq = eigmod.gen_eig(Aq, cx.cgram(Qo, spmod.apply_op(B, Qo)))
        Xn = cx.normalize_cols(Qo @ Xq)
        R = spmod.apply_op(A, Xn) - cx.scale_cols(spmod.apply_op(B, Xn), lam)
        return Xn, lam, R, cx.col_norms(R), _in_mask(lam, contour.kind, contour.params)

    def make_M(zc):
        if precondition == "amg":
            opts = dict(amg_apply)
            damp = float(opts.pop("damp", 0.0))
            if damp:
                # precondition at z + i sign(Im z) damp |z|: the extra
                # imaginary shift keeps the V-cycle contraction stable when
                # A - zB is indefinite mid-spectrum, for a few more outer
                # Krylov iterations
                s = torch.where(zc.imag >= 0, 1.0, -1.0)
                zc = torch.complex(zc.real, zc.imag + s * damp * cx.cabs(zc))
            return amgmod.shifted_preconditioner(amg_hier, zc, **opts)
        if precondition == "jacobi":
            return spmod.jacobi_preconditioner(A, B, zc)
        if callable(precondition):
            return precondition(zc)
        return None

    def solve_nodes(zc, rhs, x0):
        """(A - z_i B) x_i = rhs for the nodes zc; rhs (n, m), x (chunk, n, m)."""
        mv = spmod.shifted_matvec(A, B, zc)
        M = make_M(zc)
        Bm = rhs.expand((zc.shape[0],) + tuple(rhs.shape))
        if solver != "gmres":
            return solve_fn(mv, Bm, x0=x0, tol=solve_tol, maxiter=solve_iters, M=M).x
        mw = rhs.shape[1]
        if rhs_chunk is None or rhs_chunk >= mw:
            return solve_fn(mv, Bm, x0=x0, tol=solve_tol, M=M).x
        # the (restart + 1, n, chunk) Arnoldi basis is the memory peak:
        # solve the block in column chunks
        parts = [solve_fn(mv, Bm[..., j0:j0 + rhs_chunk],
                          x0=None if x0 is None else x0[..., j0:j0 + rhs_chunk],
                          tol=solve_tol, M=M).x
                 for j0 in range(0, mw, rhs_chunk)]
        return torch.cat(parts, dim=-1)

    if node_chunk is None:
        node_chunk = z.shape[0]
    node_chunk = int(node_chunk)
    if node_chunk < 1 or z.shape[0] % node_chunk:
        raise ValueError(f"node_chunk={node_chunk} must be a positive divisor "
                         f"of the {z.shape[0]} nodes of this process")
    chunks = [slice(k, k + node_chunk) for k in range(0, z.shape[0], node_chunk)]

    def hutchinson_count():
        """E[#eig inside] = -(1/s) sum_i Re[w_i tr(X^H (A - z_i B)^{-1} B X)]
        with real Gaussian probes; the B factor makes the trace the
        generalized projector's."""
        s = int(samples)
        Xp = as_tensor(np.random.default_rng(seed).standard_normal((n, s)), _DT, dev)
        BX = spmod.apply_op(B, Xp)
        acc = 0.0
        for sl in chunks:
            Y = solve_nodes(z[sl], BX, None)
            tr = torch.sum(Xp.conj() * Y, dim=(-2, -1))
            acc += float(torch.sum((w[sl] * (-tr)).real))
        return acc / s

    if X0 is None:
        if m0 == "auto":
            est = hutchinson_count()
            m0 = max(int(np.ceil(auto_m0_margin * max(est, 0.0))),
                     int(np.ceil(max(est, 0.0))) + 4, 4)
            m0 = min(m0, n)
            if debug:
                print(f"feast_iterative: stochastic count {est:.2f} inside "
                      f"-> m0={m0}")
        else:
            m0 = int(m0)
        rngx = np.random.default_rng(seed)
        X0 = as_tensor(rngx.standard_normal((n, m0))
                       + 1j * rngx.standard_normal((n, m0)), _DT, dev)
    X = X0
    if X.ndim != 2 or X.shape[0] != n:
        raise ValueError(f"feast_iterative: X0 must be (n, m0) with n={n}, "
                         f"got {tuple(X.shape)}")
    m0 = X.shape[1]
    if solver == "gmres" and rhs_chunk is None:
        # keep the (restart + 1, n, chunk) basis of one node under ~3 GB
        ck = max(int(3e9 / ((restart + 1) * n * 16)), 1)
        if ck < m0:
            rhs_chunk = ck
            if debug:
                print(f"feast_iterative: gmres basis capped -> rhs_chunk={ck}")

    if rr == "host":
        A_h = _raw_matrix(A_raw)
        B_h = None if B is None else _raw_matrix(B_raw)

        def rr_host(Q):
            Qo, _ = np.linalg.qr(Q.cpu().numpy())
            lam_h, Xq = _host_eig(Qo.conj().T @ (A_h @ Qo),
                                  None if B_h is None else Qo.conj().T @ (B_h @ Qo))
            Xh = Qo @ Xq
            Xh = Xh / np.maximum(np.linalg.norm(Xh, axis=0),
                                 np.finfo(np.float64).tiny)
            BX = Xh if B_h is None else B_h @ Xh
            Rh = A_h @ Xh - BX * lam_h[None, :]
            inside_h = np.asarray(ct.in_contour(lam_h, contour), dtype=bool)
            return (as_tensor(Xh, _DT, dev), as_tensor(lam_h, _DT, dev),
                    as_tensor(Rh, _DT, dev),
                    torch.as_tensor(np.linalg.norm(Rh, axis=0), device=dev),
                    torch.as_tensor(inside_h, device=dev))

        rr_step = rr_host
    elif rr == "device":
        rr_step = rr_device
    else:
        raise ValueError(f"unknown rr {rr!r} (device|host)")

    if warm0 is not None and tuple(warm0.shape) != (z.shape[0], n, m0):
        raise ValueError(f"warm0 shape {tuple(warm0.shape)} != (nodes, n, m0) "
                         f"= {(N, n, m0)}")
    warm = [None if warm0 is None else warm0[sl] for sl in chunks]

    def stops(nit, res_h, inside_h):
        nit = nit + nit0
        if inside_h.any() and res_h[inside_h].max() < tol:
            return True
        # two-tier stop: once the filter has acted (nit >= 2), values inside
        # the contour whose residual exceeds `spurious` are ignored for
        # convergence (with iterative solves an over-sized subspace can park
        # a spurious Ritz value inside indefinitely)
        if spurious is not None and nit >= 2:
            ok = inside_h & (res_h < spurious)
            if ok.any() and res_h[ok].max() < tol:
                return True
        return False

    lam = res = inside = Xout = None
    n_iter, n_sweeps, converged = 0, 0, False
    Q = X
    for nit in range(iters + 1):
        n_iter = nit
        resuming = resume_chunk is not None and nit == 0
        rr_state = resume_chunk.get("rr") if resuming else None
        if rr_state is not None:
            Xout, lam, R, res, inside = (
                as_tensor(v, dt, dev) for v, dt in
                zip(rr_state, (_DT, _DT, _DT, torch.float64, torch.bool)))
        elif mesh is None:
            Xout, lam, R, res, inside = rr_step(Q)
        else:
            Xout, lam, R, res = pmesh.agree(rr_step(Q)[:4], mesh)
            inside = _in_mask(lam, contour.kind, contour.params)
        res_h, inside_h = res.cpu().numpy(), inside.cpu().numpy()
        if debug:
            _debug_print(nit + nit0, res_h, inside_h)
        if stops(nit, res_h, inside_h):
            converged = True
            break
        if chunk_ckpt is not None and rr_state is None:
            chunk_ckpt({"nit": nit + nit0, "ci": -1,
                        "rr": (Xout, lam, R, res_h, inside_h)})
        Qn, ci0 = None, 0
        if resuming:
            ci0 = int(resume_chunk.get("ci0", 0))
            if ci0 > 0:
                Qn = as_tensor(resume_chunk["Qn"], _DT, dev)
                for cj in range(ci0):
                    warm[cj] = as_tensor(resume_chunk["warm_new"][cj], _DT, dev)
        for ci in range(ci0, len(chunks)):
            sl = chunks[ci]
            t_ck = time.perf_counter()
            warm[ci] = solve_nodes(z[sl], R, warm[ci])
            phi = _resolvent(w[sl, None], z[sl, None], lam[None, :])   # (chunk, m0)
            term = torch.sum((Xout[None] - warm[ci]) * phi[:, None, :], dim=0)
            Qn = term if Qn is None else Qn + term
            if chunk_ckpt is not None:
                chunk_ckpt({"nit": nit + nit0, "ci": ci, "nchunks": len(chunks),
                            "Qn": Qn, "warm_chunk": warm[ci]})
            if debug and len(chunks) > 1:
                print(f"  chunk {ci + 1}/{len(chunks)} "
                      f"{time.perf_counter() - t_ck:.1f}s", flush=True)
        n_sweeps += 1
        Q = Qn if mesh is None else pmesh.node_sum(Qn, mesh)
    if not bool(inside.any()):
        print("no eigenvalues found in contour!")
    warm_out = None
    if keep_warm:
        warm_out = torch.cat([wc if wc is not None
                              else torch.zeros((node_chunk, n, m0), dtype=_DT, device=dev)
                              for wc in warm])
        if mesh is not None:
            warm_out = pmesh.gather_nodes(warm_out, mesh)
    if perm is not None:  # undo the row permutation on the vectors
        iperm = torch.as_tensor(np.argsort(perm), device=dev)
        Xout = Xout[iperm]
        if keep_q:
            Q = Q[iperm]
        if warm_out is not None:
            warm_out = warm_out[:, iperm]
    return FeastResult(lam, Xout, res, inside, n_iter, converged,
                       Q if keep_q else None, n_sweeps, warm_out)
