"""Spectral slicing: an interval of the real axis cut into contour slices.

Counterpart of `feast_tpu/parallel/slicing.py`.  `spectral_slices` cuts
[a, b] into circular contours and sizes each with the stochastic count
(`contour_estimate_eig`); `feast_sliced` solves the slices one after the
other (each slice's nodes may spread over a "node" mesh) and merges the
eigenpairs, dropping near-boundary duplicates by residual;
`feast_sliced_parallel` stacks the slices and gives each rank of a "slice"
mesh dimension its share: the rank factors all its slices' nodes in one
call, runs their refinement loops, and one all-gather of the eigenpairs is
the only traffic between slice groups.

Differences from the JAX package:
  * the merged result holds the converged pairs only (inside, residual
    below tol), as the JAX package's docstring says; its code merges every
    inside pair.  They differ when a slice stops at its iteration cap: with
    the uniform m0 of `feast_sliced_parallel`, the subspace's last columns
    can fall between two eigenvalues just outside the circle at equal
    distance from its centre, whose filter values are equal; the mixture's
    Ritz value can lie inside with a residual of the circle's order, and
    no sweep separates them.  Both packages park that value and run to the
    cap (tests/test_torch_parallel.py holds one such case against the JAX
    package); the JAX package returns it as an eigenvalue, the port drops
    it.  `per_slice` keeps every slice's full result;
  * `feast_sliced_parallel` has no `hlo_sink` (it exposed XLA's compiled
    module);
  * `mixed_prec` (both drivers, passed to `feast` / `gen_feast` and to
    the stochastic count, which take it in both packages) factors the
    nodes in complex64, the panel kernel on the card, and refines each
    solve twice in complex128.  The JAX package's slicing drivers factor in
    the driver's precision only, which is the default here.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import contour as ct


class SliceResult(NamedTuple):
    lam: np.ndarray
    X: np.ndarray
    res: np.ndarray
    slices: List[ct.Contour]
    counts: List[float]
    per_slice: list


def spectral_slices(A, interval: Tuple[float, float], n_slices: int, B=None, *,
                    samples: int = 40, nodes: int = 8,
                    half_height: Optional[float] = None, seed: int = 0,
                    mixed_prec: bool = False,
                    device="cuda") -> Tuple[List[ct.Contour], List[float]]:
    """Partition [a, b] into n_slices circular contours with estimated
    eigenvalue counts (for choosing each slice's m0).  half_height is
    accepted for the JAX package's signature and has no effect there
    either."""
    from ..solvers.stochastic import contour_estimate_eig

    a, b = interval
    edges = np.linspace(a, b, n_slices + 1)
    contours, counts = [], []
    for lo, hi in zip(edges[:-1], edges[1:]):
        k = ct.circular_contour_trapezoidal(complex((lo + hi) / 2.0, 0.0),
                                            (hi - lo) / 2.0, nodes)
        est = contour_estimate_eig(A, k, B, samples=samples, seed=seed,
                                   mixed_prec=mixed_prec, device=device)
        contours.append(k)
        counts.append(max(est, 0.0))
    return contours, counts


def _merge(results, interval, n, dedup_tol, tol):
    """Host (lam, X, res) of every slice's converged pairs (inside, residual
    below tol), the lower-residual copy of near-identical eigenvalues kept
    (slices share boundaries)."""
    parts = []
    for r in results:
        lam, X, res = r.filtered()
        ok = res < tol
        parts.append((lam[ok], X[:, ok], res[ok]))
    lam = np.concatenate([p[0] for p in parts]) if parts else np.empty(0, np.complex128)
    X = np.concatenate([p[1] for p in parts], axis=1) if parts else np.empty((n, 0))
    res = np.concatenate([p[2] for p in parts]) if parts else np.empty(0)
    keep, kept = [], []
    scale = max(abs(interval[0]), abs(interval[1]), 1.0)
    for i in np.argsort(res):
        if all(abs(lam[i] - l0) > dedup_tol * scale for l0 in kept):
            keep.append(i)
            kept.append(lam[i])
    keep = np.array(sorted(keep), dtype=int)
    return lam[keep], X[:, keep], res[keep]


def feast_sliced(A, interval: Tuple[float, float], n_slices: int, B=None, *,
                 nodes: int = 8, iters: int = 20, tol: float = 1e-12,
                 samples: int = 40, margin: float = 1.5, min_m0: int = 4,
                 mesh=None, seed: int = 0, dedup_tol: float = 1e-8,
                 mixed_prec: bool = False, verbose: bool = False,
                 device="cuda") -> SliceResult:
    """Solve A x = lam (B) x over [a, b] through independent contour slices,
    one after the other.

    Each slice's m0 = max(min_m0, ceil(margin * estimate) + 2); its start
    block is drawn from np.random.default_rng(seed) in slice order.  mesh:
    a "node" mesh every slice's `feast` / `gen_feast` spreads its nodes
    over (`parallel.node_mesh`)."""
    from ..solvers.feast import feast, gen_feast

    if mesh is not None:
        device = mesh.device_type
    contours, counts = spectral_slices(A, interval, n_slices, B, samples=samples,
                                       nodes=nodes, seed=seed, mixed_prec=mixed_prec,
                                       device=device)
    n = A.shape[0]
    rng = np.random.default_rng(seed)
    per_slice = []
    for k, est in zip(contours, counts):
        m0 = min(max(min_m0, int(np.ceil(margin * est)) + 2), n)
        X0 = rng.standard_normal((n, m0)) + 1j * rng.standard_normal((n, m0))
        kw = dict(contour=k, iters=iters, tol=tol, mesh=mesh, mixed_prec=mixed_prec,
                  device=device)
        out = feast(A, X0, **kw) if B is None else gen_feast(A, B, X0, **kw)
        per_slice.append(out)
        if verbose:
            print(f"slice c={k.center:.4g} r={k.radius:.4g}: est {est:.1f} "
                  f"m0={m0} found {int(out.inside.sum())} (iters {out.n_iter})")
    return SliceResult(*_merge(per_slice, interval, n, dedup_tol, tol), contours, counts,
                       per_slice)


def _run_slices(A, B, LU, perm, dinv, z, w, Q, contours, iters, tol, solve_dtype):
    """The refinement loops of stacked slices against one factor store
    (LU, perm and the dinv pair stacked slice-major over slices x nodes): each slice
    iterates until its own stop, as the JAX package's vmapped while_loop
    does.  Returns a FeastResult per slice."""
    from ..ops import qr as qrmod
    from ..solvers.feast import FeastResult, _in_mask, _node_update_scan, _rayleigh_ritz

    N = z.shape[1]
    out = []
    for s, k in enumerate(contours):
        blk = slice(s * N, (s + 1) * N)
        Qs, it, done = Q[s], 0, False
        while not done and it <= iters:
            Qo = qrmod.orthonormalize(Qs, method="cholqr2")
            lam, X, R, res = _rayleigh_ritz(Qo, A, B)
            inside = _in_mask(lam, k.kind, k.params)
            done = bool(inside.any()) and float(torch.max(torch.where(inside, res, 0.0))) < tol
            if not done:
                Qs = _node_update_scan(LU[blk], perm[blk], z[s], w[s], X, R, lam,
                                       solve_dtype, A, B,
                                       dinvb=tuple(d[blk] for d in dinv))
            it += 1
        out.append(FeastResult(lam, X, res, inside, it, done))
    return out


def feast_sliced_parallel(A, interval: Tuple[float, float], n_slices: int, B=None, *,
                          nodes: int = 8, iters: int = 20, tol: float = 1e-12,
                          samples: int = 40, margin: float = 1.5, min_m0: int = 4,
                          mesh=None, m0: Optional[int] = None, seed: int = 0,
                          dedup_tol: float = 1e-8, mixed_prec: bool = False,
                          verbose: bool = False, device="cuda") -> SliceResult:
    """Solve the slices of [a, b] stacked: one uniform m0 (the largest
    estimate's, or `m0`) keeps the batch rectangular; start blocks come from
    one np.random.default_rng(seed) draw of (n_slices, n, m0).

    mesh: a DeviceMesh with a "slice" dimension (for instance
    `init_device_mesh("cuda", (k,), mesh_dim_names=("slice",))`); each of
    its k ranks takes n_slices / k consecutive slices, factors their
    slices x nodes matrices in one call, runs their loops, and one
    all-gather over "slice" gives every rank every slice's eigenpairs.
    mesh=None runs every slice on this process's `device`."""
    from .._device import as_tensor, resolve_device
    from ..solvers.feast import FeastResult, _factor_scan

    if mesh is None:
        dev = resolve_device(device)
        first, count = 0, n_slices
    else:
        from . import mesh as pmesh

        dev = pmesh.mesh_device(mesh)
        k, size = pmesh._dim_rank(mesh, "slice")
        if n_slices % size:
            raise ValueError(f"n_slices={n_slices} not divisible by the 'slice' "
                             f"dimension's {size} ranks")
        count = n_slices // size
        first = k * count
    contours, counts = spectral_slices(A, interval, n_slices, B, samples=samples,
                                       nodes=nodes, seed=seed, mixed_prec=mixed_prec,
                                       device=dev)
    n = A.shape[0]
    if m0 is None:
        m0 = min(max(min_m0, int(np.ceil(margin * max(counts))) + 2), n)
    rng = np.random.default_rng(seed)
    X0 = rng.standard_normal((n_slices, n, m0)) + 1j * rng.standard_normal((n_slices, n, m0))

    dt = torch.complex128

    def dense(M):
        return as_tensor(M.toarray() if hasattr(M, "toarray") else M, dt, dev)

    Ad = dense(A)
    Bd = None if B is None else dense(B)
    mine = contours[first:first + count]
    z = torch.stack([k.device_nodes(dt, dev) for k in mine])          # (S, N)
    w = torch.stack([k.device_weights(dt, dev) for k in mine])
    # one factor call over slices x nodes
    LU, perm, dinv = _factor_scan(Ad, Bd, z.reshape(-1), bool(mixed_prec))
    Q = as_tensor(X0[first:first + count], dt, dev)
    results = _run_slices(Ad, Bd, LU, perm, dinv, z, w, Q, mine, iters, tol,
                          torch.complex64 if mixed_prec else None)

    if mesh is not None:
        # the only traffic between slice groups: every slice's pairs
        X = pmesh.all_gather(torch.stack([r.X for r in results]), mesh, "slice")
        lam = pmesh.all_gather(torch.stack([r.lam for r in results]), mesh, "slice")
        meta = pmesh.all_gather(torch.stack([torch.stack(
            [r.res, r.inside.to(r.res.dtype),
             torch.full_like(r.res, r.n_iter), torch.full_like(r.res, r.converged)])
            for r in results]), mesh, "slice")
        results = [FeastResult(lam[s], X[s], meta[s, 0], meta[s, 1] > 0,
                               int(meta[s, 2, 0]), bool(meta[s, 3, 0] > 0))
                   for s in range(n_slices)]
    if verbose:
        for k, r in zip(contours, results):
            print(f"slice c={k.center:.4g} r={k.radius:.4g}: found "
                  f"{int(r.inside.sum())} (iters {r.n_iter})")
    return SliceResult(*_merge(results, interval, n, dedup_tol, tol), contours, counts,
                       results)
