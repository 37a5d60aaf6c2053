"""Spectral slicing: an interval of the real axis cut into contour slices.

Counterpart of `feast_tpu/parallel/slicing.py`.  `spectral_slices` cuts
[a, b] into circular contours and sizes each with the stochastic count
(`contour_estimate_eig`); `feast_sliced` solves the slices one after the
other (each slice's nodes may spread over a "node" mesh) and merges the
eigenpairs, dropping near-boundary duplicates by residual;
`feast_sliced_parallel` stacks the slices and gives each rank of a "slice"
mesh dimension its share: the rank factors all its slices' nodes in one
call, runs their refinement loops together on a leading slice axis, as the
JAX package's vmapped while_loop does, and one all-gather of the
eigenpairs is the only traffic between slice groups.  That loop is one
program (`_SlicedProgram`): a sweep of all the rank's slices is two steps,
the Rayleigh-Ritz (one K2 launch for the S reduced matrices on the card,
per-slice stop flags and eig guards) and the node update over the S x
nodes factor store, with one (2, S) status read a sweep.  On the card the
steps are CUDA graphs; the CPU and the options outside
`solvers.feast._graph_scope` run them eagerly.

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
    module); on the card the host reads one (2, S) status tensor a sweep
    where the JAX program reads none, and runs a failed eig guard's
    Rayleigh-Ritz again eagerly with the full eig, that slice alone
    (JAX's lax.cond);
  * `mixed_prec` (both drivers, passed to `feast` / `gen_feast` and to
    the stochastic count, which take it in both packages) factors the
    nodes in complex64, the panel kernel on the card, and refines each
    solve twice in complex128.  The JAX package's slicing drivers factor in
    the driver's precision only, which is the default here.
"""

from __future__ import annotations

import inspect
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import contour as ct
from ..ops import eig as eigmod
from ..ops import lu as lumod
from ..solvers.feast import (_PROGRAMS, FeastResult, _backend_key, _factor_into,
                             _graph_scope, _node_update_scan, _Program, _ritz_pairs,
                             _rr_step, _status, clear_graph_cache)


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


class _SlicedProgram(_Program):
    """The sweeps of `feast_sliced_parallel`'s stacked slices for one
    signature (`_sliced_key`), on static buffers: the JAX package's jit of
    a vmap over the slice axis of a while_loop (feast_tpu/parallel/
    slicing.py:114-165).

    `factor` writes the S x N node matrices straight into the program's
    slice-major store and factors it in place; `load` copies the rest of a
    call's inputs (A, B, the start blocks, the nodes, weights and each
    slice's circle as buffer contents, so a cached program solves any
    interval of its shape); `run` drives the sweeps.  A sweep is two
    steps for all S slices: `_rr` (Rayleigh-Ritz, the per-slice stop flag
    and eig guard) and `_update` (the node update, one batch over the
    store).  A slice that stopped keeps its state, as under vmap: the
    device holds each slice's sweep count `it` and flag `done`, and a
    slice is active while not done and it <= iters.  `sweeps` and
    `fallbacks` count the last run's batched sweeps and full-eig reruns."""

    def __init__(self, graphs: bool, device, *, S, N, n, solve_dtype, tol, iters,
                 mixed_eig):
        super().__init__(graphs, device)
        self.tol, self.iters, self.mixed_eig = tol, iters, mixed_eig
        self.solve_dtype = solve_dtype
        self.sweeps = self.fallbacks = 0
        self.buf["store"] = lumod.factor_buffer((S * N,), n, solve_dtype, device)
        self.buf["it"] = torch.zeros(S, dtype=torch.int64, device=device)
        self.buf["done"] = torch.zeros(S, dtype=torch.bool, device=device)

    def factor(self, A, B, z):
        """Factor the node matrices of every slice, z (S, N), in the store."""
        store = self.buf["store"]
        LU, perm, dinv = _factor_into(store, A, B, z.reshape(-1))
        if LU.data_ptr() != store.data_ptr():
            raise RuntimeError("the sliced program's factor left its store")
        self.buf["LUb"] = LU
        for name, t in (("permb", perm), ("invL", dinv[0]), ("invU", dinv[1])):
            self._put(name, t)

    def load(self, A, B, Q, z, w, geom):
        for name, t in (("A", A), ("B", B), ("Q", Q), ("z", z), ("w", w), ("geom", geom)):
            if t is not None:
                self._put(name, t)

    def _rr(self):
        b = self.buf
        active = ~b["done"] & (b["it"] <= self.iters)
        Qo, Aq, Bq, lam, X, R, res, inside, worst, ok = _rr_step(
            b["Q"], b["A"], b.get("B"), "cholqr2", "circle", b["geom"], self.mixed_eig)
        done = inside.any(-1) & (worst < self.tol)
        for name, t in (("lam", lam), ("X", X), ("R", R), ("res", res), ("inside", inside)):
            keep = active.reshape((-1,) + (1,) * (t.dim() - 1))
            if name in b:
                b[name].copy_(torch.where(keep, t, b[name]))
            else:
                b[name] = t.clone()
        b["done"].copy_(torch.where(active, done, b["done"]))
        b["it"].add_(active.long())
        out = {"Qo": Qo, "Aq": Aq, "status": _status(b["done"], ok | ~active)}
        if Bq is not None:
            out["Bq"] = Bq
        return out

    def _update(self):
        b = self.buf
        Qn = _node_update_scan(b["LUb"], b["permb"], b["z"], b["w"], b["X"], b["R"],
                               b["lam"], self.solve_dtype, b["A"], b.get("B"),
                               dinvb=(b["invL"], b["invU"]))
        # the slices still running: not done and below the cap
        go = ~b["done"] & (b["it"] <= self.iters)
        b["Q"].copy_(torch.where(go[:, None, None], Qn, b["Q"]))
        return {}

    def _full_rr(self, o: dict, s: int) -> bool:
        """Slice s's Rayleigh-Ritz again with the full eig, where its mixed
        eig's guard failed (JAX's lax.cond, that slice alone); returns its
        done flag, also written to the device."""
        b = self.buf
        self.fallbacks += 1
        if "Bq" in o:
            lam, Xq = eigmod._gen_eig_full(o["Aq"][s], o["Bq"][s])
        else:
            lam, Xq = eigmod._eig_full(o["Aq"][s])
        lam, X, R, res = _ritz_pairs(o["Qo"][s], b["A"], b.get("B"), lam, Xq)
        inside = ct.in_region(lam, "circle", b["geom"][:, s])
        for name, t in (("lam", lam), ("X", X), ("R", R), ("res", res), ("inside", inside)):
            b[name][s].copy_(t)
        done = bool(inside.any()) and float(torch.max(torch.where(inside, res, 0.0))) < self.tol
        b["done"][s] = done
        return done

    def run(self) -> list:
        """Every slice's FeastResult (lam, X, res, inside, n_iter, converged),
        as its own loop would give it: the update of a slice's last allowed
        sweep, or of its done sweep, is dead, and the host runs the update
        step only while some slice runs on."""
        b, iters = self.buf, self.iters
        b["it"].zero_()
        b["done"].zero_()
        S = b["it"].shape[0]
        done, it = [False] * S, [0] * S
        self.sweeps = self.fallbacks = 0
        while any(not d and i <= iters for d, i in zip(done, it)):
            active = [not d and i <= iters for d, i in zip(done, it)]
            o = self._step("rr")
            flags, oks = self._read(o["status"])
            for s in range(S):
                if active[s]:
                    done[s] = bool(flags[s]) if oks[s] else self._full_rr(o, s)
                    it[s] += 1
            self.sweeps += 1
            if any(not d and i <= iters for d, i in zip(done, it)):
                self._step("update")
        return [FeastResult(b["lam"][s].clone(), b["X"][s].clone(), b["res"][s].clone(),
                            b["inside"][s].clone(), it[s], done[s]) for s in range(S)]


def _sliced_key(A, B, Q, z, iters, tol, mixed, graphs):
    """The signature a sliced program and its graphs are cached under: S,
    n, m0, nodes, dtype, B present, iters, tol, mixed and the backend
    switches (the circles, nodes and weights are buffer contents)."""
    return (("sliced", str(Q.device), Q.dtype) + tuple(Q.shape) + (z.shape[1], B is None,
            iters, tol, mixed, graphs) + _backend_key())


def _run_program(graphs, A, B, Q, z, w, contours, iters, tol, mixed):
    """The stacked slices through the cached `_SlicedProgram` of their
    signature (a new signature frees any cached program first, either
    driver's, so the card holds one)."""
    key = _sliced_key(A, B, Q, z, iters, tol, mixed, graphs)
    prog = _PROGRAMS.get(key)
    if prog is None:
        clear_graph_cache()
        S, n, m0 = Q.shape
        prog = _PROGRAMS[key] = _SlicedProgram(
            graphs, Q.device, S=S, N=z.shape[1], n=n,
            solve_dtype=torch.complex64 if mixed else Q.dtype, tol=tol, iters=iters,
            mixed_eig=eigmod._mixed_route(torch.complex128, m0, Q.device))
    prog.factor(A, B, z)
    geom = torch.tensor([k.params for k in contours], dtype=torch.float64)
    prog.load(A, B, Q, z, w, geom.T[..., None].contiguous().to(Q.device))
    return prog.run()


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
    mesh=None runs every slice on this process's `device`.

    The rank's slices run as one program (`_SlicedProgram`, cached with
    `feast_compiled`'s under `solvers.clear_graph_cache`), the factor
    written straight into its store: on the card its steps are CUDA
    graphs; the CPU and the options outside `solvers.feast._graph_scope`
    run them eagerly."""
    return _sliced(True, A, interval, n_slices, B, nodes=nodes, iters=iters, tol=tol,
                   samples=samples, margin=margin, min_m0=min_m0, mesh=mesh, m0=m0,
                   seed=seed, dedup_tol=dedup_tol, mixed_prec=mixed_prec,
                   verbose=verbose, device=device)


def _feast_sliced_parallel_steps(*args, **kw) -> SliceResult:
    """`feast_sliced_parallel` with its sliced program run eagerly on any
    device: the batched steps, static buffers and cache of the graphed
    path, without graphs.  Card tests hold the graphs to it."""
    return _sliced(False, **_bind(args, kw))


def _bind(args, kw) -> dict:
    bound = inspect.signature(feast_sliced_parallel).bind(*args, **kw)
    bound.apply_defaults()
    return bound.arguments


def _sliced(graphs, A, interval, n_slices, B, *, nodes, iters, tol, samples, margin,
            min_m0, mesh, m0, seed, dedup_tol, mixed_prec, verbose, device):
    """The rank's slices through their program, its steps captured as CUDA
    graphs where `graphs` is true and `_graph_scope` allows, else run
    eagerly."""
    from .._device import as_tensor, resolve_device

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
    Q = as_tensor(X0[first:first + count], dt, dev)
    results = _run_program(graphs and _graph_scope(dev, m0, "lu") is None, Ad, Bd, Q, z,
                           w, mine, int(iters), float(tol), bool(mixed_prec))

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
