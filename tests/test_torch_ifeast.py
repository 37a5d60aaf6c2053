"""The port's sparse iterative FEAST slice end to end, against feast_tpu and
exact spectra, on the CPU (torch complex128 against JAX x64): eigenvalues
to 1e-10 against the JAX result and the same number of refinement sweeps."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import feast_tpu as jt
import feast_tpu_torch as ft
from feast_tpu.ops import sparse as jsp
from feast_tpu_torch.ops import sparse as tsp

tif = importlib.import_module("feast_tpu_torch.solvers.ifeast")

torch.set_num_threads(2)


def _rand(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def lap1d(n):
    return sp.diags([np.full(n, 2.0), -np.ones(n - 1), -np.ones(n - 1)],
                    [0, 1, -1], format="csr").astype(np.complex128)


def lap_exact(n):
    return 2.0 - 2.0 * np.cos(np.pi * np.arange(1, n + 1) / (n + 1))


def build_pencil(N):
    """benchmarks/sparse1m.py's pencil: K = T (+) T, B = M (x) M, and the
    exact separable spectrum."""
    T1 = sp.diags([np.full(N, 2.0), -np.ones(N - 1), -np.ones(N - 1)], [0, 1, -1], format="csr")
    M1 = sp.diags([np.full(N, 4 / 6), np.full(N - 1, 1 / 6), np.full(N - 1, 1 / 6)],
                  [0, 1, -1], format="csr")
    I = sp.identity(N, format="csr")
    K = (sp.kron(T1, I) + sp.kron(I, T1)).tocsr().astype(np.complex128)
    B = sp.kron(M1, M1).tocsr().astype(np.complex128)
    k = np.arange(1, N + 1)
    t = 2 - 2 * np.cos(k * np.pi / (N + 1))
    m = (2 + np.cos(k * np.pi / (N + 1))) / 3
    lam = np.sort(((t[:, None] + t[None, :]) / (m[:, None] * m[None, :])).ravel())
    return K, B, lam


# a small edge-of-spectrum slice shared by the option tests below
N_SMALL = 120
SMALL_KW = dict(c=0.004 + 0j, r=0.004, nodes=8, tol=1e-9, device="cpu")
JAX_KW = {k: v for k, v in SMALL_KW.items() if k != "device"}


def small_problem(m0=10, seed=2):
    exact = lap_exact(N_SMALL)
    want = np.sort(exact[np.abs(exact - 0.004) <= 0.004])
    return lap1d(N_SMALL), _rand(np.random.default_rng(seed), N_SMALL, m0), want


def _eigs(res):
    lam, _, r = res.filtered()
    return np.sort(lam.real), r


def _same_as_jax(rt, rj, atol=1e-10):
    """Eigenvalues to atol against the JAX result, and the same sweep count."""
    np.testing.assert_allclose(_eigs(rt)[0], np.sort(rj.filtered()[0].real), atol=atol)
    assert rt.n_iter == int(rj.n_iter) and rt.converged == bool(rj.converged)


def test_ifeast_diag_matches_jax():
    A = np.diag(np.arange(1.0, 26.0)).astype(np.complex128)
    X0 = _rand(np.random.default_rng(0), 25, 5)
    kw = dict(nodes=8, iters=10, c=1.5 + 0j, r=2.0, tol=1e-10)
    rj = jt.ifeast(A, X0, **kw)
    rt = ft.ifeast(A, X0, device="cpu", **kw)
    lt, _ = _eigs(rt)
    np.testing.assert_allclose(lt, [1.0, 2.0, 3.0], atol=1e-8)
    np.testing.assert_allclose(lt, np.sort(rj.filtered()[0].real), atol=1e-8)
    assert rt.n_iter == int(rj.n_iter) and rt.converged == bool(rj.converged)


def test_feast_iterative_dia_slice_matches_jax():
    """The 1-D Laplacian n = 300 slice fed as a pre-built DIA operator."""
    n = 300
    L = lap1d(n)
    X0 = _rand(np.random.default_rng(0), n, 24)
    kw = dict(c=0.02 + 0j, r=0.02, nodes=8, iters=25, tol=1e-9)
    opj, opt = jsp.as_operator(L), tsp.as_operator(L, device="cpu")
    assert isinstance(opj, jsp.DIA) and isinstance(opt, tsp.DIA)
    rj = jt.feast_iterative(opj, None, X0, **kw)
    rt = ft.feast_iterative(opt, None, X0, device="cpu", **kw)
    lt, res = _eigs(rt)
    exact = lap_exact(n)
    want = np.sort(exact[(exact > 0.0) & (exact < 0.04)])
    assert rt.converged and bool(rj.converged)
    assert len(lt) == len(want) and res.max() < 1e-9
    np.testing.assert_allclose(lt, want, atol=1e-10)
    np.testing.assert_allclose(lt, np.sort(rj.filtered()[0].real), atol=1e-10)
    assert rt.n_iter == int(rj.n_iter)
    assert rt.n_sweeps == rt.n_iter      # the converged sweep's solves are not run


@pytest.mark.parametrize("aggregate", ["auto", "strength"])
def test_feast_iterative_pencil_amg_f32_vcycle_matches_jax(aggregate):
    """The headline configuration at N = 24: generalized grid pencil, lowest
    slice, AMG with a complex64 V-cycle under the complex128 recurrence,
    bicgstab_rr, 8 nodes, m0 = 8; against the JAX package and the exact
    separable spectrum.  "auto" gives DIA levels with STRETCH transfers,
    "strength" (what the 1M-dof run on the card uses) a DIA level 0 with
    CSR transfers and CSR coarse levels."""
    N = 24
    K, B, lam = build_pencil(N)
    c, r = complex((lam[0] + lam[4]) / 2), float((lam[4] - lam[0]) * 0.75)
    exact = lam[np.abs(lam - c) <= r]
    X0 = _rand(np.random.default_rng(0), N * N, 8)
    kw = dict(c=c, r=r, nodes=8, iters=8, tol=1e-10, precondition="amg",
              solver="bicgstab_rr", solve_tol=1e-9, solve_iters=120)
    opts = {"max_coarse": 100, "aggregate": aggregate}
    rj = jt.feast_iterative(K, B, X0, amg_opts=dict(opts, dtype=jnp.float32), **kw)
    rt = ft.feast_iterative(K, B, X0, device="cpu",
                            amg_opts=dict(opts, dtype=torch.float32), **kw)
    lt, res = _eigs(rt)
    assert rt.converged and bool(rj.converged) and len(lt) == len(exact) == 6
    np.testing.assert_allclose(lt, exact, rtol=1e-9)
    np.testing.assert_allclose(lt, np.sort(rj.filtered()[0].real), atol=1e-10)
    assert rt.n_iter == int(rj.n_iter)
    lamf, Xf, _ = rt.filtered()
    host = np.linalg.norm(K @ Xf - (B @ Xf) * lamf[None, :], axis=0)
    assert host.max() < 1e-10 and res.max() < 1e-10


def test_feast_iterative_node_chunk_equals_full_batch():
    L, X0, want = small_problem()
    kw = dict(SMALL_KW, iters=25)
    full = ft.feast_iterative(L, None, X0, **kw)
    chunked = ft.feast_iterative(L, None, X0, node_chunk=2, **kw)
    lf, _ = _eigs(full)
    lc, rc = _eigs(chunked)
    assert full.converged and chunked.converged and full.n_iter == chunked.n_iter
    assert len(lc) == len(want) and rc.max() < 1e-9
    np.testing.assert_allclose(lc, lf, atol=1e-10)
    np.testing.assert_allclose(lc, want, atol=1e-10)
    _same_as_jax(chunked, jt.feast_iterative(L, None, X0, node_chunk=2, iters=25, **JAX_KW))
    with pytest.raises(ValueError):
        ft.feast_iterative(L, None, X0, node_chunk=3, **kw)


def test_feast_iterative_host_rr_matches_jax():
    L, X0, want = small_problem()
    kw = dict(c=0.004 + 0j, r=0.004, nodes=8, iters=25, tol=1e-9, rr="host",
              node_chunk=4, solve_iters=300)
    rj = jt.feast_iterative(L, None, X0, **kw)
    rt = ft.feast_iterative(L, None, X0, device="cpu", **kw)
    lt, res = _eigs(rt)
    assert rt.converged and len(lt) == len(want) and res.max() < 1e-9
    np.testing.assert_allclose(lt, want, atol=1e-10)
    np.testing.assert_allclose(lt, np.sort(rj.filtered()[0].real), atol=1e-10)
    assert rt.n_iter == int(rj.n_iter)
    with pytest.raises(ValueError):
        ft.feast_iterative(L, None, X0, rr="nowhere", **SMALL_KW)


def test_feast_iterative_keep_q_stepping_equals_continuous():
    """iters=0 + keep_q steps one sweep per call; restarted from Q it walks
    the same iterates as the continuous loop."""
    L, X0, want = small_problem()
    cont = ft.feast_iterative(L, None, X0, iters=25, solve_iters=300, **SMALL_KW)
    X, steps, out = X0, 0, None
    for _ in range(12):
        out = ft.feast_iterative(L, None, X, iters=0, keep_q=True, nit0=steps,
                                 solve_iters=300, **SMALL_KW)
        if out.converged:
            break
        assert out.Q is not None and out.n_sweeps == 1
        X = out.Q
        steps += 1
    ls, rs = _eigs(out)
    assert out.converged and cont.converged and steps == cont.n_iter
    assert len(ls) == len(want) and rs.max() < 1e-9
    np.testing.assert_allclose(ls, _eigs(cont)[0], atol=1e-10)
    rj = jt.feast_iterative(L, None, X0, iters=25, solve_iters=300, **JAX_KW)
    _same_as_jax(cont, rj)
    np.testing.assert_allclose(ls, np.sort(rj.filtered()[0].real), atol=1e-10)
    assert steps == int(rj.n_iter)
    assert ft.feast_iterative(L, None, X, iters=0, solve_iters=300, **SMALL_KW).Q is None


def test_feast_iterative_warm_starts_round_trip():
    """keep_warm returns the node solutions; warm0 seeds the next call's
    solves, in the caller's row numbering also under a reordering.  With a
    zero iteration budget the solver hands its start back, so the round
    trip is exact up to the column scaling (1e-12)."""
    L, X0, _ = small_problem()
    kw = dict(SMALL_KW, tol=1e-15, solve_iters=300)      # never stops: every call sweeps
    first = ft.feast_iterative(L, None, X0, iters=1, keep_q=True, keep_warm=True, **kw)
    assert first.warm.shape == (8, N_SMALL, X0.shape[1]) and first.n_sweeps == 2
    assert ft.feast_iterative(L, None, X0, iters=0, **kw).warm is None
    rng = np.random.default_rng(8)
    W = _rand(rng, 8, N_SMALL, X0.shape[1])
    p = rng.permutation(N_SMALL)
    for A, reorder, chunk in ((L, None, None), (L[p][:, p].tocsr(), "rcm", 4)):
        back = ft.feast_iterative(A, None, first.Q, iters=0, warm0=W, keep_warm=True,
                                  reorder=reorder, node_chunk=chunk,
                                  **dict(kw, solve_iters=0))
        np.testing.assert_allclose(back.warm.numpy(), W, rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError):
        ft.feast_iterative(L, None, X0, warm0=first.warm[:4], **SMALL_KW)


def test_feast_iterative_auto_m0_matches_jax():
    """m0="auto": the stochastic count through the same node solves sizes
    the subspace; same probes (numpy, seeded), so the same m0 as JAX."""
    n = 200
    A = lap1d(n)
    exact = lap_exact(n)
    sel = exact[7:11]                         # an interior slice
    c = complex((sel[0] + sel[-1]) / 2)
    r = float((sel[-1] - sel[0]) / 2 + 0.4 * min(sel[0] - exact[6], exact[11] - sel[-1]))
    n_in = int(np.sum(np.abs(exact - c) <= r))
    kw = dict(c=c, r=r, nodes=8, iters=12, tol=1e-10, precondition="amg",
              solver="bicgstab_rr", solve_tol=1e-10, solve_iters=400,
              amg_opts={"max_coarse": 60}, m0="auto")
    rj = jt.feast_iterative(A, None, None, **kw)
    rt = ft.feast_iterative(A, None, None, device="cpu", **kw)
    lt, _ = _eigs(rt)
    assert rt.converged and len(lt) == n_in
    assert rt.X.shape[1] == rj.X.shape[1] >= n_in + 4
    np.testing.assert_allclose(lt, exact[np.abs(exact - c) <= r], rtol=1e-8)
    np.testing.assert_allclose(lt, np.sort(rj.filtered()[0].real), atol=1e-10)
    assert rt.n_iter == int(rj.n_iter)
    with pytest.raises(ValueError, match="m0"):
        ft.feast_iterative(A, None, None, c=1.0 + 0j, r=0.5, device="cpu")


@pytest.mark.parametrize("solver", ["bicgstab_rr", "bicgstabl", "gmres"])
def test_feast_iterative_solvers(solver):
    L, X0, want = small_problem()
    kw = dict(iters=25, solver=solver, solve_iters=120 if solver == "gmres" else 300,
              gmres_restart=30, rhs_chunk=5 if solver == "gmres" else None)
    out = ft.feast_iterative(L, None, X0, **kw, **SMALL_KW)
    lam, res = _eigs(out)
    assert out.converged and len(lam) == len(want) and res.max() < 1e-9
    np.testing.assert_allclose(lam, want, atol=1e-10)
    # against the JAX package where the node solves converge (AMG, a loose
    # solve_tol so that it takes more than one sweep): under Jacobi the
    # restarted BiCGStab ends at its cap at the node beside the real axis,
    # and the sweep count then follows rounding noise in both packages
    kw.update(solve_iters=120, solve_tol=1e-3, precondition="amg",
              amg_opts={"max_coarse": 30})
    out = ft.feast_iterative(L, None, X0, **kw, **SMALL_KW)
    np.testing.assert_allclose(_eigs(out)[0], want, atol=1e-10)
    _same_as_jax(out, jt.feast_iterative(L, None, X0, **kw, **JAX_KW))


def test_feast_iterative_tol_mode_contour_and_spurious():
    n, scale = 200, 1e7
    d = scale * np.arange(1.0, n + 1.0)
    A = sp.diags(d).tocsr().astype(complex)
    X0 = _rand(np.random.default_rng(0), n, 6)
    common = dict(c=2.5 * scale + 0j, r=2.0 * scale, nodes=8, iters=10,
                  solver="bicgstab_rr", solve_tol=1e-12, solve_iters=300,
                  precondition="jacobi")
    rj = jt.feast_iterative(A, None, X0, tol=1e-10, tol_mode="contour", **common)
    common["device"] = "cpu"
    assert not ft.feast_iterative(A, None, X0, tol=1e-10, **common).converged
    out = ft.feast_iterative(A, None, X0, tol=1e-10, tol_mode="contour", **common)
    assert out.converged
    _same_as_jax(out, rj, atol=1e-10 * scale)     # 1e-10 relative to the spectrum's scale
    got = np.sort(out.lam.numpy().real[out.inside.numpy()])
    assert np.allclose(got, d[:4], rtol=1e-8)
    # the two-tier stop accepts once every non-spurious inside value passes
    out2 = ft.feast_iterative(A, None, X0, tol=1e-10, tol_mode="contour",
                              spurious=1e-3 * scale, **common)
    assert out2.converged and out2.n_iter <= out.n_iter


def test_feast_iterative_reorder_and_preconditioner_forms():
    """A banded pencil under a random permutation is RCM-reordered onto the
    DIA path and the vectors come back in the caller's numbering; generalized
    pencil with Jacobi, a callable and no preconditioner."""
    n = 90
    rng = np.random.default_rng(6)
    p = rng.permutation(n)
    L, M = lap1d(n), sp.diags([np.full(n, 4 / 6), np.full(n - 1, 1 / 6), np.full(n - 1, 1 / 6)],
                              [0, 1, -1], format="csr").astype(np.complex128)
    Lp, Mp = L[p][:, p].tocsr(), M[p][:, p].tocsr()
    ref = np.sort(np.linalg.eigvals(np.linalg.solve(M.toarray(), L.toarray())).real)
    c, r = complex((ref[0] + ref[2]) / 2), float((ref[2] - ref[0]) * 0.7)
    want = ref[np.abs(ref - c) <= r]
    X0 = _rand(rng, n, 8)
    kw = dict(c=c, r=r, nodes=8, iters=20, tol=1e-9, solve_iters=600)

    def callable_precond(z):
        return tsp.jacobi_preconditioner(tsp.as_operator(Lp, device="cpu"),
                                         tsp.as_operator(Mp, device="cpu"), z)

    for precondition, reorder in (("jacobi", "auto"), (callable_precond, None),
                                  (None, "rcm"), (True, False)):
        out = ft.feast_iterative(Lp, Mp, X0, precondition=precondition,
                                 reorder=reorder, device="cpu", **kw)
        if not callable(precondition):
            _same_as_jax(out, jt.feast_iterative(Lp, Mp, X0, precondition=precondition,
                                                 reorder=reorder, **kw))
        lam, X, res = out.filtered()
        assert out.converged and len(lam) == len(want)
        np.testing.assert_allclose(np.sort(lam.real), want, atol=1e-9)
        host = np.linalg.norm(Lp @ X - (Mp @ X) * lam[None, :], axis=0)
        assert host.max() < 1e-8          # residual against the caller's numbering


def test_feast_iterative_unported_and_device_default():
    """mesh= and chunk_ckpt / resume_chunk are ported (test_torch_parallel,
    test_torch_orchestrate); the compositions the JAX package refuses
    raise."""
    L, X0, _ = small_problem()
    with pytest.raises(ValueError, match="X0=None"):
        ft.feast_iterative(L, None, None, m0=4, mesh=object(), **SMALL_KW)
    with pytest.raises(ValueError, match="rr='host'"):
        ft.feast_iterative(L, None, X0, rr="host", mesh=object(), **SMALL_KW)
    with pytest.raises(ValueError, match="chunk_ckpt"):
        ft.feast_iterative(L, None, X0, chunk_ckpt=print, mesh=object(), **SMALL_KW)
    with pytest.raises(ValueError):
        ft.feast_iterative(L, None, X0, solver="cg", **SMALL_KW)
    if not torch.cuda.is_available():      # entry points default to the card
        with pytest.raises(RuntimeError):
            ft.feast_iterative(L, None, X0, c=0.004, r=0.004)
        with pytest.raises(RuntimeError):
            ft.ifeast(np.eye(4), np.ones((4, 1)))
