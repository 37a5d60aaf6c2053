"""feast_tpu_torch SA-AMG against feast_tpu: the host setup builds the same
hierarchy, a hierarchy carried across by interop gives the same V-cycle
(1e-10 in complex128, 1e-4 in complex64: different summation orders in
the level products and the coarse LU), and the preconditioned Krylov solve
converges in the same number of iterations."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from feast_tpu import cx as jcx
from feast_tpu.ops import amg as jamg
from feast_tpu.ops import krylov as jkr
from feast_tpu.ops import sparse as jsp
from feast_tpu_torch import interop
from feast_tpu_torch.ops import amg as tamg
from feast_tpu_torch.ops import krylov as tkr
from feast_tpu_torch.ops import sparse as tsp

torch.set_num_threads(2)


def lap1d(n):
    return sp.diags([np.full(n, 2.0), -np.ones(n - 1), -np.ones(n - 1)],
                    [0, 1, -1], format="csr").astype(np.complex128)


def mass1d(n):
    return sp.diags([np.full(n, 4 / 6), np.full(n - 1, 1 / 6), np.full(n - 1, 1 / 6)],
                    [0, 1, -1], format="csr").astype(np.complex128)


def _grid_pencil(N):
    I = sp.identity(N, format="csr")
    K = (sp.kron(lap1d(N), I) + sp.kron(I, lap1d(N))).tocsr()
    return K, sp.kron(mass1d(N), mass1d(N)).tocsr()


def _lowest_node(N):
    """Contour node next to the real axis for the lowest slice of the grid
    pencil (8 trapezoid nodes, the exact separable spectrum)."""
    k = np.arange(1, N + 1)
    t, m = 2 - 2 * np.cos(k * np.pi / (N + 1)), (2 + np.cos(k * np.pi / (N + 1))) / 3
    lam = np.sort(((t[:, None] + t[None, :]) / (m[:, None] * m[None, :])).ravel())
    c, r = (lam[0] + lam[4]) / 2, (lam[4] - lam[0]) * 0.75
    return complex(c + r * np.exp(1j * np.pi / 8))


def _rand(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def test_union_pair_and_aggregate_match_jax():
    A = sp.random(50, 50, density=0.1, random_state=1).astype(np.complex128)
    B = sp.random(50, 50, density=0.1, random_state=2).astype(np.complex128)
    Au, Bu = tamg._union_pair(A, B)
    Auj, Buj = jamg._union_pair(A, B)
    assert np.array_equal(Au.indices, Bu.indices) and np.array_equal(Au.indptr, Bu.indptr)
    np.testing.assert_array_equal(Au.toarray(), A.toarray())
    np.testing.assert_array_equal(Bu.toarray(), B.toarray())
    assert np.array_equal(Au.indices, Auj.indices) and np.array_equal(Bu.data, Buj.data)
    L = lap1d(200) + sp.random(200, 200, density=0.02, random_state=3)
    agg, n_agg = tamg._aggregate(L.tocsr(), 0.08)
    aggj, n_aggj = jamg._aggregate(L.tocsr(), 0.08)
    assert n_agg == n_aggj and np.array_equal(agg, aggj)


@pytest.mark.parametrize("aggregate", ["auto", "strength"])
def test_build_amg_matches_jax_hierarchy(aggregate):
    """Same levels, sizes, formats (BELL where the JAX package stores BELL)
    and data (1e-12) from the port's own host setup."""
    n = 3000
    ht = tamg.build_amg(lap1d(n), mass1d(n), aggregate=aggregate, device="cpu")
    hj = jamg.build_amg(lap1d(n), mass1d(n), aggregate=aggregate)
    assert len(ht.levels) == len(hj.levels) >= 1
    assert tamg.hierarchy_nnz(ht)[0] == jamg.hierarchy_nnz(hj)[0]
    np.testing.assert_allclose(ht.Ac.numpy(), jcx.to_numpy(hj.Ac), atol=1e-12)
    np.testing.assert_allclose(ht.Bc.numpy(), jcx.to_numpy(hj.Bc), atol=1e-12)
    rng = np.random.default_rng(0)
    for Lt, Lj in zip(ht.levels, hj.levels):
        assert isinstance(Lt.A_op, tsp.DIA) and isinstance(Lj.A_op, jsp.DIA)
        assert Lt.A_op.offsets == Lt.B_op.offsets == Lj.A_op.offsets
        np.testing.assert_allclose(Lt.A_op.data.numpy(), jcx.to_numpy(Lj.A_op.data), atol=1e-12)
        np.testing.assert_allclose(Lt.B_op.data.numpy(), jcx.to_numpy(Lj.B_op.data), atol=1e-12)
        np.testing.assert_allclose(Lt.dA.numpy(), jcx.to_numpy(Lj.dA), atol=1e-12)
        if aggregate == "auto":
            assert isinstance(Lt.P, tsp.STRETCH) and isinstance(Lt.R, tsp.STRETCHT)
        else:
            assert isinstance(Lt.P, (tsp.BELL, tsp.CSR))
        for t_op, j_op in ((Lt.P, Lj.P), (Lt.R, Lj.R)):
            assert type(t_op).__name__ == type(j_op).__name__
            assert getattr(t_op, "bs", None) == getattr(j_op, "bs", None)
        xc = _rand(rng, Lt.P.shape[1], 2)
        np.testing.assert_allclose(Lt.P.matvec(torch.as_tensor(xc)).numpy(),
                                   jcx.to_numpy(Lj.P.matvec(jcx.from_numpy(xc))), atol=1e-12)
        y = _rand(rng, Lt.P.shape[0], 2)
        np.testing.assert_allclose(Lt.R.matvec(torch.as_tensor(y)).numpy(),
                                   jcx.to_numpy(Lj.R.matvec(jcx.from_numpy(y))), atol=1e-12)
    # the union structure reproduces A - z B exactly
    zc = 0.3 + 0.1j
    S = tamg._shifted_op(ht.levels[0].A_op, ht.levels[0].B_op,
                         torch.tensor(zc, dtype=torch.complex128))
    X = _rand(rng, n, 3)
    want = (lap1d(n) - zc * mass1d(n)) @ X
    np.testing.assert_allclose(S.matvec(torch.as_tensor(X)).numpy(), want, atol=1e-12)


@pytest.mark.parametrize("dtype,tol", [(None, 1e-10), ("float32", 1e-4)])
def test_vcycle_matches_jax_on_carried_hierarchy(dtype, tol):
    """One V-cycle on the JAX hierarchy carried across by interop."""
    n = 1500
    hj = jamg.build_amg(lap1d(n), mass1d(n), max_coarse=100)
    ht = interop.amg_from(hj, device="cpu")
    assert len(ht.levels) == len(hj.levels) and ht.Ac.dtype == torch.complex128
    zc = -0.5 + 0.1j
    X = _rand(np.random.default_rng(3), n, 3)
    jdt = None if dtype is None else jnp.float32
    tdt = None if dtype is None else torch.float32
    want = jcx.to_numpy(jax.jit(lambda h, z, x: jamg.shifted_preconditioner(
        h, z, dtype=jdt)(x))(hj, jcx.as_cx(zc), jcx.from_numpy(X)))
    got = tamg.shifted_preconditioner(
        ht, torch.tensor(zc, dtype=torch.complex128), dtype=tdt)(torch.as_tensor(X))
    assert got.dtype == torch.complex128            # cast back at the boundary
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() < tol
    # the V-cycle contracts: ||b - S M b|| well below ||b||
    S = (lap1d(n) - zc * mass1d(n))
    ratio = np.linalg.norm(X - S @ got.numpy(), axis=0) / np.linalg.norm(X, axis=0)
    assert ratio.max() < 0.2


def test_vcycle_strength_aggregates_2d_matches_jax():
    """The hierarchy of the 1M-dof run at a small size: 2-D grid pencil,
    strength aggregation, so a DIA level 0 with BELL or CSR transfers and
    BELL or CSR coarse levels, each as the JAX package picks it.  Each
    package builds its own hierarchy; one V-cycle agrees to 1e-10 in
    complex128."""
    N = 30
    K, B = _grid_pencil(N)
    ht = tamg.build_amg(K, B, aggregate="strength", max_coarse=30, device="cpu")
    hj = jamg.build_amg(K, B, aggregate="strength", max_coarse=30)
    assert len(ht.levels) == len(hj.levels) >= 2
    assert isinstance(ht.levels[0].A_op, tsp.DIA)
    assert isinstance(ht.levels[1].A_op, (tsp.BELL, tsp.CSR))
    for Lt, Lj in zip(ht.levels, hj.levels):
        for t_op, j_op in ((Lt.A_op, Lj.A_op), (Lt.P, Lj.P), (Lt.R, Lj.R)):
            assert type(t_op).__name__ == type(j_op).__name__
            assert getattr(t_op, "bs", None) == getattr(j_op, "bs", None)
    assert [L.A_op.shape for L in ht.levels] == [L.A_op.shape for L in hj.levels]
    zc = 0.004 + 0.002j
    X = _rand(np.random.default_rng(7), N * N, 3)
    want = jcx.to_numpy(jax.jit(lambda h, z, x: jamg.shifted_preconditioner(h, z)(x))(
        hj, jcx.as_cx(zc), jcx.from_numpy(X)))
    got = tamg.shifted_preconditioner(
        ht, torch.tensor(zc, dtype=torch.complex128))(torch.as_tensor(X)).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-10


def test_deep_auto_hierarchy_vcycle_matches_jax_and_scipy():
    """A 5-level "auto" hierarchy of the 2-D grid pencil (N = 60): the
    port's V-cycle, the JAX package's and a plain scipy one written here
    agree to 1e-10, so the three compute the same preconditioner."""
    N = 60
    K, B = _grid_pencil(N)
    zc = _lowest_node(N)
    b = _rand(np.random.default_rng(0), N * N, 2)
    levels, Ac, Bc, _ = tamg.build_amg_host(K, B, max_coarse=20)
    assert len(levels) == 5

    def vcycle(l, r):
        if l == len(levels):
            return np.linalg.solve(Ac - zc * Bc, r)
        Au, Bu, P, R = levels[l]
        S = Au - zc * Bu
        d = S.diagonal()[:, None]
        x = np.zeros_like(r)
        for _ in range(2):
            x = x + (2 / 3) * (r - S @ x) / d
        x = x + P @ vcycle(l + 1, R @ (r - S @ x))
        for _ in range(2):
            x = x + (2 / 3) * (r - S @ x) / d
        return x

    want = vcycle(0, b)
    got = tamg.shifted_preconditioner(
        tamg.build_amg(K, B, max_coarse=20, device="cpu"),
        torch.tensor(zc, dtype=torch.complex128))(torch.as_tensor(b)).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-10
    gotj = jcx.to_numpy(jamg.shifted_preconditioner(
        jamg.build_amg(K, B, max_coarse=20), jcx.as_cx(zc))(jcx.from_numpy(b)))
    assert np.abs(gotj - want).max() / np.abs(want).max() < 1e-10


def test_auto_aggregation_stalls_on_deep_2d_hierarchy():
    """On a 2-D grid "auto" aggregates runs of 3 consecutive rows on every
    banded level: one axis is coarsened, the other never, and the deeper the
    hierarchy the less its V-cycle preconditions the lowest slice.  N = 60
    with 6 levels: BiCGStab ends at its cap of 120 unconverged, where the
    strength-aggregated hierarchy converges in under 30 iterations.  The
    JAX package on the same inputs and its own "auto" hierarchy needs 119 of
    the 120 (held to at least 100 here), so the aggregation is what stalls."""
    N = 60
    K, B = _grid_pencil(N)
    zc = _lowest_node(N)
    zt = torch.tensor(zc, dtype=torch.complex128)
    b = _rand(np.random.default_rng(0), N * N, 2)
    mv = tsp.shifted_matvec(tsp.as_operator(K, device="cpu"), tsp.as_operator(B, device="cpu"), zt)
    sols = {}
    for aggregate in ("auto", "strength"):
        h = tamg.build_amg(K, B, max_coarse=8, aggregate=aggregate, device="cpu")
        assert len(h.levels) >= 5
        sols[aggregate] = tkr.bicgstab_rr(mv, torch.as_tensor(b), tol=1e-9, maxiter=120,
                                          M=tamg.shifted_preconditioner(h, zt))
    assert int(sols["auto"].iters) == 120 and not bool(sols["auto"].converged.all())
    assert int(sols["strength"].iters) < 30 and bool(sols["strength"].converged.all())
    hj = jamg.build_amg(K, B, max_coarse=8)
    assert len(hj.levels) == 6
    mvj = jsp.shifted_matvec(jsp.as_operator(K), jsp.as_operator(B), jcx.as_cx(zc))
    solj = jax.jit(lambda hh, bb: jkr.bicgstab_rr(
        mvj, bb, tol=1e-9, maxiter=120,
        M=jamg.shifted_preconditioner(hh, jcx.as_cx(zc))))(hj, jcx.from_numpy(b))
    assert int(solj.iters) >= 100 > 3 * int(sols["strength"].iters)


def test_vcycle_node_axis_and_options():
    """A (nodes,) tensor of shifts preconditions all nodes at once, equal
    to one call per node (1e-12); nu / cycles pass through like the JAX
    package's."""
    n = 1200
    hj = jamg.build_amg(lap1d(n), max_coarse=100)
    ht = interop.amg_from(hj, device="cpu")
    zs = np.array([-0.5 + 0.1j, 0.2 + 0.3j, -0.1 - 0.4j])
    X = _rand(np.random.default_rng(5), 3, n, 2)
    zt = torch.as_tensor(zs)
    got = tamg.shifted_preconditioner(ht, zt, nu=1, cycles=2)(torch.as_tensor(X)).numpy()
    jM = jax.jit(lambda h, z, x: jamg.shifted_preconditioner(h, z, nu=1, cycles=2)(x))
    for i in range(3):
        one = tamg.shifted_preconditioner(ht, zt[i], nu=1, cycles=2)(torch.as_tensor(X[i]))
        np.testing.assert_allclose(got[i], one.numpy(), atol=1e-12)
        want = jcx.to_numpy(jM(hj, jcx.as_cx(complex(zs[i])), jcx.from_numpy(X[i])))
        assert np.abs(got[i] - want).max() / np.abs(want).max() < 1e-10


def test_zero_diagonal_guard_and_degenerate_hierarchy():
    # problem already <= max_coarse: no levels, M is the coarse LU solve
    n = 40
    h = tamg.build_amg(lap1d(n), max_coarse=100, device="cpu")
    assert len(h.levels) == 0
    zc = 0.3 + 0.2j
    X = _rand(np.random.default_rng(1), n, 2)
    got = tamg.shifted_preconditioner(h, torch.tensor(zc, dtype=torch.complex128))(
        torch.as_tensor(X)).numpy()
    np.testing.assert_allclose((lap1d(n).toarray() - zc * np.eye(n)) @ got, X, atol=1e-12)
    # a shift that zeroes the level diagonal exactly: the guard keeps M finite
    h2 = tamg.build_amg(lap1d(600), max_coarse=100, device="cpu")
    M = tamg.shifted_preconditioner(h2, torch.tensor(2.0 + 0j, dtype=torch.complex128))
    out = M(torch.as_tensor(_rand(np.random.default_rng(2), 600, 2)))
    assert bool(torch.isfinite(out.real).all() and torch.isfinite(out.imag).all())


@pytest.mark.parametrize("vdtype", [None, "float32"])
def test_amg_preconditioned_bicgstab_matches_jax(vdtype):
    """kappa ~ 1e6 shift near the low spectrum edge: AMG-preconditioned
    BiCGStab converges in a handful of iterations in both packages (counts
    within 1), also with the complex64 V-cycle under the complex128
    recurrence; Jacobi does not converge in the same budget."""
    n = 4000
    A = lap1d(n)
    lam1 = 2 - 2 * np.cos(np.pi / (n + 1))
    zc = complex(3.5 * lam1 + 3.0 * lam1 * np.exp(1j * np.pi / 8))
    b = _rand(np.random.default_rng(4), n, 4)
    hj = jamg.build_amg(A)
    ht = tamg.build_amg(A, device="cpu")
    zj, zt = jcx.as_cx(zc), torch.tensor(zc, dtype=torch.complex128)
    Aj, At = jsp.CSR.from_scipy(A), tsp.CSR.from_scipy(A, device="cpu")
    jdt = None if vdtype is None else jnp.float32
    tdt = None if vdtype is None else torch.float32
    sol_j = jax.jit(lambda h, bb: jkr.bicgstab(
        jsp.shifted_matvec(Aj, None, zj), bb, tol=1e-10, maxiter=60,
        M=jamg.shifted_preconditioner(h, zj, dtype=jdt)))(hj, jcx.from_numpy(b))
    mv = tsp.shifted_matvec(At, None, zt)
    sol_t = tkr.bicgstab(mv, torch.as_tensor(b), tol=1e-10, maxiter=60,
                         M=tamg.shifted_preconditioner(ht, zt, dtype=tdt))
    assert bool(sol_t.converged.all()) and bool(np.asarray(sol_j.converged).all())
    assert int(sol_t.iters) <= 30 and abs(int(sol_t.iters) - int(sol_j.iters)) <= 1
    S = A - zc * sp.identity(n)
    assert np.linalg.norm(S @ sol_t.x.numpy() - b) / np.linalg.norm(b) < 1e-9
    sol_jac = tkr.bicgstab(mv, torch.as_tensor(b), tol=1e-10, maxiter=60,
                           M=tsp.jacobi_preconditioner(At, None, zt))
    assert not bool(sol_jac.converged.all())
