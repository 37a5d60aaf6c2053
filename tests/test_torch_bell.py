"""The port's blocked-ELL operator (ops/sparse.py BELL) and the paths that
pick it, against feast_tpu and scipy on the CPU: the product, diagonal and
dense form; the block structure, spill split, plan and block-size choice,
which must equal the JAX package's; the block ordering of
`reorder.aggregate_block_permutation`; the AMG levels; interop; and
feast_iterative on an unstructured FEM pencil.

Tolerances: products in complex128 to 1e-12 (relative to the largest
entry where it exceeds 1) of scipy and of the JAX operator; structures
exactly; eigenvalues to 1e-10 of the JAX result with the same iteration
count."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import scipy.sparse as sp
import torch

import feast_tpu as jt
import feast_tpu_torch as ft
from feast_tpu import cx as jcx
from feast_tpu import problems as jprob
from feast_tpu.ops import amg as jamg
from feast_tpu.ops import reorder as jrd
from feast_tpu.ops import sparse as jsp
from feast_tpu_torch import interop
from feast_tpu_torch.ops import amg as tamg
from feast_tpu_torch.ops import reorder as trd
from feast_tpu_torch.ops import sparse as tsp

tif = importlib.import_module("feast_tpu_torch.solvers.ifeast")

torch.set_num_threads(2)


def _rand_sparse(n, m, density, seed):
    A = sp.random(n, m, density=density, random_state=seed, dtype=np.float64)
    A = A + 1j * sp.random(n, m, density=density, random_state=seed + 1)
    return A.tocsr()


def _x(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _fem_rcm(n_points, seed):
    K, M, _ = jprob.fem2d_unstructured(n_points, seed=seed)
    perm = jrd.rcm_permutation(K)
    return K[perm][:, perm].tocsr(), M[perm][:, perm].tocsr()


@pytest.mark.parametrize("bs", [4, 16, 33])
def test_bell_product_matches_scipy_and_jax(bs):
    n, m = 237, 190  # not divisible by bs: both paddings
    A = _rand_sparse(n, m, 0.03, 1)
    X = _x(np.random.default_rng(0), m, 7)
    Ab = tsp.BELL.from_scipy(A, bs, device="cpu")
    Aj = jsp.BELL.from_scipy(A, bs)
    Y = Ab.matvec(torch.as_tensor(X)).numpy()
    np.testing.assert_allclose(Y, A @ X, rtol=0, atol=1e-12)
    np.testing.assert_allclose(Y, jcx.to_numpy(Aj.matvec(jcx.from_numpy(X))),
                               rtol=0, atol=1e-12)
    np.testing.assert_array_equal(Ab.todense().numpy(), A.toarray())
    assert np.array_equal(Ab.colb.numpy(), np.asarray(Aj.colb))
    assert (Ab.bs, Ab.kmax, Ab.nnz) == (Aj.bs, Aj.kmax, Aj.nnz)
    np.testing.assert_array_equal(Ab.data.numpy(), jcx.to_numpy(Aj.data))


def test_bell_diagonal_pair_and_spill_match_jax():
    n = 200
    A = _rand_sparse(n, n, 0.05, 3)
    A.setdiag(np.arange(1.0, n + 1.0))
    A = A.tocsr()
    Ab = tsp.BELL.from_scipy(A, 16, device="cpu")
    np.testing.assert_allclose(Ab.diagonal().numpy(), A.diagonal(), rtol=0, atol=0)
    B = A.copy()
    B.data = np.random.default_rng(4).standard_normal(B.nnz) + 0j
    for kcap in ("auto", 2):
        A1, B1 = tsp.BELL.pair_from_scipy(A, B, 8, kcap=kcap, device="cpu")
        Aj, Bj = jsp.BELL.pair_from_scipy(A, B, 8, kcap=kcap)
        assert A1.colb is B1.colb  # one shared structure (the AMG union invariant)
        assert np.array_equal(A1.colb.numpy(), np.asarray(Aj.colb))
        assert A1.kmax == Aj.kmax
        assert (A1.spill is None) == (Aj.spill is None)
        if A1.spill is not None:
            assert np.array_equal(A1.spill.indices.numpy(), np.asarray(Aj.spill.indices))
            assert np.array_equal(A1.spill.row_ids.numpy(), np.asarray(Aj.spill.row_ids))
            assert np.array_equal(A1.spill.indices.numpy(), B1.spill.indices.numpy())
        np.testing.assert_allclose(B1.todense().numpy(), B.toarray(), rtol=0, atol=1e-15)
        np.testing.assert_allclose(A1.diagonal().numpy(), A.diagonal(), rtol=0, atol=1e-15)
    assert tsp.BELL.pair_from_scipy(A, B, 8, kcap=2, device="cpu")[0].spill is not None


def test_bell_plan_pick_and_bytes_match_jax():
    Kp, _ = _fem_rcm(1200, 7)
    for bs in (8, 16, 32, 64):
        assert tsp.bell_plan(Kp, bs) == jsp.bell_plan(Kp, bs)
        assert tsp.bell_fill(Kp, bs) == jsp.bell_fill(Kp, bs)
    assert tsp.bell_pick_bs(Kp) == jsp.bell_pick_bs(Kp) >= 32
    R = _rand_sparse(3000, 3000, 2e-4, 11)   # point sparsity: CSR or bs 8
    assert tsp.bell_pick_bs(R) == jsp.bell_pick_bs(R)
    assert tsp.bell_pick_bs(R) in (None, 8)
    # the byte model of the caps: the JAX package's, TPU tile padding included
    for bs in (8, 16, 32, 64):
        assert tsp.bell_hbm_bytes(Kp, bs) == jsp.bell_hbm_bytes(Kp, bs)
        assert (tsp.bell_hbm_bytes(Kp, bs, torch.float32)
                == jsp.bell_hbm_bytes(Kp, bs, jnp.float32))
    # a cap below every candidate leaves CSR
    assert tsp.bell_pick_bs(Kp, max_bytes=1.0) is None
    assert isinstance(tsp.as_operator(Kp, bell_max_bytes=1.0, device="cpu"), tsp.CSR)


def test_strength_hierarchy_picks_match_jax_under_binding_caps(monkeypatch):
    """The 1M-dof grid pencil's strength-aggregated hierarchy (K = T (+) T,
    B = M (x) M, as the sparse path solves it) at N = 200, with the AMG
    builders' byte caps scaled by n / 1e6 so that they bind as at full size:
    every level's operator pair, P and R take the same format and block
    size in both packages, host structure only.  The caps bind: level 0's
    P is priced over its cap at every block size and falls to CSR."""
    N, scale = 200, 200 * 200 / 1e6
    T1 = sp.diags([np.full(N, 2.0), -np.ones(N - 1), -np.ones(N - 1)], [0, 1, -1])
    M1 = sp.diags([np.full(N, 4 / 6), np.full(N - 1, 1 / 6), np.full(N - 1, 1 / 6)],
                  [0, 1, -1])
    K = (sp.kron(T1, sp.identity(N)) + sp.kron(sp.identity(N), T1)).tocsr()
    B = sp.kron(M1, M1).tocsr()
    levels, _, _, _ = tamg.build_amg_host(K.astype(complex), B.astype(complex),
                                          aggregate="strength")
    t_pick, j_pick = tsp._bell_pick, jsp.bell_pick_bs
    monkeypatch.setattr(tamg, "_bell_pick",
                        lambda A, dtype, max_bytes: t_pick(A, dtype, max_bytes * scale))
    monkeypatch.setattr(jsp, "bell_pick_bs", lambda A, dtype=None, max_bytes=1.0e9:
                        j_pick(A, dtype, max_bytes * scale))
    kinds = []
    for Au, Bu, P, R in levels:
        pairs = ((tamg._pair_ops(Au, Bu, torch.complex64, "cpu"),
                  jamg._pair_ops(Au, Bu, jnp.float32)),
                 ((tamg._csr_op(P, torch.complex64, "cpu"),), (jamg._csr_op(P, jnp.float32),)),
                 ((tamg._csr_op(R, torch.complex64, "cpu"),), (jamg._csr_op(R, jnp.float32),)))
        for t_ops, j_ops in pairs:
            for t_op, j_op in zip(t_ops, j_ops):
                assert type(t_op).__name__ == type(j_op).__name__
                assert getattr(t_op, "bs", None) == getattr(j_op, "bs", None)
                assert getattr(t_op, "kmax", None) == getattr(j_op, "kmax", None)
            kinds.append(type(t_ops[0]).__name__)
    assert len(levels) >= 3 and "BELL" in kinds and "DIA" in kinds
    P0 = levels[0][2]
    assert isinstance(tamg._csr_op(P0, torch.complex64, "cpu"), tsp.CSR)
    assert t_pick(P0, torch.complex64, 1.0e30)[0] is not None


def test_as_operator_picks_bell_where_jax_does():
    Kp, _ = _fem_rcm(800, 2)
    op, opj = tsp.as_operator(Kp, device="cpu"), jsp.as_operator(Kp)
    assert isinstance(op, tsp.BELL) and isinstance(opj, jsp.BELL)
    assert op.bs == opj.bs and op.kmax == opj.kmax
    X = _x(np.random.default_rng(0), Kp.shape[0], 5)
    np.testing.assert_allclose(op.matvec(torch.as_tensor(X)).numpy(), Kp @ X,
                               rtol=0, atol=1e-12)
    pinned = tsp.as_operator(Kp, bell_bs=8, device="cpu")
    assert isinstance(pinned, tsp.BELL) and pinned.bs == 8
    assert isinstance(tsp.as_operator(Kp, bell_bs=64, bell_max_fill=1.0, device="cpu"), tsp.CSR)


def test_aggregate_block_permutation_matches_jax():
    K, _, _ = jprob.fem2d_unstructured(900, seed=3)
    for bs in (8, 32):
        p = trd.aggregate_block_permutation(K, bs=bs)
        assert np.array_equal(p, jrd.aggregate_block_permutation(K, bs=bs))
        assert np.array_equal(np.sort(p), np.arange(K.shape[0]))


def test_bell_node_batch_chunks_and_raw_matrix(monkeypatch):
    """Per-node data (the shifted level operators) against X (nodes, n, m);
    a gather cap small enough to split the block rows into chunks gives
    the same product; `_raw_matrix` rebuilds the matrix, spill included."""
    Kp, Mp = _fem_rcm(500, 4)
    Ab, Bb = tsp.BELL.pair_from_scipy(Kp, Mp, 8, kcap=3, device="cpu")
    assert Ab.spill is not None
    z = torch.tensor([0.5 + 0.1j, -1.0 + 2.0j], dtype=torch.complex128)
    S = tamg._shifted_op(Ab, Bb, z)
    X = _x(np.random.default_rng(1), 2, Kp.shape[0], 3)
    Y = S.matvec(torch.as_tensor(X)).numpy()
    for i in range(2):
        want = (Kp - complex(z[i]) * Mp) @ X[i]
        np.testing.assert_allclose(Y[i], want, rtol=0, atol=1e-12 * np.abs(want).max())
    # one operator for every node (the transfers): the nodes fold into columns
    Ya = Ab.matvec(torch.as_tensor(X)).numpy()
    for i in range(2):
        want = Kp @ X[i]
        np.testing.assert_allclose(Ya[i], want, rtol=0, atol=1e-12 * np.abs(want).max())
    monkeypatch.setattr(tsp, "_gather_cap", lambda device: 4096)
    np.testing.assert_allclose(S.matvec(torch.as_tensor(X)).numpy(), Y, rtol=0, atol=1e-13)
    np.testing.assert_allclose(Ab.matvec(torch.as_tensor(X)).numpy(), Ya, rtol=0, atol=1e-13)
    np.testing.assert_allclose(tif._raw_matrix(Ab).toarray(), Kp.toarray(), rtol=0, atol=0)


def test_interop_carries_a_jax_bell_across():
    Kp, _ = _fem_rcm(500, 5)
    for kcap in ("auto", 3):
        Aj = jsp.BELL.from_scipy(Kp, 16, kcap=kcap)
        At = interop.operator_from(Aj, device="cpu")
        assert isinstance(At, tsp.BELL) and At.bs == 16
        assert (At.spill is None) == (Aj.spill is None)
        X = _x(np.random.default_rng(2), Kp.shape[0], 4)
        np.testing.assert_allclose(At.matvec(torch.as_tensor(X)).numpy(),
                                   jcx.to_numpy(Aj.matvec(jcx.from_numpy(X))),
                                   rtol=0, atol=1e-12)
        np.testing.assert_allclose(At.diagonal().numpy(), Kp.diagonal(), rtol=0, atol=1e-15)


def test_amg_levels_pick_bell_where_jax_does():
    """Strength aggregation of an unstructured FEM pencil: every level's
    operator pair, P and R in the JAX package's format and block size; one
    V-cycle from each package's own hierarchy agrees to 1e-10."""
    Kp, Mp = _fem_rcm(1500, 1)
    ht = tamg.build_amg(Kp, Mp, aggregate="strength", max_coarse=60, device="cpu")
    hj = jamg.build_amg(Kp, Mp, aggregate="strength", max_coarse=60)
    assert len(ht.levels) == len(hj.levels) >= 2
    assert isinstance(ht.levels[0].A_op, tsp.BELL)
    for Lt, Lj in zip(ht.levels, hj.levels):
        for t_op, j_op in ((Lt.A_op, Lj.A_op), (Lt.B_op, Lj.B_op), (Lt.P, Lj.P),
                           (Lt.R, Lj.R)):
            assert type(t_op).__name__ == type(j_op).__name__
            assert getattr(t_op, "bs", None) == getattr(j_op, "bs", None)
    zc = 5.0 + 2.0j
    X = _x(np.random.default_rng(7), Kp.shape[0], 3)
    want = jcx.to_numpy(jax.jit(lambda h, z, x: jamg.shifted_preconditioner(h, z)(x))(
        hj, jcx.as_cx(zc), jcx.from_numpy(X)))
    got = tamg.shifted_preconditioner(
        ht, torch.tensor(zc, dtype=torch.complex128))(torch.as_tensor(X)).numpy()
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-10
    # complex64 V-cycle: the BELL levels cast with their spill
    got32 = tamg.shifted_preconditioner(
        ht, torch.tensor(zc, dtype=torch.complex128), dtype=torch.float32)(
            torch.as_tensor(X)).numpy()
    assert np.abs(got32 - want).max() / np.abs(want).max() < 1e-4


def test_feast_iterative_unstructured_fem_matches_jax():
    """The lowest slice of a Delaunay P1 pencil given in its random point
    order: reorder="auto" (RCM), AMG with BELL levels, bicgstab_rr; the
    eigenvectors come back in the caller's numbering."""
    K, M, _ = jprob.fem2d_unstructured(400, seed=1)
    n = K.shape[0]
    exact = sla.eigh(K.toarray().real, M.toarray().real, eigvals_only=True)
    c = (exact[0] + exact[4]) / 2
    r = (exact[4] - exact[0]) * 0.6 + (exact[5] - exact[4]) * 0.2
    want = exact[np.abs(exact - c) <= r]
    X0 = _x(np.random.default_rng(8), n, 10)
    kw = dict(c=complex(c), r=float(r), nodes=8, iters=10, tol=1e-10,
              precondition="amg", solver="bicgstab_rr", solve_tol=1e-9,
              solve_iters=150, amg_opts={"max_coarse": 60})
    out = ft.feast_iterative(K, M, X0, device="cpu", **kw)
    outj = jt.feast_iterative(K, M, X0, **kw)
    assert out.converged and bool(outj.converged)
    lam, X, res = out.filtered()
    np.testing.assert_allclose(np.sort(lam.real), want, rtol=1e-9)
    np.testing.assert_allclose(np.sort(lam.real), np.sort(outj.filtered()[0].real),
                               rtol=0, atol=1e-10)
    assert out.n_iter == int(outj.n_iter)
    assert res.max() < 1e-10
    host = np.linalg.norm(K @ X - (M @ X) * lam[None, :], axis=0)
    assert host.max() < 1e-10
