"""The port's row-sharded sparse FEAST (feast_tpu_torch.parallel.rowsharded)
on gloo ranks: the partition against the JAX package's, and
`feast_iterative_rows` on (4, 2) and (2, 2) ("node", "row") meshes against
the single-process `feast_iterative` (eigenvalues to 1e-10, the same
iteration count), with every all-gather's size recorded: none is as large
as A's nnz, so A never leaves its row shard."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import feast_tpu.cx as jcx
import feast_tpu_torch as ft
from feast_tpu.parallel import rowsharded as jrs
from feast_tpu_torch.parallel import rowsharded as trs

from _torch_ranks import Ranks

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ranks8(tmp_path_factory):
    r = Ranks(8, str(tmp_path_factory.mktemp("ranks8")))
    yield r
    r.close()


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    r = Ranks(4, str(tmp_path_factory.mktemp("ranks4")))
    yield r
    r.close()


def banded(n, bands=4):
    """Banded Hermitian matrix with a graded diagonal (strongly diagonally
    dominant: Jacobi-preconditioned solves converge fast)."""
    diags, offs = [np.arange(1.0, n + 1.0)], [0]
    for k in range(1, bands + 1):
        diags += [np.full(n - k, -0.1 / k)] * 2
        offs += [k, -k]
    return sp.diags(diags, offs, format="csr").astype(np.complex128)


def slice_around(A, lo, hi, B=None):
    import scipy.linalg as sla

    w = np.sort(sla.eigh(A.toarray(), None if B is None else B.toarray(),
                         eigvals_only=True))
    c, r = (w[lo] + w[hi]) / 2, (w[hi] - w[lo]) * 0.7
    return complex(c), float(r), w[np.abs(w - c) <= r]


@pytest.mark.parametrize("n,shards", [(37, 4), (40, 3), (64, 8)])
def test_partition_csr_matches_jax(n, shards):
    A = sp.random(n, n, density=0.15, random_state=0).astype(np.complex128)
    j = jrs.partition_csr(A, shards)
    t = trs.partition_csr(A, shards, device="cpu")
    assert (t.n, t.n_pad, t.rows_loc) == (j.n, j.n_pad, j.rows_loc)
    np.testing.assert_array_equal(t.data.numpy(), jcx.to_numpy(j.data))
    np.testing.assert_array_equal(t.cols.numpy(), np.asarray(j.cols))
    np.testing.assert_array_equal(t.rows.numpy(), np.asarray(j.rows))
    dense = np.zeros((t.n_pad, n), dtype=np.complex128)
    for s in range(shards):
        np.add.at(dense, (s * t.rows_loc + t.rows[s].numpy(), t.cols[s].numpy()),
                  t.data[s].numpy())
    np.testing.assert_array_equal(dense[:n], A.toarray())


def test_partition_and_sharded_amg_default_to_the_card():
    """Like every entry point of the port, they place their arrays on
    "cuda" unless the caller asks for the CPU, and raise without a GPU."""
    A, _, _ = _grid9(8)
    if torch.cuda.is_available():
        assert trs.partition_csr(A, 2).data.is_cuda
        assert trs.build_sharded_amg(A, None, 2, max_coarse=20).Ac.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            trs.partition_csr(A, 2)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            trs.build_sharded_amg(A, None, 2, max_coarse=20)


def _check(outs, ref, want, A, B=None, tol=1e-10):
    for o in outs[1:]:
        np.testing.assert_array_equal(o["lam"], outs[0]["lam"])
        assert o["n_iter"] == outs[0]["n_iter"]
    out = outs[0]
    assert out["converged"] and out["n_iter"] == ref.n_iter
    good = out["inside"] & (out["res"] < tol)
    lam, X = out["lam"][good], out["X"][:, good]
    np.testing.assert_allclose(np.sort(lam.real), want, atol=1e-8)
    lam_r, _, res_r = ref.filtered()
    np.testing.assert_allclose(np.sort(lam.real), np.sort(lam_r[res_r < tol].real),
                               atol=1e-10)
    BX = X if B is None else B @ X
    assert np.linalg.norm(A @ X - BX * lam[None, :], axis=0).max() < 1e-9
    return out


KW = dict(nodes=8, iters=15, tol=1e-10, solve_tol=1e-11, solve_iters=400, spurious=1e-5)


@pytest.mark.parametrize("solver", ["bicgstab", "bicgstab_rr"])
def test_rows_4x2_match_single_jacobi(ranks8, solver):
    n, m0 = 300, 10
    A = banded(n, bands=14)
    c, r, want = slice_around(A, 148, 152)
    rng = np.random.default_rng(1)
    X0 = rng.standard_normal((n, m0)) + 1j * rng.standard_normal((n, m0))
    outs = ranks8.run("rows", A=A, B=None, X0=X0, n_node=4, n_row=2, c=c, r=r,
                      solver=solver, **KW)
    ref = ft.feast_iterative(A, None, X0, c=c, r=r, solver=solver, device="cpu", **KW)
    _check(outs, ref, want, A)
    # A stays on its row shard: the (2 nodes, n_pad, m0) vector blocks are
    # the largest thing gathered, and they are smaller than A's nnz
    worst = max(max(o["gather_sizes"]) for o in outs)
    assert 2 * n * m0 <= worst < A.nnz, (worst, A.nnz)


def test_rows_2x2_generalized(ranks4):
    n = 200
    A = banded(n)
    i = np.arange(n)
    B = sp.diags([1.0 + 0.3 * np.sin(i), np.full(n - 1, 0.01), np.full(n - 1, 0.01)],
                 [0, 1, -1], format="csr").astype(np.complex128)
    c, r, want = slice_around(A, 90, 94, B)
    rng = np.random.default_rng(2)
    X0 = rng.standard_normal((n, 12)) + 1j * rng.standard_normal((n, 12))
    kw = dict(KW, tol=1e-9, solve_iters=500, spurious=1e-4)
    outs = ranks4.run("rows", A=A, B=B, X0=X0, n_node=2, n_row=2, c=c, r=r, **kw)
    ref = ft.feast_iterative(A, B, X0, c=c, r=r, device="cpu", **kw)
    _check(outs, ref, want, A, B, tol=1e-9)


def test_rows_node_chunk_matches_single_chunked(ranks4):
    """node_chunk=2 on a (2, 2) mesh solves each rank's four nodes in two
    chunks, as the single-process chunked run does."""
    n = 200
    A = banded(n, bands=6)
    c, r, want = slice_around(A, 90, 94)
    rng = np.random.default_rng(4)
    X0 = rng.standard_normal((n, 8)) + 1j * rng.standard_normal((n, 8))
    outs = ranks4.run("rows", A=A, B=None, X0=X0, n_node=2, n_row=2, c=c, r=r,
                      node_chunk=2, **KW)
    ref = ft.feast_iterative(A, None, X0, c=c, r=r, device="cpu", node_chunk=2, **KW)
    _check(outs, ref, want, A)


def _grid9(g):
    K = sp.diags([2.0 * np.ones(g), -np.ones(g - 1), -np.ones(g - 1)], [0, 1, -1])
    I = sp.identity(g)
    A = (sp.kron(K, I) + sp.kron(I, K) + 0.25 * sp.kron(K, K)).tocsr().astype(np.complex128)

    def ev(i, j):
        li, lj = (2 - 2 * np.cos(k * np.pi / (g + 1)) for k in (i, j))
        return li + lj + 0.25 * li * lj

    return A, np.sort([ev(1, 1), ev(1, 2), ev(2, 1)]), ev(2, 2)


@pytest.mark.parametrize("mesh", [(4, 2), (2, 2)])
def test_rows_amg_lowest_slice(ranks8, ranks4, mesh):
    """The row-sharded AMG V-cycle on the lowest slice of a 2-D 9-point
    Laplacian (where Jacobi stalls): every level's product shard-local."""
    g, m0 = 24, 4
    A, want, nxt = _grid9(g)
    c = complex((want[0] + want[-1]) / 2)
    r = float(min((want[-1] - want[0]) * 0.75,
                  (nxt - want[-1]) * 0.8 + (want[-1] - want[0]) / 2))
    rng = np.random.default_rng(3)
    X0 = rng.standard_normal((g * g, m0)) + 1j * rng.standard_normal((g * g, m0))
    kw = dict(nodes=8, iters=10, tol=1e-9, solve_tol=1e-11, solve_iters=150,
              spurious=1e-4, precondition="amg")
    ranks = ranks8 if mesh == (4, 2) else ranks4
    outs = ranks.run("rows", A=A, B=None, X0=X0, n_node=mesh[0], n_row=mesh[1], c=c,
                     r=r, amg_opts={"max_coarse": 80}, **kw)
    ref = ft.feast_iterative(A, None, X0, c=c, r=r, device="cpu",
                             amg_opts={"max_coarse": 80, "aggregate": "strength"}, **kw)
    _check(outs, ref, want, A, tol=1e-9)
    # nothing larger than a (local nodes, n, m0) vector block is gathered,
    # and on the (4, 2) mesh that block is smaller than A's nnz
    worst = max(max(o["gather_sizes"]) for o in outs)
    block = (8 // mesh[0]) * g * g * m0
    assert worst == block and (mesh != (4, 2) or block < A.nnz), (worst, block, A.nnz)


def test_sharded_amg_levels_partition_the_host_hierarchy():
    from feast_tpu_torch.ops import amg as amgmod

    A, _, _ = _grid9(16)
    host, Ac, _, _ = amgmod.build_amg_host(A, None, aggregate="strength", max_coarse=40)
    amg = trs.build_sharded_amg(A, None, 3, max_coarse=40, device="cpu")
    assert len(amg.levels) == len(host) >= 1
    for L, (Au, Bu, P, R) in zip(amg.levels, host):
        for sh, M in ((L.A, Au), (L.P, P), (L.R, R)):
            dense = np.zeros((sh.n_pad, M.shape[1]), dtype=np.complex128)
            for s in range(3):
                np.add.at(dense, (s * sh.rows_loc + sh.rows[s].numpy(), sh.cols[s].numpy()),
                          sh.data[s].numpy())
            np.testing.assert_allclose(dense[:M.shape[0]], M.toarray(), atol=1e-15)
        np.testing.assert_array_equal(L.dA.numpy()[:Au.shape[0]], Au.diagonal())
    np.testing.assert_array_equal(amg.Ac.numpy(), Ac)


def test_rows_ranks_agree_when_their_products_round_differently(ranks4):
    """On the card a CSR product accumulates with atomics, so four node
    groups repeating the Rayleigh-Ritz phase get Ritz pairs that differ in
    the last bit; rank 0's are broadcast, and every rank still returns the
    same converged result as one process."""
    n, m0 = 300, 10
    A = banded(n, bands=14)
    c, r, want = slice_around(A, 148, 152)
    rng = np.random.default_rng(1)
    X0 = rng.standard_normal((n, m0)) + 1j * rng.standard_normal((n, m0))
    outs = ranks4.run("rows", A=A, B=None, X0=X0, n_node=4, n_row=1, c=c, r=r, skew=True,
                      **KW)
    ref = ft.feast_iterative(A, None, X0, c=c, r=r, device="cpu", **KW)
    _check(outs, ref, want, A)
    for o in outs[1:]:
        np.testing.assert_array_equal(o["X"], outs[0]["X"])
