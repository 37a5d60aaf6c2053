"""feast_tpu_torch LU (plain blocked path and the panel kernel's plain
version) against feast_tpu on the same seeded inputs.  The JAX panel
kernel runs in Pallas interpret mode, as its own tests run it."""

import numpy as np
import pytest
import torch

from feast_tpu import cx as jcx
from feast_tpu.ops import lu as jlu
from feast_tpu.ops import pallas_lu
from feast_tpu_torch.ops import lu as tlu
from feast_tpu_torch.ops import panel_lu

torch.set_num_threads(2)


def _rand(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _np(pair):
    return jcx.to_numpy(pair)


@pytest.mark.parametrize("n", [64, 200])
def test_lu_factor_matches_jax_complex128(n):
    A = _rand(np.random.default_rng(n), n, n)
    LUj, pj = jlu.lu_factor(jcx.from_numpy(A))
    LUt, pt = tlu.lu_factor(torch.as_tensor(A))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    LUj = _np(LUj)
    assert np.abs(LUt.numpy() - LUj).max() / np.abs(LUj).max() < 1e-12


def test_lu_solve_with_and_without_dinv():
    n, k = 200, 7
    rng = np.random.default_rng(7)
    A, B = _rand(rng, n, n), _rand(rng, n, k)
    LU, perm = tlu.lu_factor(torch.as_tensor(A))
    Bt = torch.as_tensor(B)
    X0 = tlu.lu_solve(LU, perm, Bt)
    dinv = tlu.lu_diag_inv(LU, 64)
    X1 = tlu.lu_solve(LU, perm, Bt, dinv=dinv)
    scale = np.abs(X0.numpy()).max()
    assert np.abs(X1.numpy() - X0.numpy()).max() / scale < 1e-12
    jLU, jperm = jlu.lu_factor(jcx.from_numpy(A))
    Xj = _np(jlu.lu_solve(jLU, jperm, jcx.from_numpy(B)))
    assert np.abs(X0.numpy() - Xj).max() / scale < 1e-12
    jdinv = jlu.lu_diag_inv(jLU, 64)
    for got, ref in zip(dinv, jdinv):
        assert np.abs(got.numpy() - _np(ref)).max() < 1e-10
    assert np.abs(A @ X0.numpy() - B).max() / np.abs(B).max() < 1e-12


def test_batched_solve_matches_per_matrix():
    rng = np.random.default_rng(8)
    A = _rand(rng, 3, 40, 40) + 4 * np.eye(40)
    B = _rand(rng, 3, 40, 2)
    X = tlu.solve_batched(torch.as_tensor(A), torch.as_tensor(B)).numpy()
    for i in range(3):
        Xi = tlu.solve(torch.as_tensor(A[i]), torch.as_tensor(B[i])).numpy()
        np.testing.assert_allclose(X[i], Xi, atol=1e-13)
        Xj = _np(jlu.solve(jcx.from_numpy(A[i]), jcx.from_numpy(B[i])))
        np.testing.assert_allclose(X[i], Xj, atol=1e-12)


@pytest.mark.parametrize("j0", [0, 32])
def test_panel_plain_matches_pallas_interpret(j0):
    n, b = 96, 32
    S = _rand(np.random.default_rng(9 + j0), n, b)
    sj, pj, ilj = pallas_lu.panel_slab_pallas(jcx.from_numpy(S, np.float32),
                                              j0, interpret=True)
    slab = torch.as_tensor(S, dtype=torch.complex64)[None].clone()
    st, pt, ilt = panel_lu.panel_factor(slab, j0)      # CPU: the plain version
    assert st is slab                                  # in place, like the kernel
    np.testing.assert_array_equal(pt[0].numpy(), np.asarray(pj))
    sj = _np(sj)
    assert np.abs(st[0].numpy() - sj).max() / np.abs(sj).max() < 5e-6
    assert np.abs(ilt[0].numpy() - _np(ilj)).max() < 5e-5
    L11 = np.tril(st[0].numpy()[j0:j0 + b], -1) + np.eye(b)
    assert np.abs(ilt[0].numpy() @ L11 - np.eye(b)).max() < 1e-5


def test_lu_factor_panel_plain_matches_pallas_interpret():
    n, block = 96, 32
    A = _rand(np.random.default_rng(10), n, n)
    LUj, pj = pallas_lu.lu_factor_pallas(jcx.from_numpy(A, np.float32),
                                         block=block, interpret=True)
    LUt, pt = panel_lu.lu_factor_panel(torch.as_tensor(A, dtype=torch.complex64),
                                       block=block)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    LUj = _np(LUj)
    # the trailing matmuls of XLA and torch round in different orders:
    # entries agree to ~n * eps32 of max|LU|
    assert np.abs(LUt.numpy() - LUj).max() / np.abs(LUj).max() < n * 1.2e-7 * 4
    L = np.tril(LUt.numpy(), -1) + np.eye(n)
    U = np.triu(LUt.numpy())
    assert np.abs(L @ U - A[pt.numpy()]).max() / np.abs(A).max() < 5e-6


def test_zero_pivot_guard_matches_jax():
    n = 64
    A = np.zeros((n, n), complex)
    A[: n // 2, : n // 2] = np.eye(n // 2)   # rank n/2: exact zero pivots
    LUj, pj = jlu.lu_factor(jcx.from_numpy(A))
    LUt, pt = tlu.lu_factor(torch.as_tensor(A))
    assert np.isfinite(LUt.numpy()).all()
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(LUt.numpy(), _np(LUj))
    # the guarded solve is finite too (inverse iteration at an exact shift)
    X = tlu.lu_solve(LUt, pt, torch.ones((n, 1), dtype=torch.complex128))
    assert np.isfinite(X.numpy()).all()
    # panel path, complex64
    sj, pjs, _ = pallas_lu.panel_slab_pallas(
        jcx.from_numpy(A[:, :32], np.float32), 32, interpret=True)
    slab = torch.as_tensor(A[:, :32], dtype=torch.complex64)[None].clone()
    st, pts, ilt = panel_lu.panel_factor(slab, 32)
    assert np.isfinite(st.numpy()).all() and np.isfinite(ilt.numpy()).all()
    np.testing.assert_array_equal(pts[0].numpy(), np.asarray(pjs))
    np.testing.assert_array_equal(st[0].numpy(), _np(sj))


def test_panel_checks_shapes():
    with pytest.raises(ValueError, match="block"):
        panel_lu.lu_factor_panel(torch.zeros((100, 100), dtype=torch.complex64))
    with pytest.raises(ValueError, match="b <= 128"):
        panel_lu.panel_factor(torch.zeros((1, 256, 129), dtype=torch.complex64), 0)
    with pytest.raises(ValueError, match="j0"):
        panel_lu.panel_factor(torch.zeros((1, 64, 32), dtype=torch.complex64), 40)
