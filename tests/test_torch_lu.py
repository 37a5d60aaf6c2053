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
from feast_tpu_torch.ops import panel_lu, row_swap

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


def _panel_perm(rng, batch, n, j, b):
    """A panel's row permutation as the panel kernel composes it: b swaps of
    pivot row g = j + k with a row p >= g; the first pivot keeps its row,
    the second takes one of the panel's own rows, the third the bottom row."""
    perm = np.tile(np.arange(n), (batch, 1))
    for m in range(batch):
        for k in range(b):
            g = j + k
            p = {0: g, 1: min(g + 5, j + b - 1), 2: n - 1}.get(k, rng.integers(g, n))
            perm[m, [g, p]] = perm[m, [p, g]]
    return torch.as_tensor(perm, dtype=torch.int32)


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("n,b", [(256, 128), (384, 128), (96, 32)])
@pytest.mark.parametrize("where", ["first", "middle", "last"])
def test_row_swap_plain_is_the_row_gather(batch, n, b, where):
    """The row swaps' plain version against A[perm] in the columns outside
    the panel (the panel's own columns untouched), and its count of the rows
    that moved against the permutation's, at most 2b."""
    j = {"first": 0, "middle": (n // b // 2) * b, "last": n - b}[where]
    rng = np.random.default_rng(n + batch + j)
    perm = _panel_perm(rng, batch, n, j, b)
    A = torch.as_tensor(_rand(rng, batch, n, n), dtype=torch.complex64)
    got = A.clone()
    moved = torch.zeros((), dtype=torch.int64)
    row_swap.apply_panel_perm(got, perm, j, b, moved)          # CPU: the plain version
    want = torch.stack([A[m][perm[m].long()] for m in range(batch)])
    want[:, :, j:j + b] = A[:, :, j:j + b]
    assert torch.equal(got, want)
    count = int((perm != torch.arange(n, dtype=torch.int32)).sum())
    assert int(moved) == count <= 2 * b * batch


@pytest.mark.parametrize("route", ["plain", "panel"])
def test_factor_scan_factors_its_own_buffer(monkeypatch, route):
    """`_factor_scan` forms the node matrices in a factor buffer and factors
    them there: the LU and perm of `lu_factor` on a copy of the stacked node
    matrices, to n eps32, and its LU a view of that buffer.  "panel" sends
    complex64 on the CPU down the kernel route (zero-padded to 256, the
    panel step's and the row swaps' plain versions)."""
    import importlib

    fmod = importlib.import_module("feast_tpu_torch.solvers.feast")
    if route == "panel":
        monkeypatch.setattr(tlu, "_kernel_route", lambda dtype, device: dtype == torch.complex64)
    made, factor_buffer = [], tlu.factor_buffer

    def recorded(*a, **k):
        made.append(factor_buffer(*a, **k))
        return made[-1]

    monkeypatch.setattr(tlu, "factor_buffer", recorded)
    n = 200
    rng = np.random.default_rng(11)
    A = torch.as_tensor(_rand(rng, n, n))
    z = torch.as_tensor(_rand(rng, 4))
    LU, perm, _ = fmod._factor_scan(A, None, z, True)
    S = torch.stack([fmod._shifted_single(A, None, zi) for zi in z]).to(torch.complex64)
    LUr, permr = tlu.lu_factor(S)
    assert LU.shape == (4, n, n) and len(made) == 1
    assert made[0].shape[-1] == (256 if route == "panel" else n)
    assert LU.untyped_storage().data_ptr() == made[0].untyped_storage().data_ptr()
    assert torch.equal(perm, permr)
    assert float((LU - LUr).abs().max() / LUr.abs().max()) <= n * 1.2e-7


def test_accumulating_panel_factor_matches_pallas_interpret_batched():
    """The panel route's trailing update accumulated by the matrix product
    (A22 += -1 * L21 @ U12) and its row swaps on the moved rows, over a
    batch of two, each matrix against the JAX panel kernel in interpret
    mode within `test_lu_factor_panel_plain_matches_pallas_interpret`'s
    tolerance; the moved rows counted against the permutations."""
    n, block = 96, 32
    rng = np.random.default_rng(12)
    A = _rand(rng, 2, n, n)
    moved = torch.zeros((), dtype=torch.int64)
    pbs = []
    step = panel_lu.panel_factor_plain

    def panel(slab, j0):
        out = step(slab, j0)
        pbs.append((j0, out[1].clone()))
        return out

    LUt, pt = panel_lu.lu_factor_panel(torch.as_tensor(A, dtype=torch.complex64),
                                       block=block, panel=panel, moved=moved)
    for m in range(2):
        LUj, pj = pallas_lu.lu_factor_pallas(jcx.from_numpy(A[m], np.float32),
                                             block=block, interpret=True)
        np.testing.assert_array_equal(pt[m].numpy(), np.asarray(pj))
        LUj = _np(LUj)
        assert np.abs(LUt[m].numpy() - LUj).max() / np.abs(LUj).max() < n * 1.2e-7 * 4
    count = sum(int((pb[:, j0:] != torch.arange(j0, n, dtype=pb.dtype)).sum())
                for j0, pb in pbs)
    assert int(moved) == count > 0
