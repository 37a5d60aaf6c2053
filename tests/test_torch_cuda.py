"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with sm_90a (H100) and nvcc; elsewhere they
skip.  The file imports neither JAX nor feast_tpu, so on a machine without
JAX it runs with the repository's root conftest disabled:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import feast_tpu_torch as ft
from feast_tpu_torch.ops import lu, panel_lu, schur_kernel

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("j0", [0, 128])
def test_panel_kernel_matches_plain(dev, j0):
    g = torch.Generator(device=dev).manual_seed(j0)
    base = torch.randn((2, 384, 128), dtype=torch.complex64, device=dev, generator=g)
    sk, pk, ik = panel_lu.panel_factor(base.clone(), j0)
    sp, pp, ip = panel_lu.panel_factor_plain(base.clone(), j0)
    assert torch.equal(pk, pp)
    assert torch.equal(sk, sp)
    assert float((ik - ip).abs().max()) < 1e-5


def test_lu_factor_dispatches_to_panel_kernel(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    A = torch.randn((3, 256, 256), dtype=torch.complex64, device=dev, generator=g)
    before = panel_lu.launches
    LU, perm = lu.lu_factor(A)
    assert panel_lu.launches - before == 2          # one launch per panel
    for i in range(3):
        L = torch.tril(LU[i], -1) + torch.eye(256, device=dev)
        err = (A[i][perm[i]] - L @ torch.triu(LU[i])).abs().max()
        assert float(err) / float(A[i].abs().max()) < 2e-5   # ~ n eps32
    LUp, permp = panel_lu.lu_factor_panel(A, panel=panel_lu.panel_factor_plain)
    assert torch.equal(perm, permp)


@pytest.mark.parametrize("n", [2, 16, 48])
def test_schur_kernel_invariants(dev, n):
    g = torch.Generator(device=dev).manual_seed(n)
    A = torch.randn((n, n), dtype=torch.complex64, device=dev, generator=g)
    T, Z, Y, X = schur_kernel.schur(A, want_y=True)
    Tp = schur_kernel.schur_plain(A)[0]
    eye = torch.eye(n, dtype=A.dtype, device=dev)
    assert float(torch.tril(T, -1).abs().max()) == 0.0
    assert float((Z.mH @ Z - eye).abs().max()) < 2e-5
    assert float(torch.linalg.norm(A @ Z - Z @ T) / torch.linalg.norm(A)) < 2e-5
    assert float((X @ Y - eye).abs().max()) < 1e-4
    lk = np.sort_complex(torch.diagonal(T).cpu().numpy())
    lp = np.sort_complex(torch.diagonal(Tp).cpu().numpy())
    assert np.abs(lk - lp).max() / np.abs(lp).max() < 1e-4


def test_feast_on_card_golden_and_kernel_use(dev):
    A = np.diag(np.arange(1.0, 26.0)).astype(np.complex128)
    rng = np.random.default_rng(0)
    X0 = rng.standard_normal((25, 5)) + 1j * rng.standard_normal((25, 5))
    before = schur_kernel.launches
    res = ft.feast_compiled(A, X0, c=1.5, r=2.0, nodes=8, tol=1e-12,
                            mixed_prec=True, device=dev)
    lam, X, r = res.filtered()
    assert res.converged and r.max() < 1e-12
    np.testing.assert_allclose(np.sort(lam.real), [1.0, 2.0, 3.0], atol=1e-10)
    assert schur_kernel.launches > before
