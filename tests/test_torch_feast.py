"""The port's dense FEAST slice end to end, against feast_tpu and the
reference goldens, on the CPU (torch complex128 against JAX x64)."""

import ast
import importlib
import pathlib

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import feast_tpu as jt
import feast_tpu_torch as ft

# the package exports the function `feast`, which shadows the module name
tfeast = importlib.import_module("feast_tpu_torch.solvers.feast")

torch.set_num_threads(2)

PKG = pathlib.Path(__file__).resolve().parent.parent / "feast_tpu_torch"


def _x0(rng, n, m):
    return rng.standard_normal((n, m)) + 1j * rng.standard_normal((n, m))


@pytest.fixture
def diag25():
    A = np.diag(np.arange(1.0, 26.0)).astype(np.complex128)
    return A, _x0(np.random.default_rng(0), 25, 5)


def _bench_problem(n, m0, seed=0):
    """bench.py's _problem at reduced n: diag(1..n) + 0.05 complex noise."""
    rng = np.random.default_rng(seed)
    A = np.diag(np.arange(1.0, n + 1.0)).astype(np.complex128)
    A += 0.05 * (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
    return A, _x0(rng, n, m0)


@pytest.mark.parametrize("mixed_prec", [False, True])
def test_feast_diag_golden(diag25, mixed_prec):
    A, X0 = diag25
    res = ft.feast(A, X0, c=1.5 + 0j, r=2.0, nodes=8, iters=10, tol=1e-12,
                   mixed_prec=mixed_prec, device="cpu")
    lam, X, r = res.filtered()
    assert res.converged
    np.testing.assert_allclose(np.sort(lam.real), [1.0, 2.0, 3.0], atol=1e-10)
    assert np.abs(lam.imag).max() < 1e-10
    assert r.max() < 1e-12
    assert np.linalg.norm(A @ X - X * lam[None, :], axis=0).max() < 1e-12


def test_feast_compiled_mixed_matches_jax():
    n, m0 = 256, 16
    A, X0 = _bench_problem(n, m0)
    kw = dict(c=5.5 + 0j, r=5.2, nodes=16, iters=20, tol=1e-10, mixed_prec=True)
    rj = jt.feast_compiled(A, X0, **kw)
    rt = ft.feast_compiled(A, X0, device="cpu", **kw)
    assert rj.converged and rt.converged
    assert abs(rt.n_iter - int(rj.n_iter)) <= 1
    lj, _, resj = rj.filtered()
    lt, Xt, rest = rt.filtered()
    assert len(lt) == len(lj) == 10
    np.testing.assert_allclose(np.sort_complex(lt), np.sort_complex(lj),
                               rtol=0, atol=1e-10)
    assert rest.max() < 1e-10 and resj.max() < 1e-10
    assert np.linalg.norm(A @ Xt - Xt * lt[None, :], axis=0).max() < 1e-10


def test_feast_compiled_single_tier_and_full_precision(diag25):
    A, X0 = diag25
    for kw in (dict(mixed_prec=True, two_tier=False), dict(mixed_prec=False)):
        res = ft.feast_compiled(A, X0, c=1.5, r=2.0, nodes=8, tol=1e-12,
                                device="cpu", **kw)
        lam, _, r = res.filtered()
        assert res.converged and r.max() < 1e-12
        np.testing.assert_allclose(np.sort(lam.real), [1.0, 2.0, 3.0], atol=1e-10)


def test_gen_feast_identity_B_matches_feast(diag25):
    A, X0 = diag25
    kw = dict(c=1.5 + 0j, r=2.0, nodes=8, device="cpu")
    rg = ft.gen_feast(A, np.eye(25, dtype=np.complex128), X0, **kw)
    rs = ft.feast(A, X0, **kw)
    lg, _, r = rg.filtered()
    ls, _, _ = rs.filtered()
    np.testing.assert_allclose(np.sort(lg.real), [1.0, 2.0, 3.0], atol=1e-10)
    np.testing.assert_allclose(np.sort(lg.real), np.sort(ls.real), atol=1e-12)
    assert r.max() < 1e-12
    assert rg.n_iter == rs.n_iter


def test_store_false_and_contours_match(diag25):
    A, X0 = diag25
    ref = ft.feast(A, X0, c=1.5, r=2.0, nodes=8, device="cpu")
    res = ft.feast(A, X0, c=1.5, r=2.0, nodes=8, store=False, device="cpu")
    np.testing.assert_allclose(np.sort(res.filtered()[0].real),
                               np.sort(ref.filtered()[0].real), atol=1e-12)
    rect = ft.rectangular_contour_gauss(-0.5 - 1j, 3.5 + 1j, 16)
    lam, _, r = ft.feast(A, X0, rect, tol_mode="contour", device="cpu").filtered()
    np.testing.assert_allclose(np.sort(lam.real), [1.0, 2.0, 3.0], atol=1e-10)


def test_entry_points_raise_without_cuda(diag25, monkeypatch):
    A, X0 = diag25
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ft.feast(A, X0, c=1.5, r=2.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        ft.feast_compiled(A, X0, c=1.5, r=2.0, mixed_prec=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        ft.gen_feast(A, np.eye(25), X0, c=1.5, r=2.0)


@pytest.mark.parametrize("kw", [dict(mesh=SimpleNamespace(device_type="cuda"))],
                         ids=["mesh"])
def test_unported_arguments_raise(diag25, kw):
    """Every argument is ported; a mesh= whose device type is not the
    driver's `device` raises (mesh= itself is held in test_torch_parallel)."""
    A, X0 = diag25
    with pytest.raises(ValueError, match="mesh"):
        ft.feast(A, X0, c=1.5, r=2.0, device="cpu", **kw)


def test_dims_validated(diag25):
    A, X0 = diag25
    with pytest.raises(ValueError, match="square"):
        ft.feast(A[:, :20], X0, device="cpu")
    with pytest.raises(ValueError, match="X0"):
        ft.feast(A, X0[:20], device="cpu")


def test_resolvent_on_node_is_finite():
    z = torch.tensor([2.0 + 0j], dtype=torch.complex128)
    w = torch.tensor([0.5 + 0j], dtype=torch.complex128)
    lam = torch.tensor([2.0 + 0j, 1.0 + 0j], dtype=torch.complex128)
    phi = tfeast._resolvent(w[:, None], z[:, None], lam[None, :])
    assert torch.isfinite(phi).all() and abs(phi[0, 1] - 0.5) < 1e-15


def test_package_never_imports_jax_or_feast_tpu():
    banned = {"jax", "jaxlib", "feast_tpu"}
    files = sorted(PKG.rglob("*.py"))
    assert len(files) >= 14
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                roots = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = {node.module.split(".")[0]}
            else:
                continue
            assert not roots & banned, f"{path} imports {roots & banned}"
