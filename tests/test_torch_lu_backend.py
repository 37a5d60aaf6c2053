"""The port's panel-route choice (`set_panel_backend`, `lu_factor` /
`lu_solve` `loop=`), its builders' device defaults and the last argument
gaps, against feast_tpu on the same seeded inputs.

On the CPU the panel kernel (K1) cannot run, so the tests that follow a
route let the CPU stand in for the card (`card_route`): `_kernel_route`
then accepts CPU complex64, and `panel_lu.lu_factor_panel` runs K1's
plain version, as it does for every CPU tensor."""

import importlib
import inspect

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from feast_tpu import contour as jct
from feast_tpu import cx as jcx
from feast_tpu import nep as jnep
from feast_tpu.ops import lu as jlu
from feast_tpu.parallel import rowsharded as jrows
from feast_tpu_torch import contour as tct
from feast_tpu_torch import cx as tcx
from feast_tpu_torch import interop
from feast_tpu_torch import nep as tnep
from feast_tpu_torch.ops import amg as tamg
from feast_tpu_torch.ops import lu as tlu
from feast_tpu_torch.ops import panel_lu
from feast_tpu_torch.ops import sparse as tsp
from feast_tpu_torch.parallel import rowsharded as trows

import feast_tpu_torch as ft

torch.set_num_threads(2)


def _rand(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.fixture(autouse=True)
def restore_backend():
    """The backend is module state; a failing test must not leak "xla"
    into the file's later tests (one xdist worker runs the whole file)."""
    before = tlu._PANEL_BACKEND
    yield
    tlu.set_panel_backend(before)


@pytest.fixture
def card_route(monkeypatch):
    """The CPU stands in for the card on the kernel route; returns the list
    of shapes `panel_lu.lu_factor_panel` was called with."""
    calls = []
    real = panel_lu.lu_factor_panel

    def counted(A, *a, **k):
        calls.append(tuple(A.shape))
        return real(A, *a, **k)

    monkeypatch.setattr(tlu, "_kernel_route", lambda dtype, device: (
        tlu._PANEL_BACKEND == "pallas" and dtype == torch.complex64))
    monkeypatch.setattr(panel_lu, "lu_factor_panel", counted)
    return calls


# ---------------------------------------------------------------------------
# lu_factor / lu_solve loop=
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("loop,n,block", [("unrolled", 200, 0), ("unrolled", 256, 0),
                                         ("fori", 200, 0), ("fori", 256, 0),
                                         ("fori", 200, 64), ("auto", 200, 0),
                                         ("auto", 256, 0)])
def test_lu_factor_loops_match_jax(loop, n, block):
    """Each loop of the JAX package's lu_factor on complex128: factors
    within 1e-12 and the same perms (JAX's "fori" pads n = 200 to its block
    with an identity extension; the port's loop takes a short last panel)."""
    A = _rand(np.random.default_rng(n + block), n, n)
    LUj, pj = jlu.lu_factor(jcx.from_numpy(A), block=block, loop=loop)
    LUt, pt = tlu.lu_factor(torch.as_tensor(A), block=block, loop=loop)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    LUj = jcx.to_numpy(LUj)
    assert np.abs(LUt.numpy() - LUj).max() / np.abs(LUj).max() < 1e-12


@pytest.mark.parametrize("loop", ["unrolled", "fori"])
def test_lu_solve_loops_match_jax(loop):
    n, k = 200, 5
    rng = np.random.default_rng(21)
    A, B = _rand(rng, n, n), _rand(rng, n, k)
    LUj, pj = jlu.lu_factor(jcx.from_numpy(A), loop=loop)
    Xj = jcx.to_numpy(jlu.lu_solve(LUj, pj, jcx.from_numpy(B), loop=loop))
    LUt, pt = tlu.lu_factor(torch.as_tensor(A), loop=loop)
    Xt = tlu.lu_solve(LUt, pt, torch.as_tensor(B), loop=loop).numpy()
    scale = np.abs(Xj).max()
    assert np.abs(Xt - Xj).max() / scale < 1e-12
    assert np.abs(A @ Xt - B).max() / np.abs(B).max() < 1e-12


@pytest.mark.parametrize("dtype,what", [(torch.complex128, "complex64"),
                                        (torch.complex64, "CUDA")])
def test_explicit_pallas_raises_without_fallback(monkeypatch, dtype, what):
    """loop="pallas" fails fast off complex64 or off CUDA, as the JAX
    package's explicit selection does; it never takes the plain loop."""
    def no_plain(*a, **k):
        raise AssertionError("fell back to the plain loop")

    monkeypatch.setattr(tlu, "_lu_factor_plain", no_plain)
    A = torch.as_tensor(_rand(np.random.default_rng(3), 128, 128), dtype=dtype)
    with pytest.raises(ValueError, match=what):
        tlu.lu_factor(A, loop="pallas")


def test_unknown_loops_raise():
    A = torch.eye(8, dtype=torch.complex128)
    with pytest.raises(ValueError, match="loop"):
        tlu.lu_factor(A, loop="scan")
    LU, perm = tlu.lu_factor(A)
    for loop in ("pallas", "scan"):
        with pytest.raises(ValueError, match="loop"):
            tlu.lu_solve(LU, perm, A, loop=loop)


def test_set_panel_backend_names():
    assert tlu._PANEL_BACKEND == "pallas"           # the default: K1
    for bad in ("cuda", "XLA", "triton", ""):
        with pytest.raises(ValueError, match="panel backend"):
            tlu.set_panel_backend(bad)
    assert tlu._PANEL_BACKEND == "pallas"
    tlu.set_panel_backend("xla")
    assert tlu._PANEL_BACKEND == "xla"
    tlu.set_panel_backend("pallas")
    assert tlu._PANEL_BACKEND == "pallas"


def test_auto_follows_the_backend(card_route):
    A = torch.as_tensor(_rand(np.random.default_rng(5), 2, 256, 256), dtype=torch.complex64)
    LUk, pk = tlu.lu_factor(A)
    assert card_route == [(2, 256, 256)]
    tlu.set_panel_backend("xla")
    LUx, px = tlu.lu_factor(A)
    assert card_route == [(2, 256, 256)]             # no K1 call under "xla"
    LUu, pu = tlu.lu_factor(A, loop="unrolled")
    assert torch.equal(LUx, LUu) and torch.equal(px, pu)
    # both routes factor the same matrices to float32 accuracy
    for LU, perm in ((LUk, pk), (LUx, px)):
        L = torch.tril(LU, -1) + torch.eye(256)
        U = torch.triu(LU)
        PA = torch.gather(A, 1, perm[..., None].expand(-1, -1, 256))
        assert float((L @ U - PA).abs().max() / A.abs().max()) < 1e-4


@pytest.mark.parametrize("n", [200, 256])
def test_buffer_route_survives_a_backend_switch(card_route, n):
    """factor_buffer and lu_factor_inplace read one decision: a buffer
    padded under "pallas" is factored by K1 after a switch to "xla", and an
    unpadded one allocated under "xla" stays on the plain loop after the
    switch back; at n % 128 == 0 the shapes agree and the backend at
    factor time picks the route."""
    A = torch.as_tensor(_rand(np.random.default_rng(n), 2, n, n), dtype=torch.complex64)
    n_pad = -(-n // 128) * 128
    buf = tlu.factor_buffer((2,), n, torch.complex64, "cpu")
    assert buf.shape == (2, n_pad, n_pad)
    buf[:, :n, :n] = A
    ref = torch.zeros_like(buf)
    ref[:, :n, :n] = A
    LUr, pr = panel_lu.lu_factor_panel(ref, panel=panel_lu.panel_factor_plain)
    tlu.set_panel_backend("xla")
    LU, perm = tlu.lu_factor_inplace(buf, n)
    padded = n_pad != n
    assert card_route == ([(2, n_pad, n_pad)] * 2 if padded else [(2, n, n)])
    if padded:
        assert torch.equal(LU, LUr[:, :n, :n]) and torch.equal(perm, pr[:, :n])
    else:
        assert torch.equal(LU, tlu.lu_factor(A, loop="unrolled")[0])
    card_route.clear()
    buf = tlu.factor_buffer((2,), n, torch.complex64, "cpu")
    assert buf.shape == (2, n, n)
    buf[:] = A
    tlu.set_panel_backend("pallas")
    LU, perm = tlu.lu_factor_inplace(buf, n)
    if padded:
        assert card_route == []
        LUp, pp = tlu.lu_factor(A, loop="unrolled")
        assert torch.equal(LU, LUp) and torch.equal(perm, pp)
    else:
        assert card_route == [(2, n, n)]
        assert torch.equal(LU, LUr) and torch.equal(perm, pr)


def test_every_driver_factor_follows_the_backend(card_route):
    """The drivers factor through loop="auto" or the buffer pair, so
    "xla" takes K1 out of each: feast_compiled (the stacked factor),
    feast(node_loop=True), nlfeast (chunks into factor buffers) and the
    stochastic count; the results agree across the two routes."""
    fmod = importlib.import_module("feast_tpu_torch.solvers.feast")
    n = 130
    rng = np.random.default_rng(11)
    A = np.diag(np.arange(1.0, n + 1.0)) + 0.01 * _rand(rng, n, n)
    X0 = _rand(rng, n, 6)
    kw = dict(c=3.0, r=2.2, nodes=8, tol=1e-10, mixed_prec=True, device="cpu")
    # each run's values, and how far the two routes' complex64 factors may
    # move them: eigenvalues refined to tol, or a count estimated in float32
    runs = {
        "feast_compiled": (lambda: ft.feast_compiled(A, X0, iters=20, **kw).filtered()[0],
                           1e-8),
        "node_loop": (lambda: fmod.feast(A, X0, iters=20, node_loop=True,
                                         **kw).filtered()[0], 1e-8),
        "nlfeast": (lambda: ft.nlfeast(ft.LinearPencilNEP(A, device="cpu"), X0,
                                       store=False, **kw).filtered()[0], 1e-8),
        "count": (lambda: np.array([ft.contour_estimate_eig(
            A, contour=ft.circular_contour_trapezoidal(3.0 + 0j, 2.2, 8), samples=20,
            mixed_prec=True, device="cpu")]), 1e-3),
    }
    for name, (run, tol) in runs.items():
        card_route.clear()
        tlu.set_panel_backend("pallas")
        lam_k = np.sort_complex(run())
        assert len(card_route) > 0, f"{name}: no K1 call under 'pallas'"
        card_route.clear()
        tlu.set_panel_backend("xla")
        lam_x = np.sort_complex(run())
        assert card_route == [], f"{name}: K1 called under 'xla'"
        assert lam_k.shape == lam_x.shape and np.abs(lam_k - lam_x).max() < tol, name


# ---------------------------------------------------------------------------
# builders default to the card
# ---------------------------------------------------------------------------

def _csr():
    return sp.csr_matrix(np.diag(np.arange(1.0, 9.0)) + np.diag(np.ones(7), 1))


_BUILDERS = {
    "CSR.from_scipy": (tsp.CSR.from_scipy, lambda f: f(_csr())),
    "CSR.from_dense": (tsp.CSR.from_dense, lambda f: f(_csr().toarray())),
    "DIA.from_scipy": (tsp.DIA.from_scipy, lambda f: f(_csr())),
    "BELL.from_scipy": (tsp.BELL.from_scipy, lambda f: f(_csr(), 4)),
    "BELL.pair_from_scipy": (tsp.BELL.pair_from_scipy, lambda f: f(_csr(), _csr(), 4)),
    "STRETCH.from_scipy": (tsp.STRETCH.from_scipy, lambda f: f(_csr()[:, :4], 2)),
    "as_operator": (tsp.as_operator, lambda f: f(_csr())),
    "build_amg": (tamg.build_amg, lambda f: f(_csr())),
    "tensor_from_pair": (interop.tensor_from_pair,
                         lambda f: f((np.ones(3), np.zeros(3)))),
    "operator_from": (interop.operator_from,
                      lambda f: f(tsp.CSR.from_scipy(_csr(), device="cpu"))),
    "amg_from": (interop.amg_from,
                 lambda f: f(tamg.build_amg(_csr(), max_coarse=4, device="cpu"))),
    "nep_from": (interop.nep_from,
                 lambda f: f(jnep.PolynomialNEP([np.eye(3), np.eye(3)]))),
    "Contour.device_nodes": (tct.Contour.device_nodes,
                             lambda f: f(tct.circular_contour_trapezoidal(0j, 1.0, 4))),
    "Contour.device_weights": (tct.Contour.device_weights,
                               lambda f: f(tct.circular_contour_trapezoidal(0j, 1.0, 4))),
}


@pytest.mark.parametrize("name", sorted(_BUILDERS))
def test_builders_default_to_cuda(monkeypatch, name):
    """Each public builder defaults to device="cuda" and raises where CUDA
    is absent, as every entry point does; none falls back to the CPU."""
    fn, call = _BUILDERS[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        call(fn)


def test_as_operator_refuses_an_operator_on_another_device():
    A = _csr()
    ops = [tsp.CSR.from_scipy(A, device="cpu"), tsp.DIA.from_scipy(A, device="cpu"),
           tsp.BELL.from_scipy(A, 4, device="cpu")]
    ops.append(tsp.RowBlock(ops[0], 0, A.shape, lambda Y: Y))
    for op in ops:
        assert tsp.as_operator(op, device="cpu") is op
        with pytest.raises(ValueError, match="lives on cpu"):
            tsp.as_operator(op, device="meta")


# ---------------------------------------------------------------------------
# the remaining argument gaps, against the JAX functions
# ---------------------------------------------------------------------------

def test_as_nep_dtype_matches_jax():
    rng = np.random.default_rng(4)
    coeffs = [_rand(rng, 6, 6) for _ in range(3)]
    z = _rand(rng, 3)
    for jd, td, tol in ((None, None, 1e-14), ("float64", torch.float64, 1e-14),
                        ("float32", torch.float32, None)):
        jT = jnep.as_nep(coeffs, dtype=None if jd is None else np.dtype(jd))
        tT = tnep.as_nep(coeffs, dtype=td, device="cpu")
        assert isinstance(tT, tnep.PolynomialNEP)
        for mj, mt in zip(jT.mats, tT.mats):
            np.testing.assert_array_equal(mt.numpy(), jcx.to_numpy(mj))
        Tj = jcx.to_numpy(jT.eval_nodes(jcx.from_numpy(z)))
        Tt = tT.eval_nodes(torch.as_tensor(z)).numpy()
        assert Tt.dtype == (np.complex64 if td is torch.float32 else np.complex128)
        # float32 storage evaluates in float32 in both packages: they round
        # apart, to float32's precision
        assert np.abs(Tt - Tj).max() / np.abs(Tj).max() < (tol or 1e-6)

    def fn(zz):
        return np.diag([1.0, 2.0, 3.0]) - zz * np.eye(3)

    for jd, td in (("float32", torch.float32), ("float64", None)):
        jC = jnep.as_nep(fn, n=3, dtype=np.dtype(jd))
        tC = tnep.as_nep(fn, n=3, dtype=td, device="cpu")
        assert isinstance(tC, tnep.CallableNEP) and tC.n == 3
        np.testing.assert_array_equal(
            tC.eval_nodes(torch.as_tensor(z)).numpy(),
            jcx.to_numpy(jC.eval_nodes(jcx.from_numpy(z))))


@pytest.mark.parametrize("eps", [0.0, 0.7])
def test_phase_and_normalize_cols_eps_match_jax(eps):
    rng = np.random.default_rng(6)
    a = _rand(rng, 12, 4)
    a[3, 1] = 0.0
    a[5] *= 0.1                        # |a| below eps for eps = 0.7
    got = tcx.phase(torch.as_tensor(a), eps=eps).numpy()
    want = jcx.to_numpy(jcx.phase(jcx.from_numpy(a), eps=eps))
    assert np.abs(got - want).max() < 1e-14
    assert eps == 0.0 or (got[5] == 1.0).all()
    a[:, 2] = 0.0                      # a zero column is left as it is
    got = tcx.normalize_cols(torch.as_tensor(a), eps=eps).numpy()
    want = jcx.to_numpy(jcx.normalize_cols(jcx.from_numpy(a), eps=eps))
    assert np.abs(got - want).max() < 1e-14


def test_rational_func_pairs_matches_jax():
    rng = np.random.default_rng(8)
    z = 2.0 * _rand(rng, 5, 7)
    kj = jct.circular_contour_trapezoidal(0.5 + 0.2j, 1.5, 16)
    kt = tct.circular_contour_trapezoidal(0.5 + 0.2j, 1.5, 16)
    want = jcx.to_numpy(jct.rational_func_pairs(z.real, z.imag, kj))
    got = tct.rational_func_pairs(z.real, z.imag, kt)
    assert got.dtype == torch.complex128 and got.shape == z.shape
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() < 1e-14
    got_t = tct.rational_func_pairs(torch.as_tensor(z.real), torch.as_tensor(z.imag), kt)
    assert torch.equal(got_t, got)


def test_node_row_diag_keywords_match_jax():
    K = _csr()
    M = sp.csr_matrix(np.diag(np.linspace(2.0, 3.0, 8)))
    for B in (M, None):
        dAj, dBj = jrows.node_row_diag(A_sp=K, B_sp=B, n=8)
        dAt, dBt = trows.node_row_diag(A_sp=K, B_sp=B, n=8)
        np.testing.assert_array_equal(dAt, dAj)
        np.testing.assert_array_equal(dBt, dBj)
        assert dAt.dtype == dBt.dtype == np.complex128
