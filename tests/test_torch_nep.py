"""The port's NEP types and problem generators against feast_tpu's, on the
same seeded inputs (torch complex128 on the CPU against JAX x64)."""

import numpy as np
import pytest
import torch

import feast_tpu as jt
import feast_tpu_torch as ft
from feast_tpu import cx as jcx
from feast_tpu import problems as jprob
from feast_tpu_torch import cx as tcx
from feast_tpu_torch import interop
from feast_tpu_torch import problems as tprob

torch.set_num_threads(2)


def _rand(rng, *shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.complex128)


def _mats(T):
    return [m.numpy() for m in T.mats]


def _jmats(T):
    return [jcx.to_numpy(m) for m in T.mats]


def test_csqrt_signed_zero_on_negative_axis():
    """The JAX rule picks the sign of the imaginary part by im >= 0, so
    -4 - 0i has root +2i there, where torch.sqrt follows the signed zero."""
    re = np.array([-4.0, -4.0, -1e-300, 9.0, -2.0])
    im = np.array([0.0, -0.0, -0.0, -0.0, -3.0])
    a = torch.complex(torch.as_tensor(re), torch.as_tensor(im))
    got = tcx.csqrt(a).numpy()
    want = jcx.to_numpy(jcx.csqrt(jcx.CX(re, im)))
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)
    assert got[1] == 2j and torch.sqrt(a)[1] == -2j
    assert np.signbit(got.imag).tolist() == np.signbit(want.imag).tolist()


def test_cpow_scalar_matches_jax():
    z = _rand(np.random.default_rng(0), 7)
    for p in (0, 1, 2, 3, 5, 10):
        np.testing.assert_allclose(tcx.cpow_scalar(_t(z), p).numpy(),
                                   jcx.to_numpy(jcx.cpow_scalar(jcx.from_numpy(z), p)),
                                   rtol=1e-15)


@pytest.fixture(scope="module")
def sqrt_spmf():
    """A 3-term SPMF with a sqrt branch, built by both packages."""
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    n = 24
    A = [_rand(rng, n, n) for _ in range(3)]
    jT = jt.SPMF([(A[0], lambda z: jcx.CX(jnp.ones_like(z.re), jnp.zeros_like(z.im))),
                  (A[1], lambda z: jcx.CX(-z.re, -z.im)),
                  (A[2], lambda z: jcx.csqrt(jcx.CX(z.re - 2.0, z.im)))])
    tT = interop.nep_from(jT, funcs=[torch.ones_like, lambda z: -z,
                                     lambda z: tcx.csqrt(torch.complex(z.real - 2.0, z.imag))],
                          device="cpu")
    return jT, tT, rng


def test_spmf_evaluations_match_jax(sqrt_spmf):
    jT, tT, rng = sqrt_spmf
    z = np.array([1.5 + 0.5j, -3.0 + 0.0j, 0.2 - 1.0j])
    lam = _rand(rng, 5)
    X = _rand(rng, tT.n, 5)
    V = _rand(rng, 3, tT.n, 4)
    np.testing.assert_allclose(tT._gram.numpy(), jcx.to_numpy(jT._gram), rtol=1e-14)
    np.testing.assert_allclose(tT.coeffs(_t(lam)).numpy(),
                               jcx.to_numpy(jT.coeffs(jcx.from_numpy(lam))), rtol=1e-15)
    np.testing.assert_allclose(tT.eval_at(z[0]).numpy(),
                               jcx.to_numpy(jT.eval_at(jcx.from_numpy(z[0]))), atol=1e-13)
    Tz = jcx.to_numpy(jT.eval_nodes(jcx.from_numpy(z)))
    np.testing.assert_allclose(tT.eval_nodes(_t(z)).numpy(), Tz, atol=1e-13)
    T32 = tT.eval_nodes(_t(z), out_dtype=torch.complex64)
    assert T32.dtype == torch.complex64
    np.testing.assert_allclose(T32.numpy(), Tz, atol=1e-5 * np.abs(Tz).max())
    want = np.stack([jcx.to_numpy(jT.apply_block(jcx.from_numpy(z[i]), jcx.from_numpy(V[i])))
                     for i in range(3)])
    np.testing.assert_allclose(tT.apply_block(_t(z), _t(V)).numpy(), want, atol=1e-12)
    np.testing.assert_allclose(tT.apply_cols(_t(X), _t(lam)).numpy(),
                               jcx.to_numpy(jT.apply_cols(jcx.from_numpy(X),
                                                          jcx.from_numpy(lam))), atol=1e-12)
    np.testing.assert_allclose(tT.fro_norms(_t(lam)).numpy(),
                               np.asarray(jT.fro_norms(jcx.from_numpy(lam))), rtol=1e-13)


def test_eval_nodes_into_padded_buffer(sqrt_spmf):
    """eval_nodes writes in place into a view of a larger zeroed buffer and
    leaves the padding zero (the factor buffer of the panel-kernel route)."""
    _, tT, _ = sqrt_spmf
    z = _t([0.5 + 0.5j, 2.0 - 1.0j])
    n = tT.n
    buf = torch.zeros((2, n + 8, n + 8), dtype=torch.complex64)
    out = tT.eval_nodes(z, out_dtype=torch.complex64, out=buf[:, :n, :n])
    assert out.data_ptr() == buf.data_ptr()
    np.testing.assert_array_equal(buf[:, :n, :n].numpy(),
                                  tT.eval_nodes(z, out_dtype=torch.complex64).numpy())
    assert not buf[:, n:, :].any() and not buf[:, :, n:].any()


def test_polynomial_and_pencil_types_match_jax():
    rng = np.random.default_rng(2)
    n = 10
    coeffs = [_rand(rng, n, n) for _ in range(4)]
    lam = _rand(rng, 6)
    X = _rand(rng, n, 6)
    jP = jt.PolynomialNEP(coeffs)
    for tP in (ft.PolynomialNEP(coeffs, device="cpu"), interop.nep_from(jP, device="cpu")):
        assert tP.degree == 3
        np.testing.assert_allclose(tP.apply_cols(_t(X), _t(lam)).numpy(),
                                   jcx.to_numpy(jP.apply_cols(jcx.from_numpy(X),
                                                              jcx.from_numpy(lam))),
                                   atol=1e-11)
    jL = jt.LinearPencilNEP(coeffs[0], coeffs[1])
    tL = interop.nep_from(jL, device="cpu")
    assert isinstance(tL, ft.LinearPencilNEP)
    np.testing.assert_allclose(tL.fro_norms(_t(lam)).numpy(),
                               np.asarray(jL.fro_norms(jcx.from_numpy(lam))), rtol=1e-13)
    tI = ft.LinearPencilNEP(coeffs[0], device="cpu")
    np.testing.assert_allclose(tI.eval_at(2.0).numpy(), coeffs[0] - 2.0 * np.eye(n))


def test_callable_nep_and_as_nep():
    A = np.diag(np.arange(1.0, 6.0)).astype(np.complex128)

    def fn(z):
        return A - z * np.eye(5)

    T = ft.nep.as_nep(fn, n=5, device="cpu")
    assert isinstance(T, ft.CallableNEP)
    Tz = T.eval_nodes(_t([1.0, 2.0j]), out_dtype=torch.complex64)
    assert Tz.dtype == torch.complex64
    np.testing.assert_allclose(Tz[1].numpy(), fn(2.0j))
    X = np.eye(5, 2, dtype=np.complex128)
    np.testing.assert_allclose(T.host_apply_cols(X, np.array([1.0, 0.5])),
                               np.stack([fn(1.0) @ X[:, 0], fn(0.5) @ X[:, 1]], 1))
    assert isinstance(ft.nep.as_nep([A, -np.eye(5)], device="cpu"), ft.PolynomialNEP)
    with pytest.raises(ValueError, match="size n"):
        ft.nep.as_nep(fn, device="cpu")
    with pytest.raises(TypeError):
        ft.nep.as_nep(3.0, device="cpu")
    with pytest.raises(ValueError, match="funcs|functions"):
        interop.nep_from(jt.SPMF([(A, lambda z: z)]), device="cpu")


def test_nep_types_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ft.PolynomialNEP([np.eye(3), np.eye(3)])
    with pytest.raises(RuntimeError, match="CUDA"):
        tprob.butterfly(4)


# ---------------------------------------------------------------------------
# generators
# ---------------------------------------------------------------------------

def _assert_same_terms(tT, jT, z, rtol=1e-12, frtol=1e-14):
    """Same coefficient matrices (to rtol of the largest entry) and the same
    scalar functions at z (to frtol)."""
    for a, b in zip(_mats(tT), _jmats(jT)):
        scale = max(np.abs(b).max(), 1e-300)
        assert np.abs(a - b).max() <= rtol * scale
    np.testing.assert_allclose(tT.coeffs(_t(z)).numpy(),
                               jcx.to_numpy(jT.coeffs(jcx.from_numpy(z))), rtol=frtol)


Z_PROBE = np.array([1.0 + 1.0j, -0.7 + 0.2j, 105.0 + 8.0j, 3.0 - 0.0j, -2.0 - 0.5j])


def test_butterfly_matches_jax():
    tT, tc = tprob.butterfly(device="cpu")
    jT, jc = jprob.butterfly()
    for a, b in zip(tc, jc):
        np.testing.assert_array_equal(a, b)
    _assert_same_terms(tT, jT, Z_PROBE, rtol=0.0)


@pytest.mark.parametrize("name,args", [("loaded_string", (40, 1.0, 1.0)),
                                       ("hadeler", (30, 100.0)),
                                       ("fiber_like", (64,))])
def test_gallery_generators_match_jax(name, args):
    tT = getattr(tprob, name)(*args, device="cpu")
    jT = getattr(jprob, name)(*args)
    _assert_same_terms(tT, jT, Z_PROBE, rtol=0.0)


def test_delay_nep_and_laplacian_match_jax():
    rng = np.random.default_rng(3)
    A0, A1 = _rand(rng, 6, 6), _rand(rng, 6, 6)
    _assert_same_terms(tprob.delay_nep(A0, A1, 0.5, device="cpu"),
                       jprob.delay_nep(A0, A1, 0.5), Z_PROBE, rtol=0.0)
    np.testing.assert_array_equal(tprob.laplacian_1d(9), jprob.laplacian_1d(9))
    assert (tprob.laplacian_1d(9, sparse=True) != jprob.laplacian_1d(9, sparse=True)).nnz == 0


def test_fem2d_unstructured_matches_jax():
    tK, tM, tp = tprob.fem2d_unstructured(300, seed=2)
    jK, jM, jp = jprob.fem2d_unstructured(300, seed=2)
    assert (tK != jK).nnz == 0 and (tM != jM).nnz == 0
    np.testing.assert_array_equal(tp, jp)


@pytest.mark.parametrize("planted", [None, 12])
def test_gun_like_parts_match_jax(planted):
    """Same draws in the same order; the dense work in torch float64: the
    parts agree to 1e-12 relative at n = 256."""
    kw = dict(seed=4, planted=planted, cluster=(50.0, 56.0))
    tT = tprob.gun_like(256, device="cpu", **kw)
    jT = jprob.gun_like(256, **kw)
    # the square roots by the JAX formula: its real part sqrt((|w| + Re w)/2)
    # cancels near the negative real axis (w = z - 108.8774^2 at the probes
    # left of the branch point), where a last-bit difference of |w| (torch's
    # hypot against XLA's) grows to ~1e-11 of the coefficient
    _assert_same_terms(tT, jT, Z_PROBE, rtol=1e-12, frtol=1e-10)
    np.testing.assert_allclose(tT._gram.numpy(), jcx.to_numpy(jT._gram), rtol=1e-12)


def test_gun_like_cache_roundtrip(tmp_path):
    a = tprob.gun_like(128, planted=6, cluster=(50.0, 56.0), cache_dir=str(tmp_path),
                       device="cpu")
    assert len(list(tmp_path.iterdir())) == 1
    b = tprob.gun_like(128, planted=6, cluster=(50.0, 56.0), cache_dir=str(tmp_path),
                       device="cpu")
    for x, y in zip(a.mats, b.mats):
        assert torch.equal(x, y)
    _assert_same_terms(b, jprob.gun_like(128, planted=6, cluster=(50.0, 56.0)),
                       Z_PROBE, rtol=1e-12)
