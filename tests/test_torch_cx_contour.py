"""feast_tpu_torch contour, cx and interop against feast_tpu on the same
seeded inputs (torch on the CPU, JAX x64 on the CPU)."""

import numpy as np
import pytest
import torch

from feast_tpu import contour as jct
from feast_tpu import cx as jcx
from feast_tpu_torch import contour as tct
from feast_tpu_torch import cx as tcx
from feast_tpu_torch import interop

torch.set_num_threads(2)

MAKERS = [
    ("circular_contour_trapezoidal", (1.5 + 0.5j, 2.0, 16)),
    ("circular_contour_gauss", (-1.0 + 2.0j, 0.7, 12)),
    ("rectangular_contour_gauss", (-1.0 - 1.0j, 2.0 + 3.0j, 16)),
    ("rectangular_contour_trapezoidal", (0.0 - 1.0j, 3.0 + 1.0j, 20)),
    ("elliptical_contour_trapezoidal", (0.5 + 0.0j, 3.0, 0.5, 16)),
    ("zolotarev_contour", (1.0, 4.0, 4)),
]


def _probe_points(rng):
    return 4.0 * (rng.standard_normal(200) + 1j * rng.standard_normal(200))


@pytest.mark.parametrize("name,args", MAKERS, ids=[m[0] for m in MAKERS])
def test_contour_nodes_weights_membership(name, args):
    cj = getattr(jct, name)(*args)
    cp = getattr(tct, name)(*args)
    np.testing.assert_allclose(cp.nodes, np.asarray(cj.nodes), rtol=0, atol=1e-14)
    np.testing.assert_allclose(cp.weights, np.asarray(cj.weights), rtol=0, atol=1e-14)
    assert cp.kind == cj.kind and cp.params == pytest.approx(cj.params, abs=1e-14)
    z = _probe_points(np.random.default_rng(1))
    ref = np.asarray(jct.in_contour(z, cj))
    np.testing.assert_array_equal(tct.in_contour(z, cp), ref)
    np.testing.assert_array_equal(
        tct.in_contour(torch.as_tensor(z), cp).numpy(), ref)
    assert cp.spectral_scale == pytest.approx(cj.spectral_scale, abs=1e-14)


def test_custom_contour_membership_and_rational_func():
    base = jct.circular_contour_trapezoidal(0.5 + 0.5j, 1.5, 24)
    cj = jct.custom_contour(base.nodes, base.weights)
    cp = tct.custom_contour(base.nodes, base.weights)
    z = _probe_points(np.random.default_rng(2)) / 2
    np.testing.assert_allclose(tct.rational_func(z, cp),
                               jct.rational_func(z, cj), atol=1e-13)
    rho_t = tct.rational_func_tensor(torch.as_tensor(z), cp).numpy()
    np.testing.assert_allclose(rho_t, jct.rational_func(z, cj), atol=1e-13)
    ref = np.asarray(jct.in_contour(z, cj))
    np.testing.assert_array_equal(tct.in_contour(z, cp), ref)
    np.testing.assert_array_equal(tct.in_contour(torch.as_tensor(z), cp).numpy(), ref)


def test_interop_contour_and_pairs():
    cj = jct.elliptical_contour_trapezoidal(1.0 + 1.0j, 2.0, 1.0, 8)
    cp = interop.contour_from(cj)
    np.testing.assert_array_equal(cp.nodes, np.asarray(cj.nodes))
    assert (cp.kind, cp.params) == (cj.kind, tuple(cj.params))
    rng = np.random.default_rng(3)
    M = rng.standard_normal((5, 4)) + 1j * rng.standard_normal((5, 4))
    t = interop.tensor_from_pair(jcx.from_numpy(M), device="cpu")
    assert t.dtype == torch.complex128
    np.testing.assert_array_equal(interop.to_numpy(t), M)
    t32 = interop.tensor_from_pair(jcx.from_numpy(M, np.float32), device="cpu")
    assert t32.dtype == torch.complex64


@pytest.mark.parametrize("scale", [1e-300, 1.0, 1e300])
def test_cdiv_smith_matches_jax(scale):
    rng = np.random.default_rng(4)
    a = (rng.standard_normal(64) + 1j * rng.standard_normal(64)) * scale
    b = (rng.standard_normal(64) + 1j * rng.standard_normal(64)) * scale
    b[:4] = [scale, 1j * scale, 0.5 * scale, -2j * scale]  # one part zero
    ref = jcx.to_numpy(jcx.cdiv(jcx.from_numpy(a), jcx.from_numpy(b)))
    got = tcx.cdiv(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-15, atol=0)
    np.testing.assert_allclose(got, a / b, rtol=1e-14)
    inv = tcx.creciprocal(torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(
        inv, jcx.to_numpy(jcx.creciprocal(jcx.from_numpy(b))), rtol=1e-15)


def test_column_helpers_match_jax():
    rng = np.random.default_rng(5)
    a = rng.standard_normal((30, 6)) + 1j * rng.standard_normal((30, 6))
    b = rng.standard_normal((30, 6)) + 1j * rng.standard_normal((30, 6))
    a[:, 2] = 0.0
    ja, jb = jcx.from_numpy(a), jcx.from_numpy(b)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    np.testing.assert_allclose(tcx.cdot_cols(ta, tb).numpy(),
                               jcx.to_numpy(jcx.cdot_cols(ja, jb)), atol=1e-13)
    np.testing.assert_allclose(tcx.cgram(ta, tb).numpy(),
                               jcx.to_numpy(jcx.cgram(ja, jb)), atol=1e-13)
    np.testing.assert_allclose(tcx.col_norms(ta).numpy(),
                               np.asarray(jcx.col_norms(ja)), atol=1e-14)
    assert float(tcx.fro_norm(ta)) == pytest.approx(float(jcx.fro_norm(ja)), rel=1e-15)
    np.testing.assert_allclose(tcx.normalize_cols(ta).numpy(),
                               jcx.to_numpy(jcx.normalize_cols(ja)), atol=1e-15)
    s = b[0]
    np.testing.assert_allclose(tcx.scale_cols(ta, torch.as_tensor(s)).numpy(),
                               jcx.to_numpy(jcx.scale_cols(ja, jcx.from_numpy(s))),
                               atol=1e-14)
    np.testing.assert_allclose(tcx.csqrt(tb).numpy(),
                               jcx.to_numpy(jcx.csqrt(jb)), atol=1e-14)
    np.testing.assert_allclose(tcx.phase(ta).numpy(),
                               jcx.to_numpy(jcx.phase(ja)), atol=1e-15)
