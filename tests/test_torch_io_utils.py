"""The port's io, problems loaders, utils and config against feast_tpu on
the CPU: MatrixMarket files of every layout tests/test_io.py writes, slice
checkpoints read across the two packages, the fixture loaders on files the
test writes, diagnostics, the phase timer, tracing, and the public API.

Tolerances: files read exactly as scipy's and the JAX package's readers
read them; diagnostics equal."""

import ast
import inspect
import json
import os
import pathlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.io import mmread, mmwrite

import feast_tpu as jt
import feast_tpu_torch as ft
from feast_tpu import contour as jct
from feast_tpu import io as jio
from feast_tpu import problems as jprob
from feast_tpu import utils as jutils
from feast_tpu_torch import config as tconfig
from feast_tpu_torch import io as tio
from feast_tpu_torch import problems as tprob
from feast_tpu_torch import utils as tutils
from feast_tpu_torch.ops.sparse import CSR
from feast_tpu_torch.utils import tracing

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _layout(kind):
    """(matrix, mmwrite keywords) of each file layout of tests/test_io.py."""
    rng = np.random.default_rng(8)
    if kind == "coordinate_real":
        return sp.random(20, 20, density=0.2, random_state=1), {}
    if kind == "coordinate_complex":
        return sp.coo_matrix(sp.random(15, 15, density=0.3, random_state=2)
                             + 1j * sp.random(15, 15, density=0.3, random_state=3)), {}
    if kind == "coordinate_symmetric":
        A = sp.random(12, 12, density=0.3, random_state=4)
        return sp.coo_matrix(A + A.T), {"symmetry": "symmetric"}
    if kind == "coordinate_skew":
        A = sp.random(10, 10, density=0.3, random_state=5)
        return sp.coo_matrix(A - A.T), {"symmetry": "skew-symmetric"}
    if kind == "coordinate_hermitian":
        A = (sp.random(10, 10, density=0.3, random_state=6)
             + 1j * sp.random(10, 10, density=0.3, random_state=7)).toarray()
        return sp.coo_matrix(A + A.conj().T), {"symmetry": "hermitian"}
    if kind == "array_dense":
        return rng.standard_normal((7, 5)), {}
    if kind == "array_symmetric":
        A = rng.standard_normal((9, 9))
        return A + A.T, {"symmetry": "symmetric"}
    if kind == "array_hermitian":
        A = rng.standard_normal((8, 8)) + 1j * rng.standard_normal((8, 8))
        return A + A.conj().T, {"symmetry": "hermitian"}
    if kind == "array_skew":
        A = rng.standard_normal((7, 7))
        return A - A.T, {"symmetry": "skew-symmetric"}
    if kind == "pattern":
        return sp.coo_matrix(sp.random(9, 9, density=0.3, random_state=9)), {"field": "pattern"}
    raise ValueError(kind)


LAYOUTS = ["coordinate_real", "coordinate_complex", "coordinate_symmetric",
           "coordinate_skew", "coordinate_hermitian", "array_dense",
           "array_symmetric", "array_hermitian", "array_skew", "pattern"]


@pytest.mark.parametrize("kind", LAYOUTS)
def test_read_matrix_market_layouts_match_jax(tmp_path, kind):
    A, kw = _layout(kind)
    p = str(tmp_path / f"{kind}.mtx")
    mmwrite(p, A, **kw)
    got = tio.read_matrix_market(p, out="dense")
    ref = mmread(p)
    ref = np.asarray(ref.todense() if sp.issparse(ref) else ref, dtype=np.complex128)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, jio.read_matrix_market(p, out="dense"))


def test_read_matrix_market_outputs_and_crlf(tmp_path):
    A = sp.coo_matrix(sp.random(11, 11, density=0.3, random_state=12))
    A = sp.coo_matrix(A + A.T)
    p = str(tmp_path / "lf.mtx")
    mmwrite(p, A, symmetry="symmetric")
    s = tio.read_matrix_market(p, out="scipy")
    assert sp.issparse(s) and s.dtype == np.complex128
    c = tio.read_matrix_market(p, out="csr", device="cpu")
    assert isinstance(c, CSR) and c.data.device.type == "cpu"
    # the port's CSR goes to the card unless the caller asks for the CPU
    assert inspect.signature(tio.read_matrix_market).parameters["device"].default == "cuda"
    d = tio.read_matrix_market(p, out="dense")
    np.testing.assert_array_equal(c.todense().numpy(), d)
    np.testing.assert_array_equal(np.asarray(s.todense()), d)
    with pytest.raises(ValueError):
        tio.read_matrix_market(p, out="bell")
    # CRLF line endings read as LF ones
    raw = open(p, "rb").read().replace(b"\n", b"\r\n")
    p_crlf = str(tmp_path / "crlf.mtx")
    open(p_crlf, "wb").write(raw)
    np.testing.assert_array_equal(tio.read_matrix_market(p_crlf, out="dense"), d)
    np.testing.assert_array_equal(jio.read_matrix_market(p_crlf, out="dense"), d)


def _diag25():
    A = np.diag(np.arange(1.0, 26.0)).astype(np.complex128)
    rng = np.random.default_rng(0)
    return A, rng.standard_normal((25, 5)) + 1j * rng.standard_normal((25, 5))


def test_slices_cross_between_packages(tmp_path):
    A, X0 = _diag25()
    k = ft.circular_contour_trapezoidal(1.5 + 0j, 2.0, 8)
    rt = ft.feast(A, X0, k, device="cpu")
    pt = str(tmp_path / "port.npz")
    tio.save_slice(pt, rt, k, meta={"label": "diag25", "n": 25})
    kj = jct.circular_contour_trapezoidal(1.5 + 0j, 2.0, 8)
    rj = jt.feast(A, X0, kj)
    pj = str(tmp_path / "jax.npz")
    jio.save_slice(pj, rj, kj, meta={"label": "diag25", "n": 25})
    a, b = jio.load_slice(pt), tio.load_slice(pj)
    assert sorted(a) == sorted(b) == sorted(tio.load_slice(pt))
    for key in a:
        assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
    np.testing.assert_allclose(np.sort(a["lam"][a["inside"]].real),
                               np.sort(b["lam"][b["inside"]].real), atol=1e-10)
    np.testing.assert_array_equal(a["contour_nodes"], b["contour_nodes"])
    assert str(a["contour_kind"]) == "circle" and str(a["meta_label"]) == "diag25"
    assert int(a["n_iter"]) == int(b["n_iter"]) and bool(a["converged"])
    # a loaded X warm-restarts the port's driver: converged at the first RR
    warm = ft.feast(A, b["X"], k, device="cpu")
    assert warm.converged and warm.n_iter == 0


def _write_fixtures(d):
    rng = np.random.default_rng(5)
    for k in range(3):
        mmwrite(str(d / f"system5A{k}.mtx"), sp.random(30, 30, density=0.1, random_state=k))
    for k in range(2):
        mmwrite(str(d / f"quadraticM{k}.mtx"), rng.standard_normal((15, 15)))
    for k in range(5):
        mmwrite(str(d / f"butterflyM{k}.mtx"), rng.standard_normal((16, 16)))


@pytest.mark.parametrize("loader", ["load_system5", "load_quadratic", "load_butterfly"])
def test_fixture_loaders_match_jax(tmp_path, loader):
    _write_fixtures(tmp_path)
    T, coeffs = getattr(tprob, loader)(str(tmp_path), device="cpu")
    _, coeffs_j = getattr(jprob, loader)(str(tmp_path))
    assert len(coeffs) == len(coeffs_j) == len(T.mats)
    for c, cj in zip(coeffs, coeffs_j):
        np.testing.assert_array_equal(c, cj)
    z = torch.tensor([0.3 + 0.2j], dtype=torch.complex128)
    want = sum(c * complex(z[0]) ** k for k, c in enumerate(coeffs))
    np.testing.assert_allclose(T.eval_nodes(z)[0].numpy(), want, atol=1e-12)


def test_load_butterfly_falls_back_without_fixtures(tmp_path, monkeypatch):
    monkeypatch.delenv("FEAST_REF_DATA", raising=False)
    _, coeffs = tprob.load_butterfly(str(tmp_path / "absent"), device="cpu")
    _, want = tprob.butterfly(device="cpu")
    for c, w in zip(coeffs, want):
        np.testing.assert_array_equal(c, w)
    _, coeffs_j = jprob.load_butterfly(str(tmp_path / "absent"))
    for c, cj in zip(coeffs, coeffs_j):
        np.testing.assert_array_equal(c, cj)
    with pytest.raises(FileNotFoundError):
        tprob.load_system5(str(tmp_path / "absent"), device="cpu")


def test_convergence_info_matches_jax(capsys):
    lam = np.array([1.0, 2.0, 9.0, 1.5 + 0.1j])
    res = np.array([1e-13, 1e-6, 1e-2, 1e-4])
    k = ft.circular_contour_trapezoidal(1.5 + 0j, 1.0, 8)
    kj = jct.circular_contour_trapezoidal(1.5 + 0j, 1.0, 8)
    info = ft.convergence_info(lam, None, res, k, spurious=1e-3)
    assert info == jt.convergence_info(lam, None, res, kj, spurious=1e-3)
    assert info["inside"] == 3 and info["non_spurious"] == 3
    assert info["max_res_inside"] == 1e-4
    # tensors give the same summary
    assert ft.convergence_info(torch.as_tensor(lam), None, torch.as_tensor(res), k,
                               spurious=1e-3) == info
    ft.print_convergence_info(lam, None, res, k, spurious=1e-5)
    out = capsys.readouterr().out
    jt.print_convergence_info(lam, None, res, kj, spurious=1e-5)
    assert out == capsys.readouterr().out and "inside contour" in out


@pytest.mark.parametrize("nodes", [8, 32])
def test_filter_quality_matches_jax(nodes):
    q = tutils.filter_quality(ft.circular_contour_gauss(0.0 + 0j, 1.0, nodes))
    qj = jutils.filter_quality(jct.circular_contour_gauss(0.0 + 0j, 1.0, nodes))
    assert q.keys() == qj.keys()
    for key in q:
        np.testing.assert_allclose(q[key], qj[key], rtol=1e-12, atol=1e-15)
    q8 = tutils.filter_quality(ft.circular_contour_gauss(0.0 + 0j, 1.0, 8))
    if nodes == 32:
        assert q["max_inside_error"] < q8["max_inside_error"]
        assert q["max_at_2r"] < q8["max_at_2r"]


def test_phase_timer():
    t = tutils.PhaseTimer()
    t.start("solve", work_units=100.0)
    rec = t.stop()
    assert rec["phase"] == "solve" and rec["wall_s"] >= 0.0 and "units_per_s" in rec
    t.start("solve")
    assert "units_per_s" not in t.stop()
    t.start("setup")
    t.stop()
    summary = t.summary()
    assert set(summary) == {"solve", "setup"}
    assert summary["solve"] == pytest.approx(t.records[0]["wall_s"] + t.records[1]["wall_s"])


def test_trace_on_cpu(tmp_path):
    logdir = str(tmp_path / "tr")
    with tracing.trace(logdir) as where:
        with tracing.annotate("feast"):
            A, X0 = _diag25()
            ft.feast(A, X0, c=1.5, r=2.0, nodes=8, device="cpu")
    assert where == logdir
    events = json.load(open(os.path.join(logdir, "trace.json")))["traceEvents"]
    assert any(e.get("name") == "feast" for e in events)


def test_config():
    tconfig.enable_x64()
    assert tconfig.default_rdtype() == torch.float64
    assert tconfig.eps(torch.float32) == pytest.approx(1.1920928955078125e-07)
    assert tconfig.eps(torch.complex128) == np.finfo(np.float64).eps


def test_public_api_covers_the_jax_package():
    """Every top-level name of feast_tpu/__init__.py exists in the port,
    except the parallel slice (not ported yet); io has its three entry
    points (the JAX package's native reader is not ported)."""
    tree = ast.parse((ROOT / "feast_tpu" / "__init__.py").read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
    names -= {"parallel", "orchestrate"}
    assert len(names) >= 30
    missing = sorted(name for name in names if not hasattr(ft, name))
    assert not missing, missing
    for name in names:
        if callable(getattr(jt, name)):
            assert callable(getattr(ft, name)), name
    for f in (tio.read_matrix_market, tio.save_slice, tio.load_slice):
        assert callable(f)
    assert not hasattr(tio, "_native_mmio")
