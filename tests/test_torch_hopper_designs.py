"""Host-side checks of the Hopper kernel designs, on the CPU.

* The panel-LU kernel's launch plan (`ops/panel_lu.py::launch_plan`, the
  mirror of `csrc/panel_lu.cu::choose_plan`): shared memory within a block's
  227 KB and every active row owned by one block, for every slab the dense
  path can hand it.
* The complex-GEMM kernel's arithmetic (`csrc/cmatmul.cu`): each fp32 operand
  split into two TF32 halves (round to nearest, ties away from zero, as
  cvt.rna.tf32.f32), three tensor-core products per real product, three real
  products per complex one (Karatsuba), each 16-deep k-step summed in a fresh
  fp32 tile and added to the accumulator.
  Emulated here in plain torch, held to complex128 against the fp32 plain
  version `cx._cmatmul_planes`, and the plain version held to the JAX
  package's Pallas kernel in interpret mode.  The emulation lives in this
  file only.
* The Schur kernel's sweep order (`csrc/schur.cu`): float32 mirrors of the
  lag-two fused sweep and of the two-pass sweep with row rotations
  restricted to columns >= i (and T's column rotations j to rows <= j+2)
  are equal bit for bit and agree with
  `ops/eig.py::_qr_sweep` to rounding; a whole Schur iteration with the fused
  sweep keeps the plain iteration's eigenvalues and sweep count.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from feast_tpu import cx as jcx
from feast_tpu.ops import pallas_kernels as pk
from feast_tpu_torch import cx
from feast_tpu_torch.ops import panel_lu
from feast_tpu_torch.ops import eig as teig

# clusters of C blocks that an H100 SXM holds at once with one block per
# SM, as cudaOccupancyMaxActiveClusters reports them for this kernel
# (chip_smoke.py's k1 line, NVIDIA H100 80GB HBM3); the kernel's registers
# (72 x 512 threads) allow one block per SM whatever its shared memory
H100_FITS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}


def h100_clusters_fit(C, smem):
    return H100_FITS[C]


def _check_plan(plan, n, b, j0):
    R = n - j0
    assert plan["C"] in panel_lu.CLUSTER_SIZES
    assert plan["smem"] + panel_lu.STATIC_RESERVE <= panel_lu.SMEM_CAP
    assert plan["C"] * plan["rows_per"] >= R          # every active row has a block
    assert plan["rows_per"] == -(-R // plan["C"])      # ... and no more than one
    assert 1 <= plan["w"] <= min(32, b)
    if plan["in_smem"]:
        assert plan["rows_per"] * (plan["w"] + 1) * 8 <= plan["smem"]


@pytest.mark.parametrize("batch", [1, 3, 16, 17, 64])
def test_panel_launch_plan_fits_and_covers(batch):
    b = panel_lu.MAX_BLOCK
    # the plan depends on the slab only through its active rows R = n - j0,
    # so every R from b to 16384 stands for every (n, j0) with n <= 16384
    seen_w = set()
    for R in range(b, 16385):
        plan = panel_lu.launch_plan(R, b, 0, batch, h100_clusters_fit)
        _check_plan(plan, R, b, 0)
        seen_w.add((plan["w"], plan["in_smem"]))
        if R % 509 == 0:
            for n in (R, R + 128, 16384 + 128):
                assert panel_lu.launch_plan(n, b, n - R, batch, h100_clusters_fit) == plan
    # every n % 128 == 0 up to 16384 at the dense path's panel positions
    for n in range(128, 16385, 128):
        for j0 in sorted({0, n // 2, n - b, max(0, n - 2 * b - 1)}):
            _check_plan(panel_lu.launch_plan(n, b, j0, batch, h100_clusters_fit), n, b, j0)
    assert (32, True) in seen_w
    # one wave: clusters of 8 up to 15 slabs, of 6 for the headline's 16
    plan = panel_lu.launch_plan(4096, b, 0, batch, h100_clusters_fit)
    assert plan["C"] == {1: 8, 3: 8, 16: 6, 17: 6, 64: 2}[batch] and plan["in_smem"]
    assert batch <= h100_clusters_fit(plan["C"], plan["smem"])


def test_panel_launch_plan_narrow_slabs_and_streaming():
    for b in (1, 5, 32, 100):
        for n in (b, b + 3, 1000):
            for j0 in (0, n - b):
                plan = panel_lu.launch_plan(n, b, j0, 4, h100_clusters_fit)
                _check_plan(plan, n, b, j0)
    # a very tall slab on one block per slab: the sub-panel stays in the slab
    plan = panel_lu.launch_plan(65536, 128, 0, 500, h100_clusters_fit)
    assert plan["C"] == 1 and not plan["in_smem"]
    _check_plan(plan, 65536, 128, 0)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> TF32 (10 mantissa bits), nearest, ties away from zero."""
    bits = x.view(torch.int32)
    mag = (bits & 0x7FFFFFFF) + 0x1000
    return ((mag & ~0x1FFF) | (bits & ~0x7FFFFFFF)).view(torch.float32)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32 a @ b as the kernel forms it: per k-step of 16 a fresh fp32 tile
    takes small*big, big*small, big*big of each 8-deep MMA (its 8 products
    summed exactly, then rounded to fp32), and is added to the accumulator."""
    ab = tf32_rna(a)
    as_ = tf32_rna(a - ab)
    bb = tf32_rna(b)
    bs = tf32_rna(b - bb)
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for c0 in range(0, a.shape[1], 16):
        tmp = torch.zeros_like(acc)
        for k0 in range(c0, min(c0 + 16, a.shape[1]), 8):
            ks = slice(k0, k0 + 8)
            for x, y in ((as_, bb), (ab, bs), (ab, bb)):
                tmp = (tmp.double() + x[:, ks].double() @ y[ks].double()).float()
        acc = acc + tmp
    return acc


def cmm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ar, ai, br, bi = a.real, a.imag, b.real, b.imag
    t1, t2 = mm_3xtf32(ar, br), mm_3xtf32(ai, bi)
    t3 = mm_3xtf32(ar + ai, br + bi)
    return torch.complex(t1 - t2, t3 - t1 - t2)


def test_tf32_rounding_is_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                      # a TF32 value: kept
    half = 1.0 + 2.0 ** -11                     # halfway: away from zero
    below = 1.0 + 2.0 ** -11 - 2.0 ** -20       # below halfway: down
    x = torch.tensor([one, half, below, -half, 0.0, 3.0], dtype=torch.float32)
    want = torch.tensor([one, one, 1.0, -one, 0.0, 3.0], dtype=torch.float32)
    assert torch.equal(tf32_rna(x), want)
    r = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    t = tf32_rna(r)
    assert torch.equal(t.view(torch.int32) & 0x1FFF, torch.zeros(1000, dtype=torch.int32))
    assert float(((t - r).abs() / r.abs()).max()) <= 2.0 ** -11


@pytest.mark.parametrize("K", [128, 4096])
def test_3xtf32_karatsuba_error_within_twice_fp32(K):
    rng = np.random.default_rng(K)
    M, N = 48, 40
    a = rng.standard_normal((M, K)) + 1j * rng.standard_normal((M, K))
    b = rng.standard_normal((K, N)) + 1j * rng.standard_normal((K, N))
    at = torch.as_tensor(a, dtype=torch.complex64)
    bt = torch.as_tensor(b, dtype=torch.complex64)
    ref = at.to(torch.complex128) @ bt.to(torch.complex128)
    err_tc = float((cmm_3xtf32(at, bt).to(torch.complex128) - ref).abs().max())
    err_fp32 = float((cx._cmatmul_planes(at, bt).to(torch.complex128) - ref).abs().max())
    assert err_tc <= 2 * err_fp32, (err_tc, err_fp32)
    # one TF32 pass alone keeps about three digits: the split is what buys fp32
    one_pass = torch.complex(tf32_rna(at.real).double() @ tf32_rna(bt.real).double()
                             - tf32_rna(at.imag).double() @ tf32_rna(bt.imag).double(),
                             torch.zeros(M, N, dtype=torch.float64))
    assert float((one_pass - ref.real).abs().max()) > 20 * err_fp32


def test_karatsuba_plain_matches_pallas_interpret_batched(monkeypatch):
    """The plain version, now Karatsuba, against the TPU kernel's body in
    interpret mode on a ragged shape, and over a batch with a shared operand."""
    monkeypatch.setattr(pk, "_INTERPRET", True)
    pk._cmatmul_pallas_padded._clear_cache()
    rng = np.random.default_rng(11)
    m, k, n = 130, 70, 200
    a = rng.standard_normal((m, k)) + 1j * rng.standard_normal((m, k))
    b = rng.standard_normal((k, n)) + 1j * rng.standard_normal((k, n))
    want = jcx.to_numpy(pk.cmatmul_pallas(jcx.from_numpy(a, jnp.float32),
                                          jcx.from_numpy(b, jnp.float32),
                                          bm=128, bn=128, bk=128))
    at = torch.as_tensor(a, dtype=torch.complex64)
    bt = torch.as_tensor(b, dtype=torch.complex64)
    got = cx._cmatmul_planes(at[None].expand(3, m, k), bt)
    assert got.shape == (3, m, n)
    np.testing.assert_allclose(got[2].numpy(), want, rtol=0, atol=1e-3 * np.sqrt(k))
    np.testing.assert_allclose(got[0].numpy(), a @ b, rtol=0, atol=1e-3 * np.sqrt(k))


# ---------------------------------------------------------------------------
# K2: the Schur kernel's lag-two sweep
# ---------------------------------------------------------------------------

def _givens32(ar, ai, br, bi):
    """csrc/schur.cu::givens on float32 0-d tensors: c = |a|/r,
    s = phase(a) conj(b)/r."""
    one, zero = torch.ones((), dtype=torch.float32), torch.zeros((), dtype=torch.float32)
    na2, nb2 = ar * ar + ai * ai, br * br + bi * bi
    r2 = na2 + nb2
    rr = torch.sqrt(torch.where(r2 > 0, r2, one))
    absa = torch.sqrt(na2)
    safe = torch.where(na2 > 0, absa, one)
    pr = torch.where(na2 > 0, ar / safe, one)
    pi = torch.where(na2 > 0, ai / safe, zero)
    bz = nb2 == 0
    c = torch.where(bz, one, absa / rr)
    sr = torch.where(bz, zero, (pr * br + pi * bi) / rr)
    si = torch.where(bz, zero, (pi * br - pr * bi) / rr)
    return c, sr, si


def _row_rot(Hr, Hi, i, c, sr, si):
    """Rows i, i+1 at columns >= i: top = c ri + s rn, bot = c rn - conj(s) ri."""
    ar, ai = Hr[i, i:].clone(), Hi[i, i:].clone()
    br, bi = Hr[i + 1, i:].clone(), Hi[i + 1, i:].clone()
    Hr[i, i:] = c * ar + sr * br - si * bi
    Hi[i, i:] = c * ai + sr * bi + si * br
    Hr[i + 1, i:] = br * c - (sr * ar + si * ai)
    Hi[i + 1, i:] = bi * c - (sr * ai - si * ar)


def _col_rot(Mr, Mi, j, c, sr, si, rows=None):
    """Columns j, j+1 of rows < rows (all by default): M[:, j] = c u +
    conj(s) w, M[:, j+1] = c w - s u."""
    ur, ui = Mr[:rows, j].clone(), Mi[:rows, j].clone()
    wr, wi = Mr[:rows, j + 1].clone(), Mi[:rows, j + 1].clone()
    Mr[:rows, j] = c * ur + sr * wr + si * wi
    Mi[:rows, j] = c * ui + sr * wi - si * wr
    Mr[:rows, j + 1] = c * wr - (sr * ur - si * ui)
    Mi[:rows, j + 1] = c * wi - (sr * ui + si * ur)


def sweep_two_pass(Hr, Hi, Zr, Zi, k):
    """All k row rotations (restricted to columns >= i), then the column
    rotations of H (restricted to rows <= j+2: below, H holds only rounding
    residues) and Z in order."""
    rots = []
    for i in range(k):
        rot = _givens32(Hr[i, i], Hi[i, i], Hr[i + 1, i], Hi[i + 1, i])
        _row_rot(Hr, Hi, i, *rot)
        rots.append(rot)
    for j, rot in enumerate(rots):
        _col_rot(Hr, Hi, j, *rot, rows=j + 3)
        _col_rot(Zr, Zi, j, *rot)


def sweep_fused(Hr, Hi, Zr, Zi, k):
    """The kernel's order: step i applies row rotation i and column
    rotation i-2; rotation i+1 is formed inside step i; the last two column
    rotations follow the loop."""
    rots = [_givens32(Hr[0, 0], Hi[0, 0], Hr[1, 0], Hi[1, 0])]
    for i in range(k):
        _row_rot(Hr, Hi, i, *rots[i])
        if i + 1 < k:
            rots.append(_givens32(Hr[i + 1, i + 1], Hi[i + 1, i + 1],
                                  Hr[i + 2, i + 1], Hi[i + 2, i + 1]))
        if i >= 2:
            _col_rot(Hr, Hi, i - 2, *rots[i - 2], rows=i + 1)
            _col_rot(Zr, Zi, i - 2, *rots[i - 2])
    for j in range(max(k - 2, 0), k):
        _col_rot(Hr, Hi, j, *rots[j], rows=j + 3)
        _col_rot(Zr, Zi, j, *rots[j])


def _planes(M):
    return M.real.clone().contiguous(), M.imag.clone().contiguous()


def mirror_qr_sweep(H, Z, k, sigma, sweep):
    """One shifted sweep on complex64 H, Z with a float32 mirror `sweep`."""
    n = H.shape[-1]
    dsig = torch.where(torch.arange(n) <= k, sigma, torch.zeros((), dtype=H.dtype))
    Hr, Hi = _planes(H - torch.diag(dsig))
    Zr, Zi = _planes(Z)
    sweep(Hr, Hi, Zr, Zi, k)
    return torch.complex(Hr, Hi) + torch.diag(dsig), torch.complex(Zr, Zi)


def _hessenberg64(rng, n):
    A = torch.as_tensor(rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)),
                        dtype=torch.complex64)
    H, Q = teig.hessenberg(A)
    return H, Q


@pytest.mark.parametrize("n", [2, 3, 8, 48, 128])
def test_schur_fused_sweep_equals_restricted_two_pass(n):
    rng = np.random.default_rng(n)
    H, Q = _hessenberg64(rng, n)
    for k in sorted({1, n // 2, n - 1} - {0}):
        sigma = H[k, k] + 0.1
        Hf, Zf = mirror_qr_sweep(H, Q, k, sigma, sweep_fused)
        Ht, Zt = mirror_qr_sweep(H, Q, k, sigma, sweep_two_pass)
        assert torch.equal(Hf, Ht) and torch.equal(Zf, Zt), (n, k)
        # the unrestricted sweep also rotates the rounding residues left of
        # column i and below the subdiagonal: equal to rounding
        Hp, Zp = teig._qr_sweep(H, Q, k, sigma)
        scale = float(torch.linalg.norm(H))
        assert float((Hf - Hp).abs().max()) <= 1e-5 * scale, (n, k)
        assert float((Zf - Zp).abs().max()) <= 1e-5, (n, k)


def _schur_fused(A, max_sweeps_per_eig=30):
    """ops/eig.py::_schur_plain with the fused float32 sweep."""
    n = A.shape[-1]
    H, Z = teig.hessenberg(A)
    eps = torch.finfo(torch.float32).eps
    fnorm = torch.linalg.norm(H)
    tolfb = eps * torch.where(fnorm > 0, fnorm, 1.0)
    sub_r, sub_c = torch.arange(1, n), torch.arange(n - 1)

    def deflate(H):
        dabs = torch.diagonal(H).abs()
        tol = eps * (dabs[:-1] + dabs[1:])
        tol = torch.where(tol > 0, tol, tolfb)
        sub = H[sub_r, sub_c]
        conv = sub.abs() <= tol
        H[sub_r, sub_c] = torch.where(conv, torch.zeros_like(sub), sub)
        return int(torch.max(torch.where(conv, 0, sub_c + 1)))

    k = deflate(H)
    it = stag = 0
    while k > 0 and it < max_sweeps_per_eig * n:
        sigma = teig._wilkinson_shift(H, k, stag)
        H, Z = mirror_qr_sweep(H, Z, k, sigma, sweep_fused)
        k_new = deflate(H)
        stag = 0 if k_new < k else stag + 1
        k = k_new
        it += 1
    return torch.triu(H), Z, it


def test_schur_iteration_with_fused_sweep_keeps_eigenvalues_and_sweeps():
    rng = np.random.default_rng(48)
    A = torch.as_tensor(rng.standard_normal((48, 48)) + 1j * rng.standard_normal((48, 48)),
                        dtype=torch.complex64)
    T, Z, it = _schur_fused(A)
    Tp, Zp, (itp, _) = teig._schur_plain(A)
    lam, lamp = torch.diagonal(T).numpy(), torch.diagonal(Tp).numpy()
    D = np.abs(lam[:, None] - lamp[None, :])
    from scipy.optimize import linear_sum_assignment
    r, c = linear_sum_assignment(D)
    assert D[r, c].max() / np.abs(lamp).max() < 1e-4
    assert abs(it - itp) <= 0.05 * itp, (it, itp)
    assert float(torch.linalg.norm(A @ Z - Z @ T) / torch.linalg.norm(A)) < 1e-5

