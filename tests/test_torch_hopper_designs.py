"""Host-side checks of the two Hopper kernel designs, on the CPU.

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
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from feast_tpu import cx as jcx
from feast_tpu.ops import pallas_kernels as pk
from feast_tpu_torch import cx
from feast_tpu_torch.ops import panel_lu

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
