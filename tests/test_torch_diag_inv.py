"""The diagonal-block inverses of the LU factor (`ops/lu.py::lu_diag_inv`):
the tiled route (`ops/diag_inv.py`: 64 x 64 tiles, then the doubling)
against the row-by-row substitution of `lu_diag_inv_plain`, and the
factor spans that count them.

The CPU tests run the doubling with the plain tile step; the tests marked
`cuda` run the kernel `csrc/diag_inv.cu` on the card.  The file imports
neither JAX nor feast_tpu, so on the card it runs with the repository's
root conftest disabled:

    python -m pytest --noconftest -m cuda tests/test_torch_diag_inv.py -q
"""

import collections
import importlib

import numpy as np
import pytest
import torch

import feast_tpu_torch as ft
from feast_tpu_torch.ops import diag_inv
from feast_tpu_torch.ops import lu as lumod
from feast_tpu_torch.utils import tracing

fmod = importlib.import_module("feast_tpu_torch.solvers.feast")

C64, C128 = torch.complex64, torch.complex128


def _factor(rng, batch, n, dtype=C128, device="cpu"):
    """The LU factor of random complex matrices (|L| <= 1 by pivoting)."""
    A = rng.standard_normal(batch + (n, n)) + 1j * rng.standard_normal(batch + (n, n))
    LU, _ = lumod.lu_factor(torch.as_tensor(A + 2.0 * np.eye(n)))
    return LU.to(dtype).to(device)


def _rel(got, want):
    """Largest entry error over each block's largest entry."""
    scale = want.abs().amax(dim=(-2, -1), keepdim=True)
    return float(((got - want).abs() / scale).max())


def _with_zero_pivot(LU, row):
    LU = LU.clone()
    LU[..., row, row] = 0
    return LU


# ---------------------------------------------------------------------------
# CPU: the doubling with the plain tile step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("block,n", [(128, 300), (512, 1100), (512, 512)])
def test_doubling_matches_the_substitution(block, n):
    """Tiles of 64, then log2(block / 64) levels of products, against the
    row-by-row substitution over whole blocks, in complex128; n past a
    multiple of the block exercises the identity extension of the last."""
    LU = _factor(np.random.default_rng(block + n), (2,), n)
    got = diag_inv.doubling(*diag_inv.tiles(LU, block))
    want = lumod.lu_diag_inv_plain(LU, block)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, -(-n // block), block, block)
        assert _rel(g, w) < 1e-11


def test_doubling_keeps_the_zero_pivot_guard():
    """An exact zero on U's diagonal: the tiles take the floor of the whole
    block (eps * max|U| over its upper triangle), as the substitution does."""
    LU = _with_zero_pivot(_factor(np.random.default_rng(3), (), 300), 200)
    got = diag_inv.doubling(*diag_inv.tiles(LU, 128))
    want = lumod.lu_diag_inv_plain(LU, 128)
    assert float(want[1].abs().max()) > 1e12         # 1 / (eps max|U|)
    for g, w in zip(got, want):
        assert _rel(g, w) < 1e-11


def test_plain_tiles_lay_out_the_doubling():
    """The tile step's output: each diagonal 64-tile the inverse of that
    tile, the triangle's other entries negated, zeros elsewhere, and the
    identity past n."""
    n, block, t = 200, 128, 64
    LU = _factor(np.random.default_rng(4), (), n)
    Lw, Uw = diag_inv.tiles_plain(LU, block)
    assert Lw.shape == Uw.shape == (2, block, block)
    last = n - block                                       # rows of the last block
    L1 = torch.tril(LU[block:, block:], -1) + torch.eye(last, dtype=C128)
    U1 = torch.triu(LU[block:, block:])
    lo = torch.tril(torch.ones(block, block, dtype=torch.bool), -1)
    for k in range(2):
        for i in range(0, block, t):
            for j in range(0, block, t):
                L, U = Lw[k, i:i + t, j:j + t], Uw[k, i:i + t, j:j + t]
                if i != j:
                    assert torch.all((L == 0) | lo[i:i + t, j:j + t])
                    assert torch.all((U == 0) | ~lo[i:i + t, j:j + t])
    torch.testing.assert_close(Lw[1, last:, :last], torch.zeros(block - last, last, dtype=C128))
    torch.testing.assert_close(Lw[1, 64:, :64][:last - 64], -L1[64:, :64])
    torch.testing.assert_close(Uw[1, :64, 64:last], -U1[:64, 64:])
    eye = torch.eye(t, dtype=C128)
    torch.testing.assert_close(Lw[1, :t, :t] @ L1[:t, :t], eye)
    torch.testing.assert_close(Uw[1, :t, :t] @ U1[:t, :t], eye)
    # the second tile holds rows 64..71 of the matrix, then the identity
    tail = torch.eye(t, dtype=C128)
    tail[:last - t, :last - t] = U1[t:, t:]
    torch.testing.assert_close(Uw[1, t:, t:] @ tail, eye)


@pytest.mark.parametrize("block,s", [(128, 64), (512, 64), (512, 256)])
def test_pairs_view_every_tile_pair(block, s):
    """`_pairs` at width s: the A, B, C and D blocks of every 2s-pair along
    the diagonal of every matrix, as views of the matrices themselves."""
    X = torch.arange(3 * block * block, dtype=torch.float64).view(3, block, block)
    views = diag_inv._pairs(X, s)
    for v, (i, j) in zip(views, ((0, 0), (0, s), (s, 0), (s, s))):
        assert v.shape == (3, block // (2 * s), s, s)
        assert v.untyped_storage().data_ptr() == X.untyped_storage().data_ptr()
        for p in range(block // (2 * s)):
            q = 2 * s * p
            assert torch.equal(v[:, p], X[:, q + i:q + i + s, q + j:q + j + s])


@pytest.mark.parametrize("block", [32, 64, 96, 128, 192, 512, 1024])
def test_kernel_blocks_are_64_times_a_power_of_two(block):
    assert diag_inv.kernel_block(block) == (block in (64, 128, 512, 1024))


def test_cpu_takes_the_substitution():
    """Off the kernel route (the CPU, complex128) `lu_diag_inv` is the plain
    substitution, entry for entry."""
    LU = _factor(np.random.default_rng(5), (), 150)
    for g, w in zip(lumod.lu_diag_inv(LU, 64), lumod.lu_diag_inv_plain(LU, 64)):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# CPU: the factor spans
# ---------------------------------------------------------------------------

@pytest.fixture
def fresh():
    tracing.clear()
    yield
    tracing.clear()


def _dense_spans():
    n, N = 200, 4
    rng = np.random.default_rng(6)
    A = torch.as_tensor(rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
    z = torch.as_tensor(rng.standard_normal(N) + 1j * rng.standard_normal(N))
    with tracing.recording():
        with tracing.span("feast.solve"):
            LU, perm, dinv = fmod._factor_scan(A, None, z, True)
    return LU, dinv, tracing.spans()


def test_dense_factor_span_counts_the_blocks(fresh):
    """`feast.factor.diag_inv` under `feast.factor`: 4 nodes of n = 200 in
    blocks of 64 are 16 blocks, none of them on the kernel route here."""
    _, _, recs = _dense_spans()
    by_id = {r["id"]: r for r in recs}
    got = [r for r in recs if r["name"] == "feast.factor.diag_inv"]
    assert len(got) == 1
    assert by_id[got[0]["parent"]]["name"] == "feast.factor"
    assert got[0]["attrs"] == {"blocks": 16, "kernel_blocks": 0}


def test_kernel_route_counts_its_blocks(fresh, monkeypatch):
    """With the kernel route taken (on the CPU: the plain tile step under
    the doubling) every block counts as the kernel's, and the inverses are
    the tiled route's."""
    monkeypatch.setattr(lumod, "_kernel_route", lambda dtype, device: dtype == C64)
    LU, dinv, recs = _dense_spans()
    rec = next(r for r in recs if r["name"] == "feast.factor.diag_inv")
    assert rec["attrs"] == {"blocks": 16, "kernel_blocks": 16}
    want = diag_inv.doubling(*diag_inv.tiles(LU, 64))
    for g, w in zip(dinv, want):
        assert torch.equal(g, w)


def test_nlfeast_chunk_span_counts_the_blocks(fresh):
    """One `nlfeast.factor.diag_inv` under each chunk's `nlfeast.factor`:
    4 nodes of n = 96 in blocks of 64 are 8 blocks a chunk."""
    T = ft.problems.gun_like(96, planted=8, cluster=(50.0, 56.0), device="cpu")
    rng = np.random.default_rng(3)
    X0 = rng.standard_normal((96, 20)) + 1j * rng.standard_normal((96, 20))
    with tracing.recording():
        ft.nlfeast(T, X0, nodes=16, c=53.0, r=5.0, tol=1e-10, mixed_prec=True,
                   store=False, device="cpu")
    recs = tracing.spans()
    by_id = {r["id"]: r for r in recs}
    names = collections.Counter(r["name"] for r in recs)
    assert names["nlfeast.factor.diag_inv"] == names["nlfeast.factor"] >= 4
    for r in recs:
        if r["name"] == "nlfeast.factor.diag_inv":
            assert by_id[r["parent"]]["name"] == "nlfeast.factor"
            assert r["attrs"] == {"blocks": 8, "kernel_blocks": 0}


# ---------------------------------------------------------------------------
# the card: the kernel route
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc")
    return torch.device("cuda", 0)


def _buffer_factor(dev, rng, batch, n):
    """A complex64 factor on the card as the solvers hold it: the strided
    crop LU = buf[..., :n, :n] of a padded `factor_buffer`."""
    A = rng.standard_normal(batch + (n, n)) + 1j * rng.standard_normal(batch + (n, n))
    buf = lumod.factor_buffer(batch, n, C64, dev)
    buf[..., :n, :n] = torch.as_tensor(A + 2.0 * np.eye(n), dtype=C64, device=dev)
    LU, perm = lumod.lu_factor_inplace(buf, n)
    assert LU.data_ptr() == buf.data_ptr() and not LU.is_contiguous()
    return LU, perm


@pytest.mark.cuda
@pytest.mark.parametrize("block,n", [(64, 300), (128, 300), (512, 1100)])
def test_kernel_route_matches_the_substitution(dev, block, n):
    """The kernel route's (invL, invU) of a strided (2, 3)-batch factor
    against the substitution in complex128 on the same factor; one kernel
    launch a call.  The limit, 1e-4 of each block's largest entry: the
    complex64 substitution reads up to 1.3e-5 on these factors, the same
    doubling over the plain tiles on the CPU 2.4e-5 (at b = 512)."""
    LU, _ = _buffer_factor(dev, np.random.default_rng(block), (2, 3), n)
    before = diag_inv.launches
    got = lumod.lu_diag_inv(LU, block)
    torch.cuda.synchronize()
    assert diag_inv.launches - before == 1
    want = lumod.lu_diag_inv_plain(LU.to(C128), block)
    for g, w in zip(got, want):
        assert g.dtype == C64 and g.shape == w.shape == (2, 3, -(-n // block), block, block)
        assert _rel(g.to(C128), w) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("block,n", [(64, 300), (512, 1100)])
def test_kernel_tiles_are_the_plain_tiles(dev, block, n):
    """The kernel's tile step against its plain version on the same
    complex64 factor: the copied tiles entry for entry, the inverted ones
    to complex64 rounding."""
    LU, _ = _buffer_factor(dev, np.random.default_rng(n), (2,), n)
    Lk, Uk = diag_inv.tiles(LU, block)
    Lp, Up = diag_inv.tiles_plain(LU, block)
    t = diag_inv.TILE
    diag = torch.zeros(block, block, dtype=torch.bool, device=dev)
    for i in range(0, block, t):
        diag[i:i + t, i:i + t] = True
    for k, p in ((Lk, Lp), (Uk, Up)):
        assert torch.equal(k[..., ~diag], p[..., ~diag])
        assert _rel(torch.where(diag, k, 0), torch.where(diag, p, 0)) < 1e-5


@pytest.mark.cuda
def test_kernel_zero_pivot_guard(dev):
    """An exact zero pivot of U: the kernel substitutes the complex64 floor
    eps * max(sqrt(max |U|^2 over the block's upper triangle), sqrt(tiny)),
    the identity extension's ones counted; the substitution in complex128
    given that floor in the pivot's place agrees."""
    n, block = 1100, 512
    LU, _ = _buffer_factor(dev, np.random.default_rng(8), (2,), n)
    for row in (700, 1090):                         # a full block, and the last
        pivot = LU[1, row, row].clone()
        LU[1, row, row] = 0
        got = lumod.lu_diag_inv(LU, block)
        j = row // block
        blk = torch.triu(LU[1, j * block:(j + 1) * block, j * block:(j + 1) * block])
        m = float((blk.real * blk.real + blk.imag * blk.imag).max())
        if (j + 1) * block > n:
            m = max(m, 1.0)
        fi = torch.finfo(torch.float32)
        floor = np.float32(fi.eps) * max(np.sqrt(np.float32(m)), np.float32(fi.tiny ** 0.5))
        ref = LU.to(C128)
        ref[1, row, row] = float(floor)
        want = lumod.lu_diag_inv_plain(ref, block)
        r = row - j * block
        assert float(got[1][1, j, r, r].real) == pytest.approx(1 / float(floor), rel=1e-6)
        for g, w in zip(got, want):
            assert _rel(g.to(C128), w) < 1e-4
        LU[1, row, row] = pivot


@pytest.mark.cuda
def test_lu_solve_with_and_without_kernel_dinv(dev):
    """lu_solve with the kernel route's inverses gives the solution of the
    substitution without them, to test_torch_lu's tolerance taken to
    complex64 (1e-12 in complex128 is 4,500 eps; here 4,500 eps of
    complex64, 5.4e-4), one matrix without batch dims (the node loop)."""
    n, k = 1100, 7
    LU, perm = _buffer_factor(dev, np.random.default_rng(9), (1,), n)
    LU, perm = LU[0], perm[0]
    Bt = torch.randn((n, k), dtype=C64, device=dev, generator=torch.Generator(dev).manual_seed(9))
    X0 = lumod.lu_solve(LU, perm, Bt)
    X1 = lumod.lu_solve(LU, perm, Bt, dinv=lumod.lu_diag_inv(LU, 512))
    scale = float(X0.abs().max())
    assert float((X1 - X0).abs().max()) / scale < 4500 * torch.finfo(torch.float32).eps
