"""The LU factor's trailing update, C <- C + alpha A B in place
(`ops/cmatmul_kernel.py::addmm_`): on the card the tensor-core kernel
`csrc/cmatmul.cu` with beta = 1, on the CPU its plain version.

The CPU tests hold the plain version to `baddbmm_`; the tests marked `cuda`
hold the kernel to `baddbmm_` (cuBLAS's cgemm) and to complex128 at the
cells' first trailing updates, and the whole K1-route factor to the same
factor with cuBLAS's update.  The file imports neither JAX nor feast_tpu,
so on the card it runs with the repository's root conftest disabled:

    python -m pytest --noconftest -m cuda tests/test_torch_trail_update.py -q
"""

import numpy as np
import pytest
import torch

from feast_tpu_torch.kernels import _build
from feast_tpu_torch.ops import cmatmul_kernel, lu as lumod, panel_lu, row_swap
from feast_tpu_torch.utils import tracing

C64, C128 = torch.complex64, torch.complex128


def _randn(gen, shape, device="cpu", dtype=C64):
    return torch.randn(shape, dtype=dtype, device=device, generator=gen)


# ---------------------------------------------------------------------------
# the plain version and the wrapper, on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch,M,K,N,alpha", [
    ((), 40, 16, 40, -1.0), ((), 300, 128, 300, -1.0), ((3,), 70, 33, 129, 1.0),
    ((2,), 129, 200, 65, -0.5), ((), 1, 17, 1, 2.0), ((4,), 96, 0, 32, -1.0)])
def test_addmm_plain_matches_baddbmm(batch, M, K, N, alpha):
    """In complex128 the plain version is baddbmm_ to rounding; in complex64
    its error against complex128 is at most the library's."""
    gen = torch.Generator().manual_seed(M + K + N)
    a, b, c = (_randn(gen, batch + s, dtype=C128) for s in ((M, K), (K, N), (M, N)))
    B = int(np.prod(batch))

    def library(c, a, b):
        return c.reshape((B, M, N)).clone().baddbmm_(
            a.reshape((B, M, K)), b.reshape((B, K, N)), alpha=alpha).reshape(c.shape)

    want = library(c, a, b)
    got = cmatmul_kernel.addmm_(c.clone(), a, b, alpha)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-13 * max(K, 1) * scale
    a, b, c = a.to(C64), b.to(C64), c.to(C64)
    ref = c.to(C128) + alpha * (a.to(C128) @ b.to(C128))
    lib = library(c, a, b)
    got = cmatmul_kernel.addmm_(c.clone(), a, b, alpha)
    err = float((got.to(C128) - ref).abs().max())
    err_lib = float((lib.to(C128) - ref).abs().max())
    assert err <= 2 * err_lib + 1e-7 * scale, (err, err_lib)


@pytest.mark.parametrize("e", [64, 128])
def test_addmm_in_place_on_a_strided_view(e):
    """On A3[:, e:, e:] with L21 and U12 views of the same buffer, as the
    factor calls it: C updated, every entry outside C bit for bit unchanged,
    no launch counted for the plain version."""
    gen = torch.Generator().manual_seed(e)
    A3 = _randn(gen, (3, e + 150, e + 150))
    keep = A3.clone()
    before = cmatmul_kernel.acc_launches, cmatmul_kernel.launches
    out = cmatmul_kernel.addmm_(A3[:, e:, e:], A3[:, e:, :e], A3[:, :e, e:], -1.0)
    assert out.data_ptr() == A3[:, e:, e:].data_ptr()
    assert (cmatmul_kernel.acc_launches, cmatmul_kernel.launches) == before
    assert torch.equal(A3[:, :e], keep[:, :e]) and torch.equal(A3[:, e:, :e], keep[:, e:, :e])
    want = keep[:, e:, e:].baddbmm(keep[:, e:, :e], keep[:, :e, e:], alpha=-1)
    assert float((A3[:, e:, e:] - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_addmm_checks_shapes():
    z = torch.zeros((2, 8, 8), dtype=C64)
    with pytest.raises(ValueError, match="shapes"):
        cmatmul_kernel.addmm_(z, z[:, :, :4], z)
    with pytest.raises(ValueError, match="c of shape"):
        cmatmul_kernel.addmm_(z[0], z, z)
    with pytest.raises(ValueError, match="c of shape"):
        cmatmul_kernel.addmm_(z[:, :, :4], z, z)


def test_launch_counters_of_another_name():
    """A count other than `launches` (the update form's `acc_launches`)
    goes into a graph's tally under "module:counter" and is added on every
    replay, beside the module's `launches`."""
    name = cmatmul_kernel.__name__
    before = cmatmul_kernel.acc_launches, cmatmul_kernel.launches
    try:
        with _build.tally_launches() as tally:
            _build.count_launch(name, "acc_launches")
            _build.count_launch(name)
        assert tally == {f"{name}:acc_launches": 1, name: 1}
        assert (cmatmul_kernel.acc_launches, cmatmul_kernel.launches) == before
        _build.add_launches(tally)
        _build.add_launches(tally)
        assert cmatmul_kernel.acc_launches == before[0] + 2
        assert cmatmul_kernel.launches == before[1] + 2
    finally:
        cmatmul_kernel.acc_launches, cmatmul_kernel.launches = before


# ---------------------------------------------------------------------------
# the kernel, on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (sm_90a) and nvcc")
    return torch.device("cuda", 0)


def _check_update(buf, e, alpha=-1.0, rows=None, pick=None, oracle="library"):
    """addmm_ on C = buf[:, e:, e:] from L21 = buf[:, e:, :e] and U12 =
    buf[:, :e, e:]: one launch of the update form, every entry outside C
    unchanged bit for bit, and an error against complex128 (on the matrices
    `pick` and the rows `rows` of C, all where None) at most twice the
    oracle's on the same complex64 inputs: "library", cuBLAS's baddbmm_,
    or "plain", `addmm_plain` (fp32 products on the planes).  Returns
    (error, the oracle's)."""
    Bsz, n, _ = buf.shape
    M = n - e
    pick = list(range(Bsz)) if pick is None else pick
    rows = torch.arange(M, device=buf.device) if rows is None else rows

    def sample(T):   # (len(pick), rows, columns of C) of a (Bsz, M, *) view, complex128
        return torch.stack([T[i].index_select(0, rows) for i in pick]).to(C128)

    ref = sample(buf[:, e:, e:]) + alpha * (sample(buf[:, e:, :e])
                                            @ torch.stack([buf[i, :e, e:] for i in pick]).to(C128))
    other = buf.clone()
    if oracle == "library":
        other[:, e:, e:].baddbmm_(other[:, e:, :e], other[:, :e, e:], alpha=alpha)
    else:
        cmatmul_kernel.addmm_plain(other[:, e:, e:], other[:, e:, :e], other[:, :e, e:], alpha)
    err_other = float((sample(other[:, e:, e:]) - ref).abs().max())
    del other
    keep = buf.clone()
    before = cmatmul_kernel.acc_launches, cmatmul_kernel.launches
    cmatmul_kernel.addmm_(buf[:, e:, e:], buf[:, e:, :e], buf[:, :e, e:], alpha)
    torch.cuda.synchronize()
    assert (cmatmul_kernel.acc_launches, cmatmul_kernel.launches) == (before[0] + 1, before[1])
    assert torch.equal(buf[:, :e], keep[:, :e]) and torch.equal(buf[:, e:, :e], keep[:, e:, :e])
    del keep
    err = float((sample(buf[:, e:, e:]) - ref).abs().max())
    assert err <= 2 * err_other, (err, err_other)
    return err, err_other


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n,alpha", [
    (1, 512, -1.0), (64, 512, -1.0), (2, 300, 1.0), (5, 700, 1.0), (3, 200, -1.0)])
def test_update_small_and_ragged(dev, batch, n, alpha):
    """Rank-128 updates at small shapes, M and N no multiple of the
    128 x 128 tile, alpha +-1, against cuBLAS's baddbmm_."""
    gen = torch.Generator(device=dev).manual_seed(n + batch)
    _check_update(_randn(gen, (batch, n, n), dev), 128, alpha)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n,e", [(3, 200, 72), (1, 129, 1), (2, 250, 33), (16, 1024, 896)])
def test_update_of_any_depth(dev, batch, n, e):
    """K = e no multiple of the 16-deep stage, down to 1, and deep, against
    the plain version: 3xTF32 keeps fp32's accuracy per product, but at a
    small K cuBLAS's few fp32 roundings are fewer than its splits'."""
    gen = torch.Generator(device=dev).manual_seed(n + batch + e)
    _check_update(_randn(gen, (batch, n, n), dev), e, -1.0, oracle="plain")


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n", [(16, 10240), (4, 20480), (4, 9984)])
def test_update_at_the_cells_first_trailing_update(dev, batch, n):
    """16 x 10112 x 128 x 10112 (dense10240), 4 x 20352 x 128 x 20352 (a
    node4 rank), 4 x 9856 x 128 x 9856 (a gun chunk), on the rows of C
    nearest its two edges of the first and the last matrix, against cuBLAS's
    baddbmm_."""
    gen = torch.Generator(device=dev).manual_seed(n + batch)
    buf = _randn(gen, (batch, n, n), dev)
    M = n - 128
    rows = torch.cat([torch.arange(64), torch.arange(M - 64, M)]).to(dev)
    _check_update(buf, 128, -1.0, rows=rows, pick=[0, batch - 1])


@pytest.mark.cuda
def test_update_with_unaligned_operands(dev):
    """Bases 8 but not 16 bytes aligned and odd row strides take the
    8-byte copies and stores: the same contract."""
    gen = torch.Generator(device=dev).manual_seed(5)
    flat = _randn(gen, (3 * 301 * 301 + 1,), dev)
    buf = flat[1:].view(3, 301, 301)
    assert buf.data_ptr() % 16 == 8
    _check_update(buf, 128, -1.0)
    _check_update(buf, 45, -1.0, oracle="plain")
    a = flat[7:7 + 97 * 61].view(97, 61)
    b = flat[20000:20000 + 61 * 300].view(61, 300)[:, 3:83]
    c = flat[40001:40001 + 97 * 90].view(97, 90)[:, 5:85]
    ref = c.to(C128) + a.to(C128) @ b.to(C128)
    plain = cmatmul_kernel.addmm_plain(c.clone(), a, b, 1.0)
    cmatmul_kernel.addmm_(c, a, b, 1.0)
    err_plain = float((plain.to(C128) - ref).abs().max())
    assert float((c.to(C128) - ref).abs().max()) <= 2 * err_plain


def _planted_nodes(dev, batch, n, seed):
    """z_i I - A for `batch` nodes on a circle around the middle of A's
    planted spectrum (A = Q D Q^H, D = diag(1..n)/n, Haar Q), complex64."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    Q, _ = torch.linalg.qr(_randn(gen, (n, n), dev, C128))
    d = torch.arange(1, n + 1, device=dev, dtype=torch.float64) / n
    A = (Q * d) @ Q.mH
    z = 0.5 + (20 / n) * torch.exp(2j * np.pi * (torch.arange(batch, device=dev) + 0.5) / batch)
    S = z[:, None, None] * torch.eye(n, device=dev, dtype=C128) - A
    return S.to(C64)


def _factor_with_library_update(A):
    """lu_factor_panel's loop with cuBLAS's baddbmm_ as the trailing update:
    the test's oracle, which the program no longer runs."""
    A3 = A.clone()
    n, block = A3.shape[-1], 128
    perm = torch.arange(n, device=A.device).repeat(A3.shape[0], 1)
    for j in range(0, n, block):
        e = j + block
        _, pb, invL = panel_lu.panel_factor(A3[:, :, j:e], j)
        row_swap.apply_panel_perm(A3, pb, j, block)
        perm = torch.gather(perm, 1, pb.long())
        if e < n:
            A3[:, j:e, e:] = invL @ A3[:, j:e, e:]
            A3[:, e:, e:].baddbmm_(A3[:, e:, j:e], A3[:, j:e, e:], alpha=-1)
    return A3, perm


def _backward_error(A, LU, perm):
    """||P A - L U||_F / ||A||_F in complex128, a matrix at a time."""
    out = []
    for i in range(A.shape[0]):
        L = torch.tril(LU[i].to(C128), -1) + torch.eye(A.shape[-1], device=A.device, dtype=C128)
        PA = A[i].to(C128)[perm[i]]
        out.append(float(torch.linalg.norm(PA - L @ torch.triu(LU[i].to(C128)))
                         / torch.linalg.norm(PA)))
    return max(out)


@pytest.mark.cuda
def test_k1_route_factor_against_the_library_update(dev):
    """The whole K1-route factor of a planted 16 x 4096 batch of node
    matrices: 31 trailing updates on the kernel, none on the library, and a
    backward error at most twice the cuBLAS route's."""
    A = _planted_nodes(dev, 16, 4096, 19)
    before = cmatmul_kernel.acc_launches
    LU, perm = lumod.lu_factor(A)
    torch.cuda.synchronize()
    assert cmatmul_kernel.acc_launches - before == 4096 // 128 - 1
    LUl, perml = _factor_with_library_update(A)
    err, err_lib = _backward_error(A, LU, perm), _backward_error(A, LUl, perml)
    assert err <= 2 * err_lib, (err, err_lib)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,n", [(16, 4096), (4, 9956)])
def test_factor_spans_read_every_trailing_update_on_the_kernel(dev, batch, n):
    """The `*.factor.lu` span's `trail_kernel_updates` over `trail_updates`
    reads 1: every trailing update of the factor ran on the kernel (n =
    9956 padded to 9,984: 77 updates a matrix)."""
    buf = lumod.factor_buffer((batch,), n, C64, dev)
    gen = torch.Generator(device=dev).manual_seed(n)
    buf[:, :n, :n] = _randn(gen, (batch, n, n), dev)
    tracing.clear()
    try:
        with tracing.recording(), tracing.span("feast.factor.lu", dev) as sp:
            lumod.lu_factor_inplace(buf, n, span=sp)
        torch.cuda.synchronize()
        attrs = tracing.spans()[0]["attrs"]
    finally:
        tracing.clear()
    updates = batch * (buf.shape[-1] // 128 - 1)
    assert attrs["trail_updates"] == attrs["trail_kernel_updates"] == updates
