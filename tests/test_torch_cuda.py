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
from feast_tpu_torch import cx
from feast_tpu_torch.ops import (cmatmul_kernel, dia_kernel, lu, panel_lu,
                                 row_swap, schur_kernel, sparse)

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


def _panel_equal(slab, j0):
    sk, pk, ik = panel_lu.panel_factor(slab.clone(), j0)
    sp, pp, ip = panel_lu.panel_factor_plain(slab.clone(), j0)
    assert torch.equal(pk, pp)
    assert torch.equal(sk, sp)
    assert torch.equal(ik, ip)
    return pk


@pytest.mark.parametrize("n", [128, 1024, 4096, 8192])
@pytest.mark.parametrize("batch", [1, 3, 16])
@pytest.mark.parametrize("where", ["top", "middle", "bottom"])
def test_panel_cluster_kernel_bit_equal(dev, n, batch, where):
    """The cluster kernel is bit for bit the plain version: same pivots, slab
    and L11 inverse, on every slab height, batch and panel position."""
    j0 = min({"top": 0, "middle": n // 2, "bottom": n - 128}[where], n - 128)
    g = torch.Generator(device=dev).manual_seed(n + batch)
    base = torch.randn((batch, n, 128), dtype=torch.complex64, device=dev, generator=g)
    _panel_equal(base, j0)


def test_panel_cluster_kernel_ties_and_zero_pivots(dev):
    """Exact ties in |.|^2 across the row ranges of different blocks of a
    cluster (the lowest index wins), an all-zero column and an all-zero slab
    (the eps * max|slab| substitute)."""
    n, b = 1024, 128
    plan = panel_lu.card_plan(n, b, 0, 3)
    assert plan["C"] > 1 and plan["rows_per"] < 700
    rng = np.random.default_rng(7)
    vals = rng.integers(-2, 3, (3, n, b)) + 1j * rng.integers(-2, 3, (3, n, b))
    vals[0, :, 0] = 0.1
    vals[0, 700, 0] = 3j            # |.|^2 = 9 in two blocks' ranges
    vals[0, 100, 0] = -3
    vals[1, :, 5] = 0               # a whole column of zeros: a zero pivot at k = 5
    vals[2] = 0
    slab = torch.as_tensor(vals, dtype=torch.complex64, device=dev)
    perm = _panel_equal(slab, 0)
    assert int(perm[0, 0]) == 100
    # small-integer entries: many ties in every column, and the j0 > 0 case
    _panel_equal(slab, 512)


def test_panel_card_plan_matches_host_mirror(dev):
    for n, j0, batch in ((4096, 0, 16), (4096, 3968, 16), (1024, 0, 3), (16384, 0, 16),
                         (8192, 4096, 1), (4096, 0, 64)):
        plan = panel_lu.card_plan(n, 128, j0, batch)
        fits = plan.pop("fits")
        host = panel_lu.launch_plan(n, 128, j0, batch, lambda C, smem: fits[C])
        assert plan == host
    assert panel_lu.card_plan(4096, 128, 0, 16)["C"] > 1


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


def _panel_perm(rng, batch, n, j, b=128):
    """A panel's row permutation as K1 composes it: b swaps of pivot row
    g = j + k with a row p >= g; the first pivot keeps its row, the second
    takes one of the panel's own rows, the third the bottom row."""
    perm = np.tile(np.arange(n), (batch, 1))
    for m in range(batch):
        for k in range(b):
            g = j + k
            p = {0: g, 1: min(g + 5, j + b - 1), 2: n - 1}.get(k, rng.integers(g, n))
            perm[m, [g, p]] = perm[m, [p, g]]
    return perm


@pytest.mark.parametrize("n,batch", [(256, 1), (256, 3), (256, 16), (256, 64),
                                     (4224, 1), (4224, 3), (4224, 16), (4224, 64),
                                     (10240, 1)])
@pytest.mark.parametrize("where", ["first", "middle", "last"])
def test_row_swap_kernel_is_the_gather(dev, n, batch, where):
    """The row swap kernel is bit for bit its plain version (the gather of
    every row >= j) on the columns outside the panel, leaves the panel's
    columns alone, and counts the rows the permutation moves (4224: the
    padded 4100)."""
    b = 128
    j = {"first": 0, "middle": (n // b // 2) * b, "last": n - b}[where]
    rng = np.random.default_rng(n + batch + j)
    perm = _panel_perm(rng, batch, n, j, b)
    pt = torch.as_tensor(perm, dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(n + batch)
    A = torch.randn((batch, n, n), dtype=torch.complex64, device=dev, generator=g)
    want = A.clone()
    row_swap.apply_panel_perm_plain(want, pt, j, b)
    moved = torch.zeros((), dtype=torch.int64, device=dev)
    before = row_swap.launches
    row_swap.apply_panel_perm(A, pt, j, b, moved)
    torch.cuda.synchronize()
    assert row_swap.launches - before == 1
    assert torch.equal(A, want)
    assert int(moved) == int((perm != np.arange(n)).sum())


def test_factor_of_a_node_batch_in_place(dev):
    """One `lu_factor_inplace` of a 16 x 4096 batch in its buffer, under a
    recording span: 32 K1 launches and 32 row swap launches, each in its
    own tally; the peak memory of the factor stays under the store plus 5%
    (no copy of the store, no (n - j)^2 temporaries); the span's moved rows
    at most 2b a panel and matrix, of gathered rows 16 sum (n - j)."""
    from feast_tpu_torch.utils import tracing

    B, n = 16, 4096
    lu.lu_factor(torch.randn((2, 256, 256), dtype=torch.complex64, device=dev))  # cuBLAS up
    buf = lu.factor_buffer((B,), n, torch.complex64, dev)
    g = torch.Generator(device=dev).manual_seed(16)
    buf.copy_(torch.randn(buf.shape, dtype=buf.dtype, device=dev, generator=g))
    store = buf.numel() * buf.element_size()
    k1, swaps = panel_lu.launches, row_swap.launches
    tracing.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    try:
        with tracing.recording(), tracing.span("lu", dev) as sp:
            LU, perm = lu.lu_factor_inplace(buf, n, span=sp)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        attrs = tracing.spans()[0]["attrs"]
    finally:
        tracing.clear()
    assert panel_lu.launches - k1 == 32 and row_swap.launches - swaps == 32
    assert LU.data_ptr() == buf.data_ptr()
    assert peak - base <= 0.05 * store, (peak - base) / store
    assert attrs["gathered_rows"] == B * sum(n - j for j in range(0, n, 128))
    assert 0 < attrs["moved_rows"] <= 2 * 128 * 32 * B


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


def test_feast_mesh_world_one_over_nccl(dev, tmp_path):
    """feast(mesh=node_mesh()) at world size 1 over NCCL equals the solve
    without a mesh, and factors its nodes with the panel kernel."""
    import torch.distributed as dist

    A = np.diag(np.arange(1.0, 26.0)).astype(np.complex128)
    rng = np.random.default_rng(0)
    X0 = rng.standard_normal((25, 5)) + 1j * rng.standard_normal((25, 5))
    kw = dict(c=1.5, r=2.0, nodes=8, tol=1e-12, mixed_prec=True, device="cuda")
    ref = ft.feast(A, X0, **kw)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        mesh = ft.parallel.node_mesh(device_type="cuda")
        assert dist.get_backend() == "nccl" and mesh.device_type == "cuda"
        before = panel_lu.launches
        res = ft.feast(A, X0, mesh=mesh, **kw)
        assert panel_lu.launches > before
    finally:
        dist.destroy_process_group()
    assert res.converged and res.n_iter == ref.n_iter
    np.testing.assert_allclose(res.lam.cpu().numpy(), ref.lam.cpu().numpy(), atol=1e-12)


@pytest.mark.parametrize("batch,M,K,N", [((), 256, 256, 256), ((), 300, 130, 384),
                                         ((3,), 70, 33, 129)])
def test_cmatmul_kernel_matches_plain(dev, batch, M, K, N):
    g = torch.Generator(device=dev).manual_seed(M)
    a = torch.randn(batch + (M, K), dtype=torch.complex64, device=dev, generator=g)
    b = torch.randn(batch + (K, N), dtype=torch.complex64, device=dev, generator=g)
    before = cmatmul_kernel.launches
    got = cmatmul_kernel.cmatmul(a, b)
    assert cmatmul_kernel.launches == before + 1
    # fp32 sums over K in another order than the library's matmuls
    assert float((got - cx._cmatmul_planes(a, b)).abs().max()) < 1e-3 * np.sqrt(K)
    # slices of a larger matrix and an operand shared across the batch
    big = torch.randn((2, 200, 200), dtype=torch.complex64, device=dev, generator=g)
    sl, shared = big[:, 40:, 8:72], big[0, :64, 100:]
    ref = cx._cmatmul_planes(sl, shared)
    assert float((cmatmul_kernel.cmatmul(sl, shared) - ref).abs().max()) < 1e-3 * 8
    cx.set_gemm_backend("cuda")
    try:
        assert float((cx.cmatmul(sl, shared) - ref).abs().max()) < 1e-3 * 8
        d = a.to(torch.complex128)
        assert torch.equal(cx.cmatmul(d, d.mH), d @ d.mH)    # complex128: library
    finally:
        cx.set_gemm_backend("torch")


def _cmatmul_vs_complex128(a, b):
    """Kernel and plain errors against complex128; the kernel within 1e-3
    sqrt(K) of the plain version and within 2x its complex128 error."""
    K = a.shape[-1]
    before = cmatmul_kernel.launches
    got = cmatmul_kernel.cmatmul(a, b)
    assert cmatmul_kernel.launches == before + (got.numel() > 0)
    want = cx._cmatmul_planes(a, b)
    ref = a.to(torch.complex128) @ b.to(torch.complex128)
    assert got.shape == ref.shape
    err_k = float((got.to(torch.complex128) - ref).abs().max()) if got.numel() else 0.0
    err_p = float((want.to(torch.complex128) - ref).abs().max()) if got.numel() else 0.0
    assert float((got - want).abs().max() if got.numel() else 0.0) <= 1e-3 * max(K, 1) ** 0.5
    assert err_k <= 2 * err_p + 1e-7, (err_k, err_p)
    return got


@pytest.mark.parametrize("batch,M,K,N", [((), 70, 33, 129), ((3,), 300, 130, 384),
                                         ((2,), 129, 200, 65), ((), 1, 17, 1),
                                         ((16,), 256, 128, 48)])
def test_cmatmul_tensor_core_kernel_accuracy(dev, batch, M, K, N):
    g = torch.Generator(device=dev).manual_seed(M + K)
    a = torch.randn(batch + (M, K), dtype=torch.complex64, device=dev, generator=g)
    b = torch.randn(batch + (K, N), dtype=torch.complex64, device=dev, generator=g)
    _cmatmul_vs_complex128(a, b)


def test_cmatmul_kernel_strides_sharing_alignment_and_empty_k(dev):
    g = torch.Generator(device=dev).manual_seed(9)
    big = torch.randn((2, 300, 300), dtype=torch.complex64, device=dev, generator=g)
    # a row-strided slice, as lu_factor_panel's A3[:, e:, j:e]
    _cmatmul_vs_complex128(big[:, 140:, 12:140], big[:, 12:140, 140:])
    # operands shared across the batch (batch stride 0), either side
    _cmatmul_vs_complex128(big[:, :100, :64], big[0, :64, 7:90])
    _cmatmul_vs_complex128(big[0, :77, :64], big[:, :64, :90])
    # a base that is 8 but not 16 bytes aligned, and an odd row stride
    flat = big.reshape(-1)
    a = flat[1:1 + 97 * 61].view(97, 61)
    assert a.data_ptr() % 16 == 8
    _cmatmul_vs_complex128(a, flat[3:3 + 61 * 299].view(61, 299)[:, :45])
    odd = big[0, :, :299][:, 1:]                       # row stride 300, base offset 1
    _cmatmul_vs_complex128(odd[:50, :33], odd[:33, :70])
    # K = 0: zeros, as the library's product
    z = _cmatmul_vs_complex128(big[:, :5, :0], big[:, :0, :7])
    assert z.shape == (2, 5, 7) and not bool(z.abs().max())


@pytest.mark.parametrize("offs,n,m", [((-1, 0, 1), 700, 16), ((-32, -1, 0, 1, 32), 512, 8),
                                      ((2, 5), 300, 16), ((-7, -3), 300, 16)])
def test_dia_kernel_matches_plain(dev, offs, n, m):
    g = torch.Generator(device=dev).manual_seed(n + m)
    data = torch.randn((3, len(offs), n), dtype=torch.complex64, device=dev, generator=g)
    X = torch.randn((3, n, m), dtype=torch.complex64, device=dev, generator=g)
    before = dia_kernel.launches
    for d, x in ((data, X), (data[0], X), (data, X[0]), (data[1], X[2])):
        want = dia_kernel.dia_matvec_plain(d, offs, x)
        got = dia_kernel.dia_matvec(d, offs, x)
        assert got.shape == want.shape
        # same sums in the same order; fused multiply-adds against rounded products
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    assert dia_kernel.launches == before + 4
    A = sparse.DIA(data[0], offs, (n, n))
    assert float((A.matvec(X[0]) - A._matvec_torch(X[0])).abs().max()) < 1e-4
    assert dia_kernel.launches == before + 5            # the default on the card
    sparse.set_spmm_backend("torch")
    try:
        A.matvec(X[0])
        assert dia_kernel.launches == before + 5
    finally:
        sparse.set_spmm_backend("cuda")
    with pytest.raises(ValueError):                      # complex128 is not the kernel's
        dia_kernel.dia_matvec(data.to(torch.complex128), offs, X.to(torch.complex128))


def test_backends_reject_unknown_names_and_cpu_tensors():
    """Needs no card: an unknown backend name raises ValueError, and the
    opt-in gemm backend "cuda" on complex64 CPU tensors raises instead of
    falling back (the JAX package's "pallas" backends fall back silently
    off the TPU).  The spmm backend has two values and "cuda" is its default:
    the kernel for tensors on the card, the plain product for CPU tensors."""
    with pytest.raises(ValueError):
        sparse.set_spmm_backend("nope")
    with pytest.raises(ValueError):
        cx.set_gemm_backend("nope")
    with pytest.raises(ValueError):
        sparse.set_spmm_backend(None)
    rng = np.random.default_rng(8)
    a = torch.as_tensor(rng.standard_normal((16, 16)) + 0j, dtype=torch.complex64)
    A = sparse.DIA(torch.as_tensor(rng.standard_normal((2, 16)) + 0j, dtype=torch.complex64),
                   (0, 1), (16, 16))
    ref_mm, ref_mv = cx.cmatmul(a, a), A.matvec(a)       # defaults: plain on the CPU
    cx.set_gemm_backend("cuda")
    sparse.set_spmm_backend("torch")
    try:
        with pytest.raises(RuntimeError):
            cx.cmatmul(a, a)
        assert torch.equal(A.matvec(a), ref_mv)
        # other dtypes are not the kernels' and keep the plain product
        d = a.to(torch.complex128)
        assert torch.equal(cx.cmatmul(d, d), d @ d)
        A128 = sparse.DIA(A.data.to(torch.complex128), A.offsets, A.shape)
        assert torch.allclose(A128.matvec(d), ref_mv.to(torch.complex128), atol=1e-6)
    finally:
        cx.set_gemm_backend("torch")
        sparse.set_spmm_backend("cuda")
    assert torch.equal(cx.cmatmul(a, a), ref_mm) and torch.equal(A.matvec(a), ref_mv)


def test_feast_iterative_on_card_launches_dia_kernel(dev):
    """The sparse slice at N = 40: AMG with a complex64 V-cycle on the card."""
    import scipy.sparse as sp

    N = 40
    T1 = sp.diags([np.full(N, 2.0), -np.ones(N - 1), -np.ones(N - 1)], [0, 1, -1], format="csr")
    M1 = sp.diags([np.full(N, 4 / 6), np.full(N - 1, 1 / 6), np.full(N - 1, 1 / 6)],
                  [0, 1, -1], format="csr")
    I = sp.identity(N, format="csr")
    K = (sp.kron(T1, I) + sp.kron(I, T1)).tocsr().astype(np.complex128)
    B = sp.kron(M1, M1).tocsr().astype(np.complex128)
    k = np.arange(1, N + 1)
    t, m = 2 - 2 * np.cos(k * np.pi / (N + 1)), (2 + np.cos(k * np.pi / (N + 1))) / 3
    lam = np.sort(((t[:, None] + t[None, :]) / (m[:, None] * m[None, :])).ravel())
    c, r = complex((lam[0] + lam[4]) / 2), float((lam[4] - lam[0]) * 0.75)
    rng = np.random.default_rng(0)
    X0 = rng.standard_normal((N * N, 8)) + 1j * rng.standard_normal((N * N, 8))
    before = dia_kernel.launches
    res = ft.feast_iterative(K, B, X0, c=c, r=r, nodes=8, iters=8, tol=1e-10,
                             precondition="amg", solver="bicgstab_rr", solve_tol=1e-9,
                             solve_iters=120, device=dev,
                             amg_opts={"dtype": torch.float32, "max_coarse": 100})
    lamf, X, _ = res.filtered()
    exact = lam[np.abs(lam - c) <= r]
    assert res.converged and len(lamf) == len(exact)
    np.testing.assert_allclose(np.sort(lamf.real), exact, rtol=1e-9)
    assert np.linalg.norm(K @ X - (B @ X) * lamf[None, :], axis=0).max() < 1e-10
    assert dia_kernel.launches > before


def _dia_case(dev, offs, n, ncols, m, bd, bx, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    dshape = ((bd,) if bd else ()) + (len(offs), n)
    xshape = ((bx,) if bx else ()) + (ncols, m)
    data = torch.randn(dshape, dtype=torch.complex64, device=dev, generator=g)
    X = torch.randn(xshape, dtype=torch.complex64, device=dev, generator=g)
    return data, X


@pytest.mark.parametrize("offs,n,ncols", [
    ((-1001, -1000, -999, -1, 0, 1, 999, 1000, 1001), 10_007, 10_007),  # ragged n
    ((-300, -5, 0, 7, 300), 3000, 3000),        # diagonals far apart
    ((3, 9, 40), 2000, 2100),                    # upper only, ncols > n
    ((-40, -9, -3), 2000, 1900),                 # lower only, ncols < n
    ((0,), 257, 257)])
@pytest.mark.parametrize("m", [1, 3, 8])
def test_dia_kernel_matches_plain_on_edges(dev, offs, n, ncols, m):
    for bd, bx in ((1, 1), (8, 8), (0, 8), (8, 0)):     # batch 1 and 8, shared data, shared X
        data, X = _dia_case(dev, offs, n, ncols, m, bd, bx, n + m + bd)
        before = dia_kernel.launches
        got = dia_kernel.dia_matvec(data, offs, X)
        assert dia_kernel.launches == before + 1
        want = dia_kernel.dia_matvec_plain(data, offs, X)
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_dia_kernel_many_diagonals_and_wide_rows(dev):
    # 70 diagonals in one launch, summed in the order given (not sorted)
    offs = tuple(range(34, -36, -1))
    data, X = _dia_case(dev, offs, 1000, 1000, 8, 2, 2, 5)
    before = dia_kernel.launches
    got = dia_kernel.dia_matvec(data, offs, X)
    assert dia_kernel.launches == before + 1
    want = dia_kernel.dia_matvec_plain(data, offs, X)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
    # rows of 4000 columns (the runtime column-pair count)
    data, X = _dia_case(dev, (-1, 0, 1), 50, 50, 4000, 0, 0, 6)
    got = dia_kernel.dia_matvec(data, (-1, 0, 1), X)
    want = dia_kernel.dia_matvec_plain(data, (-1, 0, 1), X)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def _schur_invariants(A, T, Z, Y, X, lam_tol=1e-4):
    """Held in complex128, so that inputs far from 1 neither overflow nor
    underflow the norms."""
    A, T, Z, Y, X = (M.to(torch.complex128) for M in (A, T, Z, Y, X))
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    tol = 5e-7 * max(n, 8)
    assert float(torch.tril(T, -1).abs().max()) == 0.0
    assert float((Z.mH @ Z - eye).abs().max()) < tol
    assert float(torch.linalg.norm(A @ Z - Z @ T) / torch.linalg.norm(A)) < tol
    assert float((X @ Y - eye).abs().max()) < 1e-3
    lk = torch.diagonal(T).cpu().numpy().astype(np.complex128)
    lp = np.linalg.eigvals(A.cpu().numpy().astype(np.complex128))
    D = np.abs(lk[:, None] - lp[None, :])
    from scipy.optimize import linear_sum_assignment
    r, c = linear_sum_assignment(D)
    assert D[r, c].max() / np.abs(lp).max() < lam_tol


@pytest.mark.parametrize("n", [2, 3, 8, 31, 32, 33, 48, 64, 112, 113, 114, 128])
def test_schur_warp_kernel_invariants(dev, n):
    """Lane ownership edges (31-33, 64, 128) and Z in shared memory (<= 113)
    or in global memory (114, 128), on a batch of 3 packed into one block."""
    g = torch.Generator(device=dev).manual_seed(100 + n)
    A = torch.randn((3, n, n), dtype=torch.complex64, device=dev, generator=g)
    before = schur_kernel.launches
    T, Z, Y, X, st = schur_kernel.schur(A, want_y=True, return_stats=True)
    assert schur_kernel.launches == before + 1
    for b in range(3):
        _schur_invariants(A[b], T[b], Z[b], Y[b], X[b])
        assert int(st[b, 0]) >= 1


@pytest.mark.parametrize("n", [8, 48, 128])
@pytest.mark.parametrize("scale", [1e-20, 1e-15, 1e18])
def test_schur_warp_kernel_scaled_input(dev, n, scale):
    """Entries far from 1 (1e-20 as in SI units): the kernel scales A by a
    power of two first, so its results hold there too.  (The plain version,
    which squares squared magnitudes in fp32, does not converge at these
    scales, so the kernel is held to numpy's eigenvalues and to its own
    result at scale 1.)"""
    g = torch.Generator(device=dev).manual_seed(200 + n)
    A = torch.randn((n, n), dtype=torch.complex64, device=dev, generator=g)
    T, Z, Y, X, st = schur_kernel.schur(A * scale, want_y=True, return_stats=True)
    _schur_invariants(A * scale, T, Z, Y, X)
    assert int(st[0]) >= 1
    T1, Z1, Y1, X1, st1 = schur_kernel.schur(A, want_y=True, return_stats=True)
    # a power of two changes no bit: T scales, Z, Y, X and the counts do not
    p2 = 2.0 ** round(np.log2(scale))
    T2, Z2, Y2, X2, st2 = schur_kernel.schur(A * p2, want_y=True, return_stats=True)
    assert torch.equal(T2, T1 * p2) and torch.equal(Z2, Z1)
    assert torch.equal(Y2, Y1) and torch.equal(X2, X1) and torch.equal(st2, st1)


def test_schur_warp_kernel_diagonal_input(dev):
    """diag(1:25): already triangular, no sweep; Y = X = I."""
    A = torch.diag(torch.arange(1.0, 26.0)).to(torch.complex64).to(dev)
    T, Z, Y, X, st = schur_kernel.schur(A, want_y=True, return_stats=True)
    eye = torch.eye(25, dtype=A.dtype, device=dev)
    assert int(st[0]) == 0 and torch.equal(T, A)
    assert float((Z.mH @ Z - eye).abs().max()) < 1e-6
    assert float((X @ Y - eye).abs().max()) < 1e-6


@pytest.mark.parametrize("n", [200, 1000, 4100, 9956])
def test_padded_panel_route_bit_equal(dev, n):
    """An n that is no multiple of 128 goes to the panel kernel zero-padded
    to the next multiple: bit for bit the plain version on the padded
    matrix, cropped, one launch per padded panel."""
    batch = 1 if n > 4096 else 2
    n_pad = -(-n // 128) * 128
    g = torch.Generator(device=dev).manual_seed(n)
    A = torch.randn((batch, n, n), dtype=torch.complex64, device=dev, generator=g)
    before = panel_lu.launches
    LU, perm = lu.lu_factor(A)
    assert panel_lu.launches - before == n_pad // 128
    assert LU.shape == (batch, n, n) and perm.shape == (batch, n)
    buf = torch.zeros((batch, n_pad, n_pad), dtype=A.dtype, device=dev)
    buf[:, :n, :n] = A
    LUp, permp = panel_lu.lu_factor_panel(buf, panel=panel_lu.panel_factor_plain,
                                          inplace=True)
    assert torch.equal(perm, permp[:, :n])
    assert torch.equal(LU, LUp[:, :n, :n])
    assert int(perm.max()) < n


def test_nlfeast_mixed_on_card_matches_cpu(dev):
    """A small gun-shaped nlfeast(mixed_prec=True) on the card: the node
    factors through the padded panel kernel (n = 200), the Beyn matrix's
    Schur seed through the Schur kernel; eigenvalues equal to the CPU run's
    to 1e-10."""
    kw = dict(nodes=16, iters=10, c=53.0 + 0.0j, r=5.0, tol=1e-10, spurious=1e-5,
              mixed_prec=True, store=False, factor_chunk=4)
    rng = np.random.default_rng(3)
    X0 = rng.standard_normal((200, 30)) + 1j * rng.standard_normal((200, 30))
    gkw = dict(planted=12, cluster=(50.0, 56.0))
    k1, k2 = panel_lu.launches, schur_kernel.launches
    out = ft.nlfeast(ft.problems.gun_like(200, device=dev, **gkw), X0, device=dev, **kw)
    assert panel_lu.launches > k1 and schur_kernel.launches > k2
    ref = ft.nlfeast(ft.problems.gun_like(200, device="cpu", **gkw), X0, device="cpu", **kw)
    lam, _, res = out.filtered(spurious=1e-5)
    lam_c, _, _ = ref.filtered(spurious=1e-5)
    assert out.converged and len(lam) == len(lam_c) == 12 and res.max() < 1e-10
    np.testing.assert_allclose(np.sort_complex(lam), np.sort_complex(lam_c), atol=1e-10)


def _graph_problem(n=256, m0=16, seed=0):
    rng = np.random.default_rng(seed)
    A = np.diag(np.arange(1.0, n + 1.0)).astype(np.complex128)
    A += 0.05 * (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
    X0 = rng.standard_normal((n, m0)) + 1j * rng.standard_normal((n, m0))
    G = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    B = np.eye(n) + 0.01 * (G + G.conj().T) / np.sqrt(n)
    return A, X0, B


@pytest.mark.parametrize("with_b", [False, True], ids=["std", "pencil"])
def test_feast_compiled_graphs_match_eager_steps(dev, with_b):
    """feast_compiled's sweeps run as CUDA graph replays (capture, then
    replays only) and give the same steps' result run eagerly bit for bit,
    with as many K1 and K2 launches."""
    import importlib

    fmod = importlib.import_module("feast_tpu_torch.solvers.feast")
    A, X0, B = _graph_problem()
    kw = dict(c=5.5, r=5.2, nodes=16, iters=20, tol=1e-10, mixed_prec=True,
              B=B if with_b else None, device=dev)
    fmod.clear_graph_cache()
    counts = []
    results = []
    for fn in (fmod._feast_compiled_steps, ft.feast_compiled, ft.feast_compiled):
        k1, k2 = panel_lu.launches, schur_kernel.launches
        results.append(fn(A, X0, **kw))
        torch.cuda.synchronize()
        counts.append((panel_lu.launches - k1, schur_kernel.launches - k2))
    prog = next(iter(fmod._PROGRAMS.values()))
    assert prog.graphs and prog.replays > 0
    assert counts[0] == counts[1] == counts[2] and counts[0][1] > 0
    p, g, warm = results
    for res in (g, warm):
        assert res.converged and res.n_iter == p.n_iter
        for a, b in zip(res[:4], p[:4]):
            assert torch.equal(a, b)
    fmod.clear_graph_cache()


def test_feast_compiled_graphs_read_new_values_at_one_shape(dev):
    """A cached graph reads each solve's inputs: a second matrix of the same
    shape gives its own eigenvalues, equal to the eager steps'."""
    import importlib

    fmod = importlib.import_module("feast_tpu_torch.solvers.feast")
    A, X0, _ = _graph_problem()
    kw = dict(c=5.5, r=5.2, nodes=16, iters=20, tol=1e-10, mixed_prec=True, device=dev)
    fmod.clear_graph_cache()
    first = ft.feast_compiled(A, X0, **kw)
    A2 = A + 0.25 * np.eye(A.shape[0])
    prog = next(iter(fmod._PROGRAMS.values()))
    second = ft.feast_compiled(A2, X0, **kw)
    assert next(iter(fmod._PROGRAMS.values())) is prog
    steps = fmod._feast_compiled_steps(A2, X0, **kw)
    assert not torch.equal(first.lam, second.lam)
    for a, b in zip(second[:4], steps[:4]):
        assert torch.equal(a, b)
    fmod.clear_graph_cache()


def test_feast_compiled_graphs_with_the_matrix_product_kernel(dev):
    """Under cx.set_gemm_backend("cuda") the node solves' products are K3
    inside the update graph: a new signature, and as many K3 launches per
    solve as the eager steps', with their result."""
    import importlib

    fmod = importlib.import_module("feast_tpu_torch.solvers.feast")
    A, X0, _ = _graph_problem()
    kw = dict(c=5.5, r=5.2, nodes=16, iters=20, tol=1e-10, mixed_prec=True, device=dev)
    ft.feast_compiled(A, X0, **kw)
    key = next(iter(fmod._PROGRAMS))
    cx.set_gemm_backend("cuda")
    try:
        counts, results = [], []
        for fn in (fmod._feast_compiled_steps, ft.feast_compiled, ft.feast_compiled):
            before = cmatmul_kernel.launches
            results.append(fn(A, X0, **kw))
            torch.cuda.synchronize()
            counts.append(cmatmul_kernel.launches - before)
        assert list(fmod._PROGRAMS) != [key] and len(fmod._PROGRAMS) == 1
    finally:
        cx.set_gemm_backend("torch")
        fmod.clear_graph_cache()
    assert counts[0] == counts[1] == counts[2] > 0
    for a, b in zip(results[0][:4], results[2][:4]):
        assert torch.equal(a, b)


def test_spans_on_the_graphs_route(dev):
    """The solvers' spans on the graphs route at n = 4096 (the headline
    problem: diag(1..n) + 0.05 complex noise, c = 20, r = 22, m0 = 48),
    traced by the profiler on a warm call: every span has its device
    seconds, the Rayleigh-Ritz and update spans are the call's replays, one
    each, and each span's host start is within 0.5 ms of its "span.<name>"
    range in the profiler's events."""
    import collections
    import importlib

    from torch.profiler import ProfilerActivity, profile

    from feast_tpu_torch.utils import tracing

    fmod = importlib.import_module("feast_tpu_torch.solvers.feast")
    n, m0 = 4096, 48
    rng = np.random.default_rng(0)
    A = np.diag(np.arange(1.0, n + 1.0)).astype(np.complex128)
    A += 0.05 * (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
    X0 = rng.standard_normal((n, m0)) + 1j * rng.standard_normal((n, m0))
    At, Xt = torch.as_tensor(A, device=dev), torch.as_tensor(X0, device=dev)
    kw = dict(c=20.0, r=22.0, nodes=16, iters=20, tol=1e-10, mixed_prec=True, device=dev)
    fmod.clear_graph_cache()
    tracing.clear()
    try:
        ft.feast_compiled(At, Xt, **kw)             # captures the graphs
        torch.cuda.synchronize()
        assert tracing.spans() == []
        prog = next(iter(fmod._PROGRAMS.values()))
        before = prog.replays
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            res = ft.feast_compiled(At, Xt, **kw)
            torch.cuda.synchronize()
        replays = prog.replays - before
        recs = tracing.spans()
    finally:
        tracing.clear()
        fmod.clear_graph_cache()
    assert prog.graphs and res.converged
    names = collections.Counter(r["name"] for r in recs)
    assert names["feast.solve"] == names["feast.factor"] == names["feast.loop"] == 1
    assert names["feast.rr"] + names["feast.update"] == replays > 0
    for r in recs:
        assert r["device_s"] is not None and r["device_s"] >= 0, r["name"]
    starts = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("span.") and e.device_type() == torch.autograd.DeviceType.CPU:
            starts[e.name()[len("span."):]].append(e.start_ns())
    for r in recs:
        assert min(abs(s - r["t0_ns"]) for s in starts[r["name"]]) < 5e5, r["name"]


def test_eigh_cannot_be_captured(dev):
    """Why pencil "hermitian" runs feast_compiled's steps eagerly: the card's
    torch.linalg.eigh reads its info on the host, which invalidates a
    capture.  A failed capture leaves the process's cuSOLVER unusable, so
    the capture runs in a child process."""
    import subprocess
    import sys
    import textwrap

    code = textwrap.dedent("""
        import numpy as np, torch
        G = np.random.default_rng(0).standard_normal((48, 48, 2)).view(np.complex128)[..., 0]
        M = torch.as_tensor(G + G.conj().T, device="cuda")
        torch.linalg.eigh(M)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph):
                torch.linalg.eigh(M)
        except RuntimeError as err:
            print("capture failed:", str(err).splitlines()[0])
        else:
            print("captured")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert "capture failed:" in out.stdout, out.stdout + out.stderr


def _same_result(a, b):
    return (a.n_iter == b.n_iter and a.converged == b.converged
            and all(torch.equal(x, y) for x, y in zip(a[:4], b[:4])))


def test_sliced_graphs_equal_the_sliced_steps(dev):
    """feast_sliced_parallel's stacked slices as CUDA graph replays equal the
    same batched steps run eagerly on the card, bit for bit per slice, and
    eigvalsh's eigenvalues; each batched sweep is one K2 launch for all
    slices."""
    import importlib

    fmod = importlib.import_module("feast_tpu_torch.solvers.feast")
    sl = importlib.import_module("feast_tpu_torch.parallel.slicing")
    rng = np.random.default_rng(0)
    n = 256
    G = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    H = np.diag(np.arange(1.0, n + 1.0)) + 0.05 * (G + G.conj().T) / 2
    kw = dict(nodes=16, iters=30, tol=1e-10, mixed_prec=True, device=dev)
    fmod.clear_graph_cache()
    graphs, k2 = [], []
    for _ in range(2):                 # cold (capture), then warm (replays only)
        before = schur_kernel.launches
        graphs.append(ft.parallel.feast_sliced_parallel(H, (0.5, 24.5), 4, **kw))
        torch.cuda.synchronize()
        k2.append(schur_kernel.launches - before)
    prog = next(iter(fmod._PROGRAMS.values()))
    assert isinstance(prog, sl._SlicedProgram) and prog.graphs and prog.replays > 0
    steps = sl._feast_sliced_parallel_steps(H, (0.5, 24.5), 4, **kw)
    fmod.clear_graph_cache()
    # one launch a batched sweep (the stochastic count and the complex128
    # fallback of a failed guard launch none)
    assert k2[0] == k2[1] == prog.sweeps == max(r.n_iter for r in graphs[1].per_slice)
    for g in graphs:
        assert all(_same_result(a, b) for a, b in zip(g.per_slice, steps.per_slice))
    w = np.linalg.eigvalsh(H)
    np.testing.assert_allclose(np.sort(graphs[1].lam.real), w[(w > 0.5) & (w < 24.5)],
                               atol=1e-10)


def test_feast_compiled_mesh_graphs_over_nccl(dev, tmp_path):
    """feast_compiled(mesh=node_mesh()) at world size 1 over NCCL: its
    sweeps are graph replays with the node all-reduce a graph of its own,
    bit for bit the eager steps under the same mesh, with as many K1 and K2
    launches."""
    import importlib

    import torch.distributed as dist

    fmod = importlib.import_module("feast_tpu_torch.solvers.feast")
    A, X0, _ = _graph_problem()
    kw = dict(c=5.5, r=5.2, nodes=16, iters=20, tol=1e-10, mixed_prec=True, device="cuda")
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    try:
        mesh = ft.parallel.node_mesh(device_type="cuda")
        fmod.clear_graph_cache()
        results, counts = [], []
        for fn in (fmod._feast_compiled_steps, ft.feast_compiled, ft.feast_compiled):
            k1, k2 = panel_lu.launches, schur_kernel.launches
            results.append(fn(A, X0, mesh=mesh, **kw))
            torch.cuda.synchronize()
            counts.append((panel_lu.launches - k1, schur_kernel.launches - k2))
        prog = next(iter(fmod._PROGRAMS.values()))
        assert prog.graphs and prog.replays > 0
        fmod.clear_graph_cache()
    finally:
        dist.destroy_process_group()
    p, g, warm = results
    assert counts[0] == counts[1] == counts[2] and counts[0][1] > 0
    assert p.converged and _same_result(g, p) and _same_result(warm, p)


def test_feast_compiled_node_sum_graphs_over_nccl_ranks(dev, tmp_path):
    """feast_compiled(mesh=) on one card a rank over NCCL (2 or 4 ranks):
    the update and the node sum are graphs of their own, captured by the
    first solve and replayed by the next, each sum in a `feast.node_sum`
    span after its update; the graphs and their replays give the eager
    steps' spans and bits on every rank."""
    from _torch_ranks import Ranks

    world = 4 if torch.cuda.device_count() >= 4 else 2
    if torch.cuda.device_count() < world:
        pytest.skip("needs 2 or more CUDA devices")
    A, X0, _ = _graph_problem()
    ranks = Ranks(world, str(tmp_path), backend="nccl")
    try:
        outs = ranks.run("node_sum_spans", A=A, X0=X0, device_type="cuda", c=5.5,
                         r=5.2, nodes=16, iters=20, tol=1e-10, mixed_prec=True)
    finally:
        ranks.close()
    for o in outs:
        assert o["replay_count"] > 0 and o["steps"]["converged"]
        for route in ("steps", "graphs", "replays"):
            assert o[route]["spans"] == o["steps"]["spans"]
            for k in ("lam", "X", "res", "inside", "n_iter", "converged"):
                np.testing.assert_array_equal(o[route][k], o["steps"][k])
                np.testing.assert_array_equal(o[route][k], outs[0][route][k])
        spans = o["replays"]["spans"]
        sums = [a for name, a in spans if name == "feast.node_sum"]
        assert len(sums) == sum(name == "feast.update" for name, _ in spans) > 0
        size = {"c64": 8, "c128": 16}
        assert all(a["ranks"] == world and a["bytes"] == 256 * 16 * size[a["tier"]]
                   for a in sums)
        assert [a["nodes"] for name, a in spans if name == "feast.factor"] == [16 // world]
