"""Complex64 matrix products on the card: the Hopper kernel `csrc/cmatmul.cu`
in its two call forms, the product behind `cx.cmatmul`'s "cuda" backend and
the update in place that carries the LU factor's trailing update.

Counterpart of `feast_tpu/ops/pallas_kernels.py` (`_cmatmul_pallas_padded`,
launched by `cmatmul_pallas`): C = A B at fp32 accuracy, three real products
per complex one (Karatsuba), each on the TF32 tensor cores with its operands
split into two TF32 halves (3xTF32, `wgmma` m64n128k8).  The TPU kernel pads
to tiles and takes 2-D operands only; this one bounds-checks ragged edges
itself, reads any 8-byte-aligned base and row stride, and takes leading batch
dimensions that broadcast (the contour-node axis of the dense solvers).

`addmm_(c, a, b, alpha)` is C <- C + alpha A B on a row- and batch-strided
view C, such as the factor's `A3[:, e:, e:]`: the same kernel with beta = 1,
reading C once and writing it once, with no temporary.  The plain versions,
taken for CPU tensors, are `cx._cmatmul_planes` (the same three real
products as fp32 matmuls on the planes) and `addmm_plain` (those products
added into C stage by stage, as the kernel adds them).
"""

from __future__ import annotations

import ctypes

import torch

from .. import cx
from ..kernels import _build

# Launches of the CUDA kernel in its two forms: `launches` the products
# (`cmatmul`), `acc_launches` the updates in place (`addmm_`).  Plain-version
# calls do not count; a graph's replays count the launches it holds
# (`_build.count_launch`).
launches = 0
acc_launches = 0
# the tensor-core instruction of csrc/cmatmul.cu, and the K of its stages
MMA = "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32"
STAGE_K = 16

_ARGTYPES = ((ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 4
             + (ctypes.c_longlong,) * 6 + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p))


def _rows(t: torch.Tensor, batch) -> torch.Tensor:
    """(B, r, c) view of `t` broadcast over `batch`, unit column stride."""
    if t.stride(-1) != 1:
        t = t.contiguous()
    t = t.expand(batch + t.shape[-2:])
    return t.reshape((-1,) + t.shape[-2:]) if len(batch) != 1 else t


def _check(a: torch.Tensor, b: torch.Tensor, what: str):
    if a.dim() < 2 or b.dim() < 2 or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"{what}: shapes {tuple(a.shape)} and {tuple(b.shape)}")


def _launch(c3, a3, b3, alpha: float, beta: int):
    """The kernel on (B, M, N) c3 and broadcast (B, M, K) a3, (B, K, N) b3."""
    Bsz, M, N = c3.shape
    fn = _build.function("cmatmul", "feast_cmatmul_c64", _ARGTYPES)
    err = fn(a3.data_ptr(), b3.data_ptr(), c3.data_ptr(), M, N, a3.shape[-1], Bsz,
             a3.stride(1), b3.stride(1), c3.stride(1), a3.stride(0), b3.stride(0),
             c3.stride(0), alpha, beta,
             torch.cuda.current_stream(c3.device).cuda_stream)
    _build.check(err, "cmatmul kernel")


def _check_kernel(*ts):
    dev = ts[0].device
    if any(t.dtype != torch.complex64 or t.device != dev for t in ts):
        raise ValueError("cmatmul kernel takes complex64 tensors on one CUDA device (got "
                         + ", ".join(f"{t.dtype} on {t.device}" for t in ts) + ")")


def cmatmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for complex64 (..., M, K) and (..., K, N) with broadcasting
    batch dims.  CUDA tensors run the kernel; CPU tensors the plain version."""
    _check(a, b, "cmatmul")
    if not a.is_cuda:
        return cx._cmatmul_planes(a, b)
    _check_kernel(a, b)
    M, K = a.shape[-2:]
    N = b.shape[-1]
    batch = tuple(torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]))
    a3, b3 = _rows(a, batch or (1,)), _rows(b, batch or (1,))
    c = torch.empty((a3.shape[0], M, N), dtype=torch.complex64, device=a.device)
    if c.numel():
        _launch(c, a3, b3, 1.0, 0)
        _build.count_launch(__name__)
    return c.reshape(batch + (M, N))


def addmm_plain(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                alpha: float = 1.0) -> torch.Tensor:
    """Plain version of `addmm_`, in the kernel's order: per stage of
    `STAGE_K` of K the three real products of `cx._cmatmul_planes` in the
    planes' precision, t1 added into Cr and subtracted from Ci, t2
    subtracted from both, t3 added into Ci; then c += alpha (Cr + i Ci) in
    place.  (Karatsuba over the whole K at once rounds the cancellation
    t3 - t1 - t2 on the full sums: about 1.7x the error of a complex
    product's, where the stages keep it below.)"""
    acc = None
    for k in range(0, a.shape[-1], STAGE_K):
        ak, bk = a[..., k:k + STAGE_K], b[..., k:k + STAGE_K, :]
        ar, ai, br, bi = ak.real, ak.imag, bk.real, bk.imag
        t = ar @ br
        if acc is None:
            acc = [t, -t]
        else:
            acc[0] += t
            acc[1] -= t
        t = ai @ bi
        acc[0] -= t
        acc[1] -= t
        acc[1] += (ar + ai) @ (br + bi)
    if acc is not None:
        c.add_(torch.complex(*acc), alpha=alpha)
    return c


def addmm_(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
           alpha: float = 1.0) -> torch.Tensor:
    """c += alpha * a @ b in place and return c: complex64 c (..., M, N), a
    (..., M, K) and b (..., K, N) whose batch dims broadcast to c's, alpha
    real.  c may be a strided view (unit column stride, its batch dims one
    stride apart, e.g. `A3[:, e:, e:]`) and must not overlap a or b.  CUDA
    tensors run the kernel, allocating nothing; CPU tensors the plain
    version."""
    _check(a, b, "addmm_")
    M, N = a.shape[-2], b.shape[-1]
    batch = tuple(torch.broadcast_shapes(a.shape[:-2], b.shape[:-2], c.shape[:-2]))
    if tuple(c.shape) != batch + (M, N):
        raise ValueError(f"addmm_: c of shape {tuple(c.shape)} for a product of "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if not c.is_cuda:
        return addmm_plain(c, a, b, alpha)
    _check_kernel(c, a, b)
    if c.stride(-1) != 1:
        raise ValueError(f"addmm_: c needs a unit column stride (strides {c.stride()})")
    c3 = c if c.dim() == 3 else c.view((-1, M, N))
    a3, b3 = _rows(a, batch or (1,)), _rows(b, batch or (1,))
    if c.numel():
        _launch(c3, a3, b3, float(alpha), 1)
        _build.count_launch(__name__, "acc_launches")
    return c
