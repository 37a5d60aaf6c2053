"""Complex64 matrix product on the card: the Hopper kernel
`csrc/cmatmul.cu` behind `cx.cmatmul`'s "cuda" backend.

Counterpart of `feast_tpu/ops/pallas_kernels.py` (`_cmatmul_pallas_padded`,
launched by `cmatmul_pallas`): C = A B at fp32 accuracy, three real products
per complex one (Karatsuba), each on the TF32 tensor cores with its operands
split into two TF32 halves (3xTF32, `wgmma` m64n64k8).  The TPU kernel pads
to tiles and takes 2-D operands only; this one bounds-checks ragged edges
itself, reads any 8-byte-aligned base and row stride, and takes leading batch
dimensions that broadcast (the contour-node axis of the dense solvers).  Its
plain version is `cx._cmatmul_planes`: the same three real products as fp32
matmuls on the planes.
"""

from __future__ import annotations

import ctypes

import torch

from .. import cx
from ..kernels import _build

# Launches of the CUDA kernel (plain-version calls do not count; a graph's
# replays count the launches it holds, `_build.count_launch`).
launches = 0
# the tensor-core instruction of csrc/cmatmul.cu
MMA = "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32"

_ARGTYPES = ((ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 4
             + (ctypes.c_longlong,) * 6 + (ctypes.c_void_p,))


def _rows(t: torch.Tensor, batch) -> torch.Tensor:
    """(B, r, c) view of `t` broadcast over `batch`, unit column stride."""
    if t.stride(-1) != 1:
        t = t.contiguous()
    t = t.expand(batch + t.shape[-2:])
    return t.reshape((-1,) + t.shape[-2:]) if len(batch) != 1 else t


def cmatmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b for complex64 (..., M, K) and (..., K, N) with broadcasting
    batch dims.  CUDA tensors run the kernel; CPU tensors the plain version."""
    if a.dim() < 2 or b.dim() < 2 or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"cmatmul: shapes {tuple(a.shape)} and {tuple(b.shape)}")
    if not a.is_cuda:
        return cx._cmatmul_planes(a, b)
    if a.dtype != torch.complex64 or b.dtype != torch.complex64 or b.device != a.device:
        raise ValueError("cmatmul kernel takes complex64 tensors on one CUDA "
                         f"device (got {a.dtype} on {a.device}, {b.dtype} on {b.device})")
    M, K = a.shape[-2:]
    N = b.shape[-1]
    batch = tuple(torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]))
    a3, b3 = _rows(a, batch or (1,)), _rows(b, batch or (1,))
    Bsz = a3.shape[0]
    c = torch.empty((Bsz, M, N), dtype=torch.complex64, device=a.device)
    if M and N and Bsz:
        fn = _build.function("cmatmul", "feast_cmatmul_c64", _ARGTYPES)
        err = fn(a3.data_ptr(), b3.data_ptr(), c.data_ptr(), M, N, K, Bsz,
                 a3.stride(1), b3.stride(1), N, a3.stride(0), b3.stride(0),
                 M * N, torch.cuda.current_stream(a.device).cuda_stream)
        _build.check(err, "cmatmul kernel")
        _build.count_launch(__name__)
    return c.reshape(batch + (M, N))
