"""DIA sparse matrix times a block of vectors: the Hopper kernel
`csrc/dia_spmm.cu` and its plain PyTorch version.

Counterpart of `feast_tpu/ops/pallas_kernels.py` (`_dia_matvec_pallas_padded`,
launched by `dia_matvec_pallas`):

    Y[..., i, :] = sum_k data[..., k, i] * X[..., i + offsets[k], :]

with out-of-range rows of X contributing zero.  `data` is row-indexed
(ndiag, n) like `sparse.DIA`, `X` is (ncols, m); either may carry leading
batch dimensions (the contour-node axis: the shifted level operators of the
AMG V-cycle differ per node) that broadcast against the other's.  The TPU
kernel's gate (f32, at least two diagonals, span <= half a row block) was a
limit of its fast memory; the kernel here takes any complex64 operands.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import _build

# Launches of the CUDA kernel (plain-version calls do not count).
launches = 0

_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 5
             + (ctypes.c_longlong,) * 2 + (ctypes.c_void_p,))

_offsets_on_device: dict = {}


def _device_offsets(offsets, device) -> torch.Tensor:
    key = (tuple(offsets), str(device))
    if key not in _offsets_on_device:
        _offsets_on_device[key] = torch.tensor(key[0], dtype=torch.int32,
                                               device=device)
    return _offsets_on_device[key]


def _check(data, offsets, X):
    if data.dim() < 2 or X.dim() < 2 or data.shape[-2] != len(offsets):
        raise ValueError(f"dia_matvec: data {tuple(data.shape)} against "
                         f"{len(offsets)} offsets, X {tuple(X.shape)}")


def _batched(t: torch.Tensor, batch) -> torch.Tensor:
    """(B or 1, r, c) contiguous-per-entry view of `t` for `batch`; an
    operand without batch dims of its own is shared (leading size 1)."""
    core = t.shape[-2:]
    if t.dim() == 2 or all(s == 1 for s in t.shape[:-2]):
        return t.reshape((1,) + core).contiguous()
    return t.expand(batch + core).reshape((-1,) + core).contiguous()


def dia_matvec(data: torch.Tensor, offsets, X: torch.Tensor) -> torch.Tensor:
    """The product above.  CUDA tensors run the kernel (complex64 only; its
    design and why it has no shared-memory windows are in
    `csrc/dia_spmm.cu`); CPU tensors run the plain version."""
    global launches
    _check(data, offsets, X)
    if not data.is_cuda:
        return dia_matvec_plain(data, offsets, X)
    if data.dtype != torch.complex64 or X.dtype != torch.complex64 or X.device != data.device:
        raise ValueError("dia_matvec kernel takes complex64 tensors on one CUDA "
                         f"device (got {data.dtype} on {data.device}, {X.dtype} on {X.device})")
    ndiag, n = data.shape[-2:]
    ncols, m = X.shape[-2:]
    batch = tuple(torch.broadcast_shapes(data.shape[:-2], X.shape[:-2]))
    d3, x3 = _batched(data, batch), _batched(X, batch)
    Bsz = max(d3.shape[0], x3.shape[0])
    Y = torch.empty((Bsz, n, m), dtype=torch.complex64, device=data.device)
    if n and m and Bsz:
        fn = _build.function("dia_spmm", "feast_dia_spmm_c64", _ARGTYPES)
        err = fn(d3.data_ptr(), _device_offsets(offsets, data.device).data_ptr(),
                 x3.data_ptr(), Y.data_ptr(), ndiag, n, ncols, m, Bsz,
                 ndiag * n if d3.shape[0] > 1 else 0,
                 ncols * m if x3.shape[0] > 1 else 0,
                 torch.cuda.current_stream(data.device).cuda_stream)
        _build.check(err, "dia_spmm kernel")
        launches += 1
    return Y.reshape(batch + (n, m))


def dia_matvec_plain(data: torch.Tensor, offsets, X: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `dia_matvec`, any dtype and device: one
    shifted slice of X per diagonal, accumulated in the order of `offsets`."""
    _check(data, offsets, X)
    n = data.shape[-1]
    ncols, m = X.shape[-2:]
    batch = tuple(torch.broadcast_shapes(data.shape[:-2], X.shape[:-2]))
    Y = torch.zeros(batch + (n, m), dtype=torch.result_type(data, X),
                    device=X.device)
    for k, off in enumerate(offsets):
        lo, hi = max(0, -off), min(n, ncols - off)
        if hi > lo:
            Y[..., lo:hi, :].addcmul_(data[..., k, lo:hi, None],
                                      X[..., lo + off:hi + off, :])
    return Y
