"""Whole complex Schur decomposition in one launch: the Hopper kernel
`csrc/schur.cu` and its plain PyTorch version.

Counterpart of `feast_tpu/ops/pallas_eig.py` (`_schur_kernel`, launched by
`schur_pallas`): Hessenberg reduction, single-shift QR with Wilkinson and
exceptional shifts and deflation, and with want_y the eigenvectors Y of T
and X = Y^{-1}.  complex64, 2 <= n <= 128.  The f32 Schur seed of
`eig._schur_vecs32` comes from here on the card.

The kernel runs one warp per matrix, its sweeps' forward and backward
passes fused at a lag of two (`csrc/schur.cu`), so its rotations agree with
`schur_plain`'s to rounding, not bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import _build

# Launches of the CUDA kernel (plain-version calls do not count; a graph's
# replays count the launches it holds, `_build.count_launch`).
launches = 0

_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)
MAX_N = 128


def schur(A: torch.Tensor, want_y: bool = False, max_sweeps_per_eig: int = 30,
          return_stats: bool = False):
    """Schur form of (..., n, n) complex64 A: returns (T, Z) or, with
    want_y, (T, Z, Y, X).  return_stats appends an int32 (..., 2) tensor
    of (sweeps, sum of active-window sizes) per matrix.

    A CUDA tensor runs the kernel; a CPU tensor runs the plain version."""
    n = A.shape[-1]
    if A.shape[-2] != n or not 2 <= n <= MAX_N:
        raise ValueError(f"schur kernel takes (..., n, n) with 2 <= n <= {MAX_N}, "
                         f"got {tuple(A.shape)}")
    if not A.is_cuda:
        return schur_plain(A, want_y, max_sweeps_per_eig, return_stats)
    if A.dtype != torch.complex64:
        raise ValueError(f"schur kernel takes complex64, got {A.dtype}")
    batch = A.shape[:-2]
    A3 = A.reshape(-1, n, n).contiguous()
    Bsz = A3.shape[0]
    outs = [torch.empty_like(A3) for _ in range(4 if want_y else 2)]
    stats = torch.empty((Bsz, 2), dtype=torch.int32, device=A.device)
    ptrs = [o.data_ptr() for o in outs] + [0] * (4 - len(outs))
    fn = _build.function("schur", "feast_schur_c64", _ARGTYPES)
    err = fn(A3.data_ptr(), *ptrs, stats.data_ptr(), n, Bsz,
             max_sweeps_per_eig, int(want_y),
             torch.cuda.current_stream(A.device).cuda_stream)
    _build.check(err, "schur kernel")
    _build.count_launch(__name__)
    out = tuple(o.reshape(batch + (n, n)) for o in outs)
    return out + (stats.reshape(batch + (2,)),) if return_stats else out


def schur_plain(A: torch.Tensor, want_y: bool = False,
                max_sweeps_per_eig: int = 30, return_stats: bool = False):
    """Plain PyTorch version of `schur`: ops.eig's Hessenberg + shifted QR,
    then `tri_eigvecs` and `tri_unit_inv`, one matrix at a time."""
    from . import eig

    n = A.shape[-1]
    batch = A.shape[:-2]
    outs, stats = [], []
    for M in A.reshape(-1, n, n):
        T, Z, st = eig._schur_plain(M, max_sweeps_per_eig)
        res = [T, Z]
        if want_y:
            Y = eig.tri_eigvecs(T)
            res += [Y, eig.tri_unit_inv(Y)]
        outs.append(res)
        stats.append(st)
    out = tuple(torch.stack(parts).reshape(batch + (n, n))
                for parts in zip(*outs))
    if return_stats:
        st = torch.tensor(stats, dtype=torch.int32, device=A.device)
        out = out + (st.reshape(batch + (2,)),)
    return out
