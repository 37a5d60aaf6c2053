"""Row swaps of the blocked LU: a panel's row permutation applied to the
columns outside the panel, by the Hopper kernel `csrc/row_swap.cu` on the
rows it moves, or by its plain version (one gather of every row >= j).

`panel_lu.lu_factor_panel` calls `apply_panel_perm` once a panel, over the
whole batch, with the permutation the panel kernel (K1) returned.  The
kernel replaces no TPU kernel: the JAX package applies the swaps as a
gather that XLA fuses (feast_tpu/ops/pallas_lu.py::lu_factor_pallas); on
the card a gather rewrites every row >= j, while the panel's b swaps move
at most 2b rows.  A swap only moves data, so the two versions are bit for
bit equal.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels import _build

# Launches of the CUDA kernel (plain-version calls do not count).
launches = 0

_ARGTYPES = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)


def _check(A3: torch.Tensor, perm: torch.Tensor, j: int, b: int):
    if A3.dim() != 3 or A3.shape[-1] != A3.shape[-2] or A3.stride(-1) != 1:
        raise ValueError(f"row swaps take (batch, n, n) with unit column stride, "
                         f"got {tuple(A3.shape)} strides {A3.stride()}")
    n = A3.shape[-1]
    if perm.shape != A3.shape[:2] or not 1 <= b <= 128 or j < 0 or j + b > n:
        raise ValueError(f"row swaps: perm {tuple(perm.shape)} for {tuple(A3.shape)}, "
                         f"need 1 <= b <= 128 and j + b <= n (j={j}, b={b})")


def apply_panel_perm(A3: torch.Tensor, perm: torch.Tensor, j: int, b: int,
                     moved: torch.Tensor = None):
    """In place: rows r >= j of A3's columns [0, j) and [j + b, n) take the
    old contents of row perm[r] (perm (batch, n) int32, the panel kernel's
    permutation of the panel at rows j..j+b-1, identity above j).

    moved: an int64 0-d tensor on A3's device, or None; the rows that moved
    (perm[r] != r) are added to it on the device, with no synchronisation.
    A CUDA tensor runs the kernel (complex64 only); a CPU tensor the plain
    version."""
    _check(A3, perm, j, b)
    if not A3.is_cuda:
        return apply_panel_perm_plain(A3, perm, j, b, moved)
    if A3.dtype != torch.complex64 or perm.dtype != torch.int32 or not perm.is_contiguous():
        raise ValueError("row swap kernel takes complex64 matrices and a contiguous "
                         f"int32 perm (got {A3.dtype}, {perm.dtype})")
    if moved is not None and (moved.dtype != torch.int64 or moved.device != A3.device):
        raise ValueError("moved must be an int64 tensor on the matrices' device")
    n = A3.shape[-1]
    fn = _build.function("row_swap", "feast_row_swap_c64", _ARGTYPES)
    err = fn(A3.data_ptr(), A3.stride(0), A3.stride(1), n, j, b, A3.shape[0],
             perm.data_ptr(), None if moved is None else moved.data_ptr(),
             torch.cuda.current_stream(A3.device).cuda_stream)
    _build.check(err, "row_swap kernel")
    _build.count_launch(__name__)
    return A3


def apply_panel_perm_plain(A3: torch.Tensor, perm: torch.Tensor, j: int, b: int,
                           moved: torch.Tensor = None):
    """Plain PyTorch version of `apply_panel_perm` (same in-place contract):
    one gather of rows >= j for each side of the panel."""
    _check(A3, perm, j, b)
    n, e = A3.shape[-1], j + b
    idx = (perm[:, j:].long() - j)[:, :, None]
    if j > 0:
        A3[:, j:, :j] = torch.gather(A3[:, j:, :j], 1, idx.expand(-1, -1, j))
    if e < n:
        A3[:, j:, e:] = torch.gather(A3[:, j:, e:], 1, idx.expand(-1, -1, n - e))
    if moved is not None:
        rows = torch.arange(j, n, device=perm.device, dtype=perm.dtype)
        moved += (perm[:, j:] != rows).sum()
    return A3
