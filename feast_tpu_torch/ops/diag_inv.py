"""The diagonal-block inverses of an LU factor on the card: the Hopper
kernel `csrc/diag_inv.cu` inverts every 64 x 64 diagonal tile, and
log2(block / 64) levels of batched products join the tiles into the
block inverses.

`lu.lu_diag_inv` takes this route for complex64 factors on the card under
the "pallas" panel backend (`lu._kernel_route`, K1's route) when the block
is 64 * 2^k (`kernel_block`); everything else keeps the row-by-row
substitution of `lu.lu_diag_inv_plain`, which is also this route's test
oracle.  The kernel replaces no TPU kernel: the JAX package runs that
substitution as a compiled fori_loop (feast_tpu/ops/lu.py::lu_diag_inv),
which issued eagerly on the card was tens of thousands of launches a
factor.

The doubling (`doubling`) is the blocked triangular inverse of LAPACK's
xTRTRI: with the two diagonal s-blocks A and D of a 2s-block already
inverted,

    [[A, 0], [C, D]]^-1 = [[A^-1, 0], [-D^-1 C A^-1, D^-1]]   (L, unit lower)
    [[A, B], [0, D]]^-1 = [[A^-1, -A^-1 B D^-1], [0, D^-1]]   (U, upper)

so each level is two products a triangle, batched over every matrix,
diagonal block and tile pair at once (`_pairs`).  The tile step leaves -C
and -B in the places their products go (`tiles`, `tiles_plain`): a level
reads the triangle's entries from the outputs themselves, never the
factor, so the identity extension past n is the tile step's alone.  The
tile inverter follows the device: on the CPU `tiles` is `tiles_plain`, and
the same doubling runs over it.
"""

from __future__ import annotations

import ctypes

import torch

from .. import cx
from ..kernels import _build
from .lu import _pad_identity, _unit_lower_solve_small, _upper_solve_small

# Launches of the CUDA kernel (plain-version calls do not count).
launches = 0

TILE = 64

_ARGTYPES = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p)


def kernel_block(block: int) -> bool:
    """Whether the tiles and the doubling take diagonal blocks of this
    width: 64 * 2^k."""
    k = block // TILE
    return block % TILE == 0 and k >= 1 and k & (k - 1) == 0


def _check(LU: torch.Tensor, block: int):
    if LU.dim() < 2 or LU.shape[-1] != LU.shape[-2] or LU.shape[-1] < 1:
        raise ValueError(f"diagonal-block inverses take (..., n, n) factors, "
                         f"got {tuple(LU.shape)}")
    if not kernel_block(block):
        raise ValueError(f"the tiled inverse takes blocks of 64 * 2^k, got {block}")


def tiles(LU: torch.Tensor, block: int):
    """(Lw, Uw), each (..., nblocks, block, block) in LU's dtype: per
    diagonal block of LU (identity-extended past n), the inverses of its
    64 x 64 diagonal tiles of L (unit lower) and U, the negated entries of
    the triangle in its other tiles, zeros elsewhere.  A zero diagonal
    entry of U is replaced by eps * max(sqrt(max |U|^2 over the block's
    upper triangle), sqrt(tiny)).  A CUDA tensor runs the kernel (complex64
    only, unit column stride); a CPU tensor the plain version."""
    _check(LU, block)
    if not LU.is_cuda:
        return tiles_plain(LU, block)
    if LU.dtype != torch.complex64 or LU.stride(-1) != 1:
        raise ValueError("the diagonal-block kernel takes complex64 factors with unit "
                         f"column stride (got {LU.dtype}, strides {LU.stride()})")
    n = LU.shape[-1]
    LU3 = LU.reshape(-1, n, n)          # a view for a factor_buffer's crop
    nb = -(-n // block)
    shape = LU.shape[:-2] + (nb, block, block)
    Lw = torch.empty(shape, dtype=LU.dtype, device=LU.device)
    Uw = torch.empty(shape, dtype=LU.dtype, device=LU.device)
    fn = _build.function("diag_inv", "feast_diag_inv_c64", _ARGTYPES)
    err = fn(LU3.data_ptr(), LU3.stride(0), LU3.stride(1), n, block, LU3.shape[0],
             Lw.data_ptr(), Uw.data_ptr(), torch.cuda.current_stream(LU.device).cuda_stream)
    _build.check(err, "diag_inv kernel")
    _build.count_launch(__name__)
    return Lw, Uw


def tiles_plain(LU: torch.Tensor, block: int):
    """Plain PyTorch version of `tiles` (same output): the blocks copied and
    identity-extended as `lu.lu_diag_inv_plain` copies them, each diagonal
    tile inverted by its row-by-row substitution."""
    n = LU.shape[-1]
    D = torch.stack([_pad_identity(LU[..., j:j + block, j:j + block], block)
                     for j in range(0, n, block)], dim=-3)
    eye = torch.eye(block, dtype=LU.dtype, device=LU.device)
    Ld = torch.tril(D, -1) + eye
    Ud = torch.triu(D)
    fi = torch.finfo(cx.real_dtype(LU.dtype))
    uscale = torch.sqrt(torch.amax(cx.abs2(Ud), dim=(-2, -1)))
    tiny = (fi.eps * torch.clamp(uscale, min=fi.tiny ** 0.5)).to(LU.dtype)
    Lw, Uw = -Ld, -Ud
    eyes = eye[:TILE, :TILE].expand(D.shape[:-2] + (TILE, TILE))
    for t in range(0, block, TILE):
        s = slice(t, t + TILE)
        Lw[..., s, s] = _unit_lower_solve_small(Ld[..., s, s], eyes)
        Uw[..., s, s] = _upper_solve_small(Ud[..., s, s], eyes, tiny=tiny)
    return Lw, Uw


def _pairs(X: torch.Tensor, s: int):
    """Views (matrices, pairs, s, s) of the four s-blocks A, B (above the
    diagonal), C (below it) and D of every 2s-pair of diagonal tiles of X,
    (matrices, block, block) and contiguous."""
    M, b = X.shape[0], X.shape[-1]
    size, stride = (M, b // (2 * s), s, s), (X.stride(0), 2 * s * (b + 1), b, 1)
    return tuple(X.as_strided(size, stride, X.storage_offset() + i * b + j)
                 for i, j in ((0, 0), (0, s), (s, 0), (s, s)))


def doubling(Lw: torch.Tensor, Uw: torch.Tensor):
    """In place: turn `tiles`' output into the block inverses (invL, invU),
    one level a doubling of the inverted diagonal width, from the 64-tiles
    up to the block.  Every product goes through `cx.cmatmul` on strided
    views of the outputs, batched over the matrices, blocks and tile
    pairs: two products a triangle a level.  No synchronisation, no host
    read."""
    block = Lw.shape[-1]
    L3, U3 = Lw.view(-1, block, block), Uw.view(-1, block, block)
    s = TILE
    while s < block:
        La, _, Lc, Ld = _pairs(L3, s)
        Ua, Ub, _, Ud = _pairs(U3, s)
        # A^-1 first in both: in complex64 the solves it serves come out
        # as accurate as with the substitution's inverses, where the
        # other order of the U product loses a factor of 4 or more
        Lc.copy_(cx.cmatmul(Ld, cx.cmatmul(Lc, La)))
        Ub.copy_(cx.cmatmul(cx.cmatmul(Ua, Ub), Ud))
        s *= 2
    return Lw, Uw
