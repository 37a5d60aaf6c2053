"""Panel LU for the mixed-precision factor: the Hopper kernel
`csrc/panel_lu.cu`, its plain PyTorch version, and the blocked host loop.

Counterpart of `feast_tpu/ops/pallas_lu.py` (`_panel_kernel`, launched by
`panel_slab_pallas`, driven by `lu_factor_pallas`).  One call factors a
batch of (n, b) complex64 column slabs in place with pivot rows
j0..j0+b-1: per column, argmax-|.|^2 partial pivoting over rows >= j0+k
(lowest index wins ties), the row swap and the composed permutation, an
exact zero pivot replaced by eps * max|slab| (max over the whole slab,
taken before the first column) and inverted by Smith's reciprocal, the
multipliers and the rank-1 update of the columns to the right; then the
inverse of the unit-lower diagonal block L11.

The kernel runs one thread-block cluster per slab; `launch_plan` mirrors
its launch plan on the host (cluster size, sub-panel width, shared memory)
and `card_plan` asks the built kernel for the plan it takes on this card.

`lu_factor_panel` mirrors `lu_factor_pallas`: per panel one kernel call,
the panel's row permutation applied to the other columns on the rows it
moves (`row_swap`, the kernel `csrc/row_swap.cu`), U12 = invL11 @ A12,
and the trailing update A22 <- A22 - L21 U12 accumulated in place by the
tensor-core kernel `csrc/cmatmul.cu` (`cmatmul_kernel.addmm_`).
"""

from __future__ import annotations

import ctypes

import torch

from .. import cx
from ..kernels import _build
from . import cmatmul_kernel, row_swap
from .lu import _swap_rows

# Launches of the CUDA kernel (plain-version calls do not count; a graph's
# replays count the launches it holds, `_build.count_launch`).
launches = 0

_ARGTYPES = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)
_PLAN_ARGTYPES = (ctypes.c_int,) * 4 + (ctypes.c_void_p,)
MAX_BLOCK = 128
# the kernel's launch constants (csrc/panel_lu.cu)
SMEM_CAP = 232448         # 227 KB: the most shared memory a block may use
STATIC_RESERVE = 8192     # upper bound of the kernel's static shared memory
CLUSTER_SIZES = (8, 7, 6, 5, 4, 3, 2, 1)


def _plan_smem(n, b, j0, C, w, in_smem):
    rows_per = -(-(n - j0) // C)
    p1 = (rows_per * (w + 1) if in_smem else 0) + w * b + w * w
    p2 = b * -(-b // C) + b * (b - 1) // 2
    return 8 * max(p1, p2)


def _plan_for(n, b, j0, C):
    rows_per = -(-(n - j0) // C)
    for w in (32, 16, 8, 4):
        w = min(w, b)
        smem = _plan_smem(n, b, j0, C, w, True)
        if smem <= SMEM_CAP - STATIC_RESERVE:
            return {"C": C, "w": w, "rows_per": rows_per, "in_smem": True, "smem": smem}
    w = min(32, b)
    return {"C": C, "w": w, "rows_per": rows_per, "in_smem": False,
            "smem": _plan_smem(n, b, j0, C, w, False)}


def launch_plan(n: int, b: int, j0: int, batch: int, clusters_fit) -> dict:
    """The kernel's launch plan, as `csrc/panel_lu.cu::choose_plan` makes it:
    the largest cluster size C <= 8 whose clusters hold the whole batch in
    one wave (`clusters_fit(C, smem)`: how many clusters of C blocks with
    `smem` dynamic shared bytes fit on the card at once), else C = 1.
    Block r of a cluster owns rows [j0 + r R, j0 + (r+1) R) with
    R = rows_per; sub-panels of w columns sit in shared memory where they
    fit (in_smem), else in the slab."""
    for C in CLUSTER_SIZES[:-1]:
        plan = _plan_for(n, b, j0, C)
        if clusters_fit(C, plan["smem"]) >= batch:
            return plan
    return _plan_for(n, b, j0, 1)


def card_plan(n: int, b: int, j0: int, batch: int) -> dict:
    """The plan the kernel takes on the current card, with the clusters of
    C = 1, ..., 8 that fit at once (`fits`)."""
    out = (ctypes.c_int * 13)()
    fn = _build.function("panel_lu", "feast_panel_lu_plan", _PLAN_ARGTYPES)
    _build.check(fn(n, b, j0, batch, ctypes.addressof(out)), "panel_lu plan")
    return {"C": out[0], "w": out[1], "rows_per": out[2], "in_smem": bool(out[3]),
            "smem": out[4], "fits": dict(zip(range(1, 9), out[5:13]))}


def _check_slab(slab: torch.Tensor, j0: int):
    if slab.dim() != 3:
        raise ValueError(f"panel slab must be (batch, n, b), got {tuple(slab.shape)}")
    _, n, b = slab.shape
    if not 1 <= b <= MAX_BLOCK or j0 < 0 or j0 + b > n:
        raise ValueError(f"panel: need 1 <= b <= {MAX_BLOCK} and j0 + b <= n "
                         f"(n={n}, b={b}, j0={j0})")


def panel_factor(slab: torch.Tensor, j0: int):
    """Factor the (batch, n, b) slab in place; returns (slab, perm (batch, n)
    int32, invL11 (batch, b, b)).

    `slab` may be a column slice of a larger matrix (unit stride in the
    last dim).  A CUDA tensor runs the kernel; a CPU tensor runs the plain
    version."""
    _check_slab(slab, j0)
    if not slab.is_cuda:
        return panel_factor_plain(slab, j0)
    if slab.dtype != torch.complex64 or slab.stride(-1) != 1:
        raise ValueError("panel kernel takes complex64 slabs with unit "
                         f"column stride (got {slab.dtype}, strides {slab.stride()})")
    Bsz, n, b = slab.shape
    perm = torch.empty((Bsz, n), dtype=torch.int32, device=slab.device)
    invL = torch.empty((Bsz, b, b), dtype=torch.complex64, device=slab.device)
    fn = _build.function("panel_lu", "feast_panel_lu_c64", _ARGTYPES)
    err = fn(slab.data_ptr(), slab.stride(0), slab.stride(1), n, b, j0, Bsz,
             perm.data_ptr(), invL.data_ptr(),
             torch.cuda.current_stream(slab.device).cuda_stream)
    _build.check(err, "panel_lu kernel")
    _build.count_launch(__name__)
    return slab, perm, invL


def panel_factor_plain(slab: torch.Tensor, j0: int):
    """Plain PyTorch version of `panel_factor` (same in-place contract).

    Works on the real and imaginary planes with one rounded operation per
    step, in the kernel's order, so that on the card the two round alike
    and choose the same pivots."""
    _check_slab(slab, j0)
    Bsz, n, b = slab.shape
    rdt = cx.real_dtype(slab.dtype)
    re = slab.real.clone()
    im = slab.imag.clone()
    eps = torch.finfo(rdt).eps
    tiny = eps * torch.clamp(torch.sqrt(torch.amax(re * re + im * im,
                                                   dim=(1, 2))), min=1e-30)
    rows = torch.arange(n, device=slab.device)
    perm = torch.arange(n, device=slab.device).repeat(Bsz, 1)
    for k in range(b):
        g = j0 + k
        ck_re, ck_im = re[:, :, k], im[:, :, k]
        mag = torch.where(rows >= g, ck_re * ck_re + ck_im * ck_im, -1.0)
        p = torch.argmax(mag, dim=1)
        for plane in (re, im, perm[:, :, None]):
            _swap_rows(plane, g, p)
        pr, pi = re[:, g, k], im[:, g, k]
        nz = (pr != 0) | (pi != 0)
        pr = torch.where(nz, pr, tiny)
        pi = torch.where(nz, pi, 0.0)
        # Smith's reciprocal, as feast_tpu/ops/pallas_lu.py:110-118
        big = pr.abs() >= pi.abs()
        r1 = pi / torch.where(pr == 0, 1.0, pr)
        den1 = pr + pi * r1
        r2 = pr / torch.where(pi == 0, 1.0, pi)
        den2 = pr * r2 + pi
        inv_r = torch.where(big, 1.0 / den1, r2 / den2)[:, None]
        inv_i = torch.where(big, -r1 / den1, -1.0 / den2)[:, None]
        cr, ci = re[:, g + 1:, k], im[:, g + 1:, k]
        mr = cr * inv_r - ci * inv_i
        mi = cr * inv_i + ci * inv_r
        re[:, g + 1:, k] = mr
        im[:, g + 1:, k] = mi
        ur, ui = re[:, g, None, k + 1:], im[:, g, None, k + 1:]
        mr, mi = mr[:, :, None], mi[:, :, None]
        re[:, g + 1:, k + 1:] -= mr * ur - mi * ui
        im[:, g + 1:, k + 1:] -= mr * ui + mi * ur
    # invL11 by column-oriented forward substitution (the kernel's order)
    Lr, Li = re[:, j0:j0 + b, :], im[:, j0:j0 + b, :]
    Xr = torch.eye(b, dtype=rdt, device=slab.device).repeat(Bsz, 1, 1)
    Xi = torch.zeros_like(Xr)
    for l in range(b - 1):
        lr, li = Lr[:, l + 1:, l, None], Li[:, l + 1:, l, None]
        xr, xi = Xr[:, l, None, :], Xi[:, l, None, :]
        Xr[:, l + 1:, :] -= lr * xr - li * xi
        Xi[:, l + 1:, :] -= lr * xi + li * xr
    slab.copy_(torch.complex(re, im))
    return slab, perm.to(torch.int32), torch.complex(Xr, Xi)


def lu_factor_panel(A: torch.Tensor, block: int = 128, panel=panel_factor,
                    inplace: bool = False, moved: torch.Tensor = None):
    """Blocked LU with partial pivoting through `panel_factor`, over leading
    batch dims; n % block == 0.  Same contract as `lu.lu_factor`.

    panel: the panel step; `panel_factor_plain` runs the plain version on
    any device (to hold the kernel against it).  inplace: factor A itself
    (contiguous) instead of a copy.  moved: an int64 0-d tensor on A's
    device that the row swaps add their moved rows to (`row_swap`).

    Each panel works on the whole batch in place: the panel step, its row
    swaps on the rows they move (`row_swap.apply_panel_perm`), U12 =
    invL11 @ A12, and the trailing update A22 += -1 * L21 @ U12 by
    `cmatmul_kernel.addmm_`, whatever `cx`'s gemm backend: on the card the
    tensor-core kernel accumulating into A22 in place (no temporary, no
    separate subtraction), on the CPU its plain version."""
    n = A.shape[-1]
    if A.shape[-2] != n or n % block != 0:
        raise ValueError(f"lu_factor_panel needs square (..., n, n) with "
                         f"n % block == 0 (shape {tuple(A.shape)}, block={block})")
    if inplace and not A.is_contiguous():
        raise ValueError("lu_factor_panel(inplace=True) needs a contiguous tensor")
    batch = A.shape[:-2]
    A3 = A.reshape(-1, n, n) if inplace else A.reshape(-1, n, n).clone()
    perm = torch.arange(n, device=A.device).repeat(A3.shape[0], 1)
    for j in range(0, n, block):
        e = j + block
        _, pb, invL = panel(A3[:, :, j:e], j)
        row_swap.apply_panel_perm(A3, pb, j, block, moved)
        perm = torch.gather(perm, 1, pb.long())
        if e < n:
            # the product's temporary goes with the statement: no two panels'
            # U12 are ever held at once
            A3[:, j:e, e:] = cx.cmatmul(invL, A3[:, j:e, e:])
            cmatmul_kernel.addmm_(A3[:, e:, e:], A3[:, e:, j:e], A3[:, j:e, e:], -1.0)
    return A3.reshape(batch + (n, n)), perm.reshape(batch + (n,))
