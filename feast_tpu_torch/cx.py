"""Complex helpers that carry semantics, on native complex tensors.

The JAX package stores complex numbers as `cx.CX` (re, im) pairs because
the TPU has no complex element types.  The port uses `torch.complex128`
and `torch.complex64` directly, so the pair plumbing (constructors,
arithmetic operators, stacking) has no counterpart here.  What stays is
arithmetic whose exact formulation matters: Smith's division (the LU
zero-pivot guard relies on it), the principal square root and phase used
by the Schur iteration, and the column-wise reductions of the drivers.

Functions broadcast over leading batch dimensions; "columns" are the
last axis of a (..., n, m) tensor.
"""

from __future__ import annotations

import torch


def real_dtype(dtype: torch.dtype) -> torch.dtype:
    """Real counterpart of a complex dtype (identity for real dtypes)."""
    return {torch.complex64: torch.float32,
            torch.complex128: torch.float64}.get(dtype, dtype)


def complex_dtype(dtype: torch.dtype) -> torch.dtype:
    """Complex counterpart of a real dtype (identity for complex dtypes)."""
    return {torch.float32: torch.complex64,
            torch.float64: torch.complex128}.get(dtype, dtype)


def parts(x: torch.Tensor):
    """(real, imag) planes of a real or complex tensor."""
    if x.is_complex():
        return x.real, x.imag
    return x, torch.zeros_like(x)


def cdiv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise a / b by Smith's algorithm (no overflow of |b|^2)."""
    ar, ai = parts(a)
    c, d = parts(b)
    big = c.abs() >= d.abs()
    # branch 1: r = d/c, den = c + d*r
    r1 = d / torch.where(c == 0, 1.0, c)
    den1 = c + d * r1
    re1 = (ar + ai * r1) / den1
    im1 = (ai - ar * r1) / den1
    # branch 2: r = c/d, den = c*r + d
    r2 = c / torch.where(d == 0, 1.0, d)
    den2 = c * r2 + d
    re2 = (ar * r2 + ai) / den2
    im2 = (ai * r2 - ar) / den2
    return torch.complex(torch.where(big, re1, re2), torch.where(big, im1, im2))


def creciprocal(a: torch.Tensor) -> torch.Tensor:
    return cdiv(torch.ones_like(a), a)


def abs2(a: torch.Tensor) -> torch.Tensor:
    re, im = parts(a)
    return re * re + im * im


def cabs(a: torch.Tensor) -> torch.Tensor:
    re, im = parts(a)
    return torch.hypot(re, im)


def csqrt(a: torch.Tensor) -> torch.Tensor:
    """Principal square root, by the same formula as the JAX package."""
    re, im = parts(a)
    m = torch.hypot(re, im)
    sre = torch.sqrt(torch.clamp((m + re) / 2, min=0.0))
    im_mag = torch.sqrt(torch.clamp((m - re) / 2, min=0.0))
    return torch.complex(sre, torch.where(im >= 0, im_mag, -im_mag))


def cpow_scalar(z: torch.Tensor, p: int) -> torch.Tensor:
    """Integer power z**p by repeated squaring (the JAX package's order of
    products)."""
    result = torch.ones_like(z)
    base = z
    while p > 0:
        if p & 1:
            result = result * base
        base = base * base
        p >>= 1
    return result


def phase(a: torch.Tensor, eps=0.0) -> torch.Tensor:
    """a/|a| with a -> 1 where |a| <= eps (the Householder sign choice)."""
    re, im = parts(a)
    m = torch.hypot(re, im)
    safe = m > eps
    m_ = torch.where(safe, m, 1.0)
    return torch.complex(torch.where(safe, re / m_, 1.0),
                         torch.where(safe, im / m_, 0.0))


def cdot_cols(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Column-wise inner products sum_i conj(a[i, j]) b[i, j]."""
    return torch.sum(a.conj() * b, dim=-2)


def cgram(a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """a^H b (or a^H a).  The JAX package reduces elementwise in f64 to
    dodge the TPU's emulated-f64 matmul; here f64 is native, so it is the
    matmul."""
    return a.mH @ (a if b is None else b)


def col_norms(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(abs2(a), dim=-2))


def fro_norm(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(abs2(a), dim=(-2, -1)))


def normalize_cols(a: torch.Tensor, eps=0.0) -> torch.Tensor:
    """Scale each column to unit 2-norm (zero columns are left as they are).
    eps is the JAX package's argument, which its function does not read
    either."""
    nrm = col_norms(a)
    nrm = torch.where(nrm == 0, 1.0, nrm)
    return a / nrm.unsqueeze(-2)


def scale_cols(a: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """a @ diag(s)."""
    return a * s.unsqueeze(-2)


_GEMM_BACKEND = "torch"


def set_gemm_backend(name: str):
    """Select the complex64 matrix product behind `cmatmul`: "torch" (the
    default: `a @ b`) or "cuda" (the hand-written Hopper kernel of
    ops/cmatmul_kernel.py).  Other dtypes always take `a @ b`.  With "cuda"
    a complex64 product on CPU tensors raises: nothing falls back."""
    global _GEMM_BACKEND
    if name not in ("torch", "cuda"):
        raise ValueError(f"unknown gemm backend {name!r}")
    _GEMM_BACKEND = name


_PRECISIONS = ("highest", "high", "default")


def cmatmul(a: torch.Tensor, b: torch.Tensor, precision=None) -> torch.Tensor:
    """a @ b over broadcasting batch dims, through the selected backend.

    precision: the JAX spelling (None, "highest", "high", "default", or an
    object such as `jax.lax.Precision.HIGHEST` whose name is one of them).
    Every value computes at full accuracy, the JAX default HIGHEST: TF32
    is off for the whole port (see _device), and no call switches it."""
    name = getattr(precision, "name", precision)
    if name is not None and str(name).lower() not in _PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}; one of {_PRECISIONS}")
    if (_GEMM_BACKEND == "cuda" and a.dtype == torch.complex64
            and b.dtype == torch.complex64):
        if not (a.is_cuda and b.is_cuda):
            raise RuntimeError('gemm backend "cuda" needs CUDA tensors; the '
                               "plain product is backend \"torch\"")
        from .ops import cmatmul_kernel

        return cmatmul_kernel.cmatmul(a, b)
    return a @ b


def _cmatmul_planes(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of the cmatmul kernel: the same three real products
    (Karatsuba, as the TPU kernel forms them), t1 = Ar Br, t2 = Ai Bi,
    t3 = (Ar + Ai)(Br + Bi), Cr = t1 - t2, Ci = t3 - t1 - t2, as matmuls on
    the planes in the planes' precision (fp32 for complex64; TF32 is off,
    see _device)."""
    ar, ai = a.real, a.imag
    br, bi = b.real, b.imag
    t1, t2 = ar @ br, ai @ bi
    t3 = (ar + ai) @ (br + bi)
    return torch.complex(t1 - t2, t3 - t1 - t2)
