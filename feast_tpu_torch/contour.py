"""Contour quadrature: nodes and weights on circles, rectangles, ellipses,
Zolotarev rules and user-supplied rules.

Counterpart of `feast_tpu/contour.py`, computed the same way on the host
in numpy complex128.  The weights absorb the dz/(2 pi i) factor, so every
solver evaluates  sum_i w_i f(z_i)  with f the resolvent.  Nodes and
weights reach the device as complex tensors (`device_nodes`,
`device_weights`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from . import cx
from ._device import resolve_device


@dataclasses.dataclass(frozen=True)
class Contour:
    """Quadrature rule on a closed contour in the complex plane.

    nodes, weights: numpy complex128.  kind/params describe the shape for
    `in_contour`: circle (c_re, c_im, r); rect (bl_re, bl_im, tr_re,
    tr_im); ellipse (c_re, c_im, rx, ry); custom ().
    """

    nodes: np.ndarray
    weights: np.ndarray
    kind: str = "custom"
    params: Tuple[float, ...] = ()

    def __len__(self):
        return len(self.nodes)

    @property
    def size(self):
        return len(self.nodes)

    @property
    def center(self) -> complex:
        if self.kind in ("circle", "ellipse"):
            return complex(self.params[0], self.params[1])
        if self.kind == "rect":
            bl = complex(self.params[0], self.params[1])
            tr = complex(self.params[2], self.params[3])
            return (bl + tr) / 2
        return complex(np.mean(self.nodes))

    @property
    def radius(self) -> float:
        if self.kind == "circle":
            return float(self.params[2])
        if self.kind == "ellipse":
            return float(max(self.params[2], self.params[3]))
        return float(np.max(np.abs(np.asarray(self.nodes) - self.center)))

    @property
    def spectral_scale(self) -> float:
        """max |z| over the nodes (the drivers' tol_mode="contour" scale)."""
        return float(np.max(np.abs(np.asarray(self.nodes))))

    def device_nodes(self, dtype=torch.complex128, device="cuda") -> torch.Tensor:
        return torch.as_tensor(np.asarray(self.nodes), dtype=dtype,
                               device=resolve_device(device))

    def device_weights(self, dtype=torch.complex128,
                       device="cuda") -> torch.Tensor:
        return torch.as_tensor(np.asarray(self.weights), dtype=dtype,
                               device=resolve_device(device))


# ---------------------------------------------------------------------------
# constructors
# ---------------------------------------------------------------------------

def circular_contour_trapezoidal(c: complex, r: float, n: int = 16) -> Contour:
    """N-point trapezoid rule on |z - c| = r:
    theta_i = pi/N + 2 pi (i-1)/N,  w_i = r e^{i theta_i} / N."""
    c = complex(c)
    theta = np.pi / n + 2 * np.pi * np.arange(n) / n
    e = np.exp(1j * theta)
    return Contour(r * e + c, r * e / n, "circle", (c.real, c.imag, float(r)))


def circular_contour_gauss(c: complex, r: float, n: int = 16) -> Contour:
    """Gauss-Legendre rule on two half-circles."""
    if n % 2 != 0:
        raise ValueError("Number of nodes must be a multiple of 2")
    c = complex(c)
    gq_nodes, gq_w = np.polynomial.legendre.leggauss(n // 2)
    theta = (np.pi / 2.0) * (gq_nodes + 1.0)  # [0, pi]
    nodes = np.concatenate([r * np.exp(1j * theta) + c,
                            r * np.exp(1j * (theta + np.pi)) + c])
    weights = np.concatenate([r * np.exp(1j * theta) * gq_w / 4.0,
                              r * np.exp(1j * (theta + np.pi)) * gq_w / 4.0])
    return Contour(nodes, weights, "circle", (c.real, c.imag, float(r)))


def _check_rect(bl: complex, tr: complex, n: int):
    if not (bl.real < tr.real and bl.imag < tr.imag):
        raise ValueError("Invalid corners")
    if n % 4 != 0:
        raise ValueError("Number of nodes must be a multiple of 4")


def rectangular_contour_gauss(bottom_left: complex, top_right: complex,
                              n: int = 16) -> Contour:
    """Gauss-Legendre rule on a rectangle, edges top/right/bottom/left."""
    bl, tr = complex(bottom_left), complex(top_right)
    _check_rect(bl, tr, n)
    q = n // 4
    gq, gw = np.polynomial.legendre.leggauss(q)
    top_len = tr.real - bl.real
    side_len = tr.imag - bl.imag
    nodes = np.empty(n, dtype=np.complex128)
    weights = np.empty(n, dtype=np.complex128)
    nodes[0:q] = (gq + 1) * (top_len / 2) + (tr.imag * 1j + bl.real)
    nodes[q:2 * q] = (gq + 1) * (1j * side_len / 2) + (bl.imag * 1j + tr.real)
    nodes[2 * q:3 * q] = (gq[::-1] + 1) * (top_len / 2) + (bl.imag * 1j + bl.real)
    nodes[3 * q:4 * q] = (gq[::-1] + 1) * (1j * side_len / 2) + (bl.imag * 1j + bl.real)
    weights[0:q] = gw * top_len
    weights[q:2 * q] = -1j * gw * side_len
    weights[2 * q:3 * q] = -gw * top_len
    weights[3 * q:4 * q] = 1j * gw * side_len
    weights /= (-4.0 * np.pi * 1j)
    return Contour(nodes, weights, "rect", (bl.real, bl.imag, tr.real, tr.imag))


def rectangular_contour_trapezoidal(bottom_left: complex, top_right: complex,
                                    n: int = 16) -> Contour:
    """Composite trapezoid rule on a rectangle, corner weights halved."""
    bl, tr = complex(bottom_left), complex(top_right)
    _check_rect(bl, tr, n)
    q = n // 4
    nodes = np.empty(n, dtype=np.complex128)
    weights = np.empty(n, dtype=np.complex128)
    nodes[0:q] = np.linspace(bl.real, tr.real, q + 1)[:q] + tr.imag * 1j
    nodes[q:2 * q] = np.linspace(tr.imag, bl.imag, q + 1)[:q] * 1j + tr.real
    nodes[2 * q:3 * q] = np.linspace(tr.real, bl.real, q + 1)[:q] + bl.imag * 1j
    nodes[3 * q:4 * q] = np.linspace(bl.imag, tr.imag, q + 1)[:q] * 1j + bl.real
    top_len = tr.real - bl.real
    side_len = tr.imag - bl.imag
    weights[0] = 1j * side_len / (2 * q) + top_len / (2 * q)
    weights[1:q] = top_len / q
    weights[q] = top_len / (2 * q) - 1j * side_len / (2 * q)
    weights[q + 1:2 * q] = -1j * side_len / q
    weights[2 * q] = -1j * side_len / (2 * q) - top_len / (2 * q)
    weights[2 * q + 1:3 * q] = -top_len / q
    weights[3 * q] = -top_len / (2 * q) + 1j * side_len / (2 * q)
    weights[3 * q + 1:4 * q] = 1j * side_len / q
    weights /= (-2.0 * np.pi * 1j)
    return Contour(nodes, weights, "rect", (bl.real, bl.imag, tr.real, tr.imag))


def custom_contour(nodes, weights) -> Contour:
    """User-supplied quadrature."""
    return Contour(np.asarray(nodes, dtype=np.complex128),
                   np.asarray(weights, dtype=np.complex128), "custom", ())


def elliptical_contour_trapezoidal(c: complex, rx: float, ry: float,
                                   n: int = 16) -> Contour:
    """N-point trapezoid rule on the ellipse c + rx cos(t) + i ry sin(t);
    w_k = z'(t_k)/(2 pi i) dt."""
    c = complex(c)
    t = np.pi / n + 2 * np.pi * np.arange(n) / n
    nodes = c + rx * np.cos(t) + 1j * ry * np.sin(t)
    dz = -rx * np.sin(t) + 1j * ry * np.cos(t)
    weights = dz * (2 * np.pi / n) / (2j * np.pi)
    return Contour(nodes, weights, "ellipse",
                   (c.real, c.imag, float(rx), float(ry)))


def zolotarev_contour(a: float, b: float, n: int = 8,
                      gap: Optional[float] = None,
                      spectrum_bound: Optional[float] = None) -> Contour:
    """Zolotarev rational filter for a real slice [a, b] as nodes/weights
    by partial fractions (4n poles at a +- i S sqrt(c_j), b +- i S sqrt(c_j)).

    gap: transition half-width at the endpoints, default (b-a)/100.
    spectrum_bound: S with |lam - a|, |lam - b| <= S, default 50 (b-a).
    """
    from scipy.special import ellipj, ellipk

    if not b > a:
        raise ValueError("need a < b")
    width = b - a
    g = gap if gap is not None else width / 100.0
    S = spectrum_bound if spectrum_bound is not None else 50.0 * width
    ell = g / S
    mp = 1.0 - ell * ell
    Kp = ellipk(mp)
    j = np.arange(1, 2 * n)
    sn, cn, _, _ = ellipj(j * Kp / (2 * n), mp)
    cc = ell * ell * (sn / cn) ** 2
    c_odd = cc[0::2]    # n pole parameters
    c_even = cc[1::2]   # n-1 zero parameters

    # normalization M: equioscillate R around 1 on [ell, 1]
    xs = np.linspace(ell, 1.0, 4001)
    num = xs * np.prod(xs[None, :] ** 2 + c_even[:, None], axis=0)
    den = np.prod(xs[None, :] ** 2 + c_odd[:, None], axis=0)
    vals = num / den
    M = 2.0 / (vals.min() + vals.max())

    res = np.empty(n)
    for k in range(n):
        pe = np.prod(c_even - c_odd[k]) if n > 1 else 1.0
        po = np.prod(np.delete(c_odd, k) - c_odd[k]) if n > 1 else 1.0
        res[k] = M * pe / (2.0 * po)

    sq = np.sqrt(c_odd)
    nodes = np.concatenate([a + 1j * S * sq, a - 1j * S * sq,
                            b + 1j * S * sq, b - 1j * S * sq])
    q = np.concatenate([S * res / 2.0, S * res / 2.0,
                        -S * res / 2.0, -S * res / 2.0])
    # rho(x) = sum w_i / (z_i - x)  =>  w = -q for filter sum q_i / (x - z_i)
    weights = (-q).astype(np.complex128)
    hbox = max(g, 1e-12 * width)
    return Contour(nodes.astype(np.complex128), weights, "rect",
                   (float(a), -float(hbox), float(b), float(hbox)))


# ---------------------------------------------------------------------------
# membership / filter
# ---------------------------------------------------------------------------

def _re_im(lam):
    if isinstance(lam, torch.Tensor):
        return cx.parts(lam)
    lam = np.asarray(lam)
    return lam.real, lam.imag


def in_contour(lam, contour: Contour):
    """Boolean mask of the eigenvalues inside the contour.

    Circle |lam - c| <= r; rect strict box; ellipse; custom by the rational
    filter's winding test |rho(lam)| > 1/2.  Takes numpy arrays or tensors
    and returns the same kind.
    """
    if contour.kind in ("circle", "rect", "ellipse"):
        return in_region(lam, contour.kind, contour.params)
    if isinstance(lam, torch.Tensor):
        return cx.abs2(rational_func_tensor(lam, contour)) > 0.25
    return np.abs(rational_func(lam, contour)) ** 2 > 0.25


def in_region(lam, kind: str, params):
    """Membership in a circle, rect (strict box) or ellipse given by
    (kind, params) as stored on a Contour."""
    lr, li = _re_im(lam)
    if kind == "circle":
        c_re, c_im, r = params
        return (lr - c_re) ** 2 + (li - c_im) ** 2 <= r * r
    if kind == "rect":
        bl_re, bl_im, tr_re, tr_im = params
        return (bl_re < lr) & (lr < tr_re) & (bl_im < li) & (li < tr_im)
    if kind == "ellipse":
        c_re, c_im, rx, ry = params
        return ((lr - c_re) / rx) ** 2 + ((li - c_im) / ry) ** 2 <= 1.0
    raise ValueError(f"no region test for contour kind {kind!r}")


def in_contour_circle(lam, c: complex, r: float):
    """Direct circle membership |lam - c| <= r."""
    lr, li = _re_im(lam)
    c = complex(c)
    return (lr - c.real) ** 2 + (li - c.imag) ** 2 <= r * r


def rational_func(z, contour: Contour):
    """rho(z) = sum_i w_i / (x_i - z), host numpy form."""
    z = np.asarray(z)
    nodes = np.asarray(contour.nodes)
    weights = np.asarray(contour.weights)
    return np.sum(weights[:, None] / (nodes[:, None] - z.ravel()[None, :]),
                  axis=0).reshape(z.shape)


def rational_func_tensor(z: torch.Tensor, contour: Contour) -> torch.Tensor:
    """rho(z) on a tensor, with Smith's division (as the JAX pair form)."""
    dt = cx.complex_dtype(z.dtype)
    nodes = contour.device_nodes(dt, z.device)
    weights = contour.device_weights(dt, z.device)
    zf = z.reshape(-1).to(dt)
    quot = cx.cdiv(weights[:, None].expand(-1, zf.shape[0]),
                   nodes[:, None] - zf[None, :])
    return quot.sum(0).reshape(z.shape)


def rational_func_pairs(zr, zi, contour: Contour) -> torch.Tensor:
    """rho(z) at z = zr + i zi (the JAX package's name, whose arguments are
    the pair's planes); returns the complex tensor `rational_func_tensor`
    gives, on zr's device, complex128 for float64 planes."""
    zr = torch.as_tensor(zr)
    zi = torch.as_tensor(zi, dtype=zr.dtype, device=zr.device)
    return rational_func_tensor(torch.complex(zr, zi), contour)
