"""Carry state from the JAX package into the port, and results back out.

The JAX package holds complex data as `CX` (re, im) pairs and contours as
its own `Contour`.  These helpers take either as plain host data (numpy
arrays, or anything `np.asarray` accepts) so the port never imports JAX:
a `CX` is a 2-tuple, and a contour is read through its `nodes`, `weights`,
`kind` and `params` attributes.  Sparse operators (`CSR`, `DIA`, `BELL`,
`STRETCH`, `STRETCHT`) and an `AMG` hierarchy are read the same way, by
class name and attributes, so both packages can be fed one hierarchy; Krylov warm starts
are (nodes, n, m0) pairs and go through `tensor_from_pair`.  With them
both packages solve the same problem from the same seeded inputs.
`nep_from` carries a JAX-side SPMF / PolynomialNEP / LinearPencilNEP
across: its coefficient matrices as numpy, its scalar functions (JAX
callables, which cannot cross) rebuilt on the port's side or passed in.
"""

from __future__ import annotations

import numpy as np
import torch

from . import contour as ct
from ._device import resolve_device
from . import nep as nepmod
from .ops import amg as amgmod
from .ops import sparse as spmod


def tensor_from_pair(pair, device="cuda", dtype=None) -> torch.Tensor:
    """(re, im) pair -> complex tensor on `device`.

    dtype defaults to complex128 for float64 planes, complex64 otherwise."""
    device = resolve_device(device)
    re, im = (np.asarray(p) for p in pair)
    if dtype is None:
        dtype = torch.complex128 if re.dtype == np.float64 else torch.complex64
    return torch.as_tensor(re + 1j * im, dtype=dtype, device=device)


def contour_from(contour) -> ct.Contour:
    """A JAX-side Contour (nodes, weights, kind, params) -> the port's."""
    return ct.Contour(np.asarray(contour.nodes, dtype=np.complex128),
                      np.asarray(contour.weights, dtype=np.complex128),
                      str(contour.kind), tuple(float(p) for p in contour.params))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor on any device -> host numpy array."""
    return t.detach().cpu().numpy()


def operator_from(op, device="cuda", dtype=None):
    """A JAX-side CSR / DIA / BELL / STRETCH / STRETCHT operator -> the port's."""
    device = resolve_device(device)
    kind = type(op).__name__
    if kind == "STRETCHT":
        return spmod.STRETCHT(operator_from(op.P, device, dtype))
    data = tensor_from_pair(op.data, device, dtype)
    if kind == "BELL":
        spill = None if op.spill is None else operator_from(op.spill, device, dtype)
        colb = torch.as_tensor(np.asarray(op.colb).astype(np.int64), device=device)
        return spmod.BELL(data, colb, op.shape, spill)
    if kind == "DIA":
        return spmod.DIA(data, op.offsets, op.shape)
    if kind == "STRETCH":
        return spmod.STRETCH(data, op.offsets, op.stride, op.shape)
    if kind == "CSR":
        def ids(a):
            return torch.as_tensor(np.asarray(a).astype(np.int64), device=device)

        return spmod.CSR(data, ids(op.indices), ids(op.row_ids), op.shape)
    raise NotImplementedError(f"interop: no counterpart for operator {kind}")


def amg_from(amg, device="cuda", dtype=None) -> amgmod.AMG:
    """A JAX-side AMG hierarchy (levels, Ac, Bc) -> the port's."""
    device = resolve_device(device)
    levels = tuple(
        amgmod.AMGLevel(operator_from(L.A_op, device, dtype),
                        operator_from(L.B_op, device, dtype),
                        tensor_from_pair(L.dA, device, dtype),
                        tensor_from_pair(L.dB, device, dtype),
                        operator_from(L.P, device, dtype),
                        operator_from(L.R, device, dtype))
        for L in amg.levels)
    return amgmod.AMG(levels, tensor_from_pair(amg.Ac, device, dtype),
                      tensor_from_pair(amg.Bc, device, dtype))


def nep_from(T, funcs=None, device="cuda"):
    """A JAX-side SPMF (or PolynomialNEP / LinearPencilNEP) -> the port's.

    The coefficient matrices are read through `mats` (CX pairs).  A
    polynomial's monomials and a pencil's (1, -z) are rebuilt here; a
    general SPMF needs `funcs`, the port's own scalar functions, one per
    term and in the same order."""
    mats = [np.asarray(m.re) + 1j * np.asarray(m.im) for m in T.mats]
    kind = type(T).__name__
    if kind == "PolynomialNEP":
        return nepmod.PolynomialNEP(mats, device)
    if kind == "LinearPencilNEP":
        return nepmod.LinearPencilNEP(mats[0], mats[1], device)
    if funcs is None or len(funcs) != len(mats):
        raise ValueError(f"nep_from: an SPMF of {len(mats)} terms needs as many "
                         "port-side scalar functions")
    return nepmod.SPMF(list(zip(mats, funcs)), device)
