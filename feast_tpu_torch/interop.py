"""Carry state from the JAX package into the port, and results back out.

The JAX package holds complex data as `CX` (re, im) pairs and contours as
its own `Contour`.  These helpers take either as plain host data (numpy
arrays, or anything `np.asarray` accepts) so the port never imports JAX:
a `CX` is a 2-tuple, and a contour is read through its `nodes`, `weights`,
`kind` and `params` attributes.  With them both packages solve the same
problem from the same seeded inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from . import contour as ct


def tensor_from_pair(pair, device="cpu", dtype=None) -> torch.Tensor:
    """(re, im) pair -> complex tensor on `device`.

    dtype defaults to complex128 for float64 planes, complex64 otherwise."""
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
