"""Matrix I/O: MatrixMarket reading and per-slice checkpoints.

Counterpart of `feast_tpu/io.py`.  `read_matrix_market` reads through
scipy's `mmread` (the JAX package's fallback path; its native C++ reader
only speeds up the host parse and is not ported) and returns scipy CSR,
dense complex numpy, or the port's `CSR` operator.  `save_slice` /
`load_slice` write and read the same .npz layout as the JAX package, so a
slice saved by either package loads in the other; `load_slice(...)["X"]`
feeds any driver's X0 as a warm restart.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def read_matrix_market(path: str, out: str = "scipy", device="cuda"):
    """Read a .mtx file.

    out: "scipy" (csr_matrix, complex128), "dense" (numpy complex128), or
    "csr" (the port's `ops.sparse.CSR` on `device`, the card unless the
    caller asks for the CPU; the host outputs ignore `device`)."""
    import scipy.sparse as sp
    from scipy.io import mmread

    m = mmread(path)
    A = (sp.csr_matrix(m) if sp.issparse(m) else sp.csr_matrix(np.asarray(m))
         ).astype(np.complex128)
    if out == "scipy":
        return A
    if out == "dense":
        return np.asarray(A.todense(), dtype=np.complex128)
    if out == "csr":
        from ._device import resolve_device
        from .ops.sparse import CSR

        return CSR.from_scipy(A, device=resolve_device(device))
    raise ValueError(f"unknown out={out}")


def _host(x) -> np.ndarray:
    """Tensor (any device), CX-like (re, im) pair, or array -> numpy."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    if hasattr(x, "re") and hasattr(x, "im"):
        return np.asarray(x.re) + 1j * np.asarray(x.im)
    return np.asarray(x)


def save_slice(path: str, result, contour=None, meta: Optional[dict] = None):
    """Persist a solver result (lam, X, res, inside, n_iter, converged) as
    .npz, with the contour's nodes, weights, kind and params if given."""
    payload = {
        "lam": _host(result.lam),
        "X": _host(result.X),
        "res": _host(result.res),
        "inside": _host(result.inside),
        "n_iter": np.asarray(result.n_iter),
        "converged": np.asarray(result.converged),
    }
    if contour is not None:
        payload["contour_nodes"] = np.asarray(contour.nodes)
        payload["contour_weights"] = np.asarray(contour.weights)
        payload["contour_kind"] = np.asarray(contour.kind)
        payload["contour_params"] = np.asarray(contour.params)
    for k, v in (meta or {}).items():
        payload[f"meta_{k}"] = np.asarray(v)
    np.savez_compressed(path, **payload)


def load_slice(path: str) -> dict:
    """Load a saved slice as a dict of numpy arrays."""
    with np.load(path, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}
