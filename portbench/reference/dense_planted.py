"""Plain reference of the planted dense configurations.

The benchmark's generator planted A's spectrum (`problems/dense_planted.py`:
A = X D X^-1), so every eigenvalue of A is known from its input D: the
ones inside the circle |z - c| <= r are the ones a solve has to return.
A returned pair is held to the configuration's tolerance as
`feast_compiled` defines it (tol_mode "abs"): the absolute residual
||A x - lam x|| of the unit vector x, formed here from the benchmark's own
A in complex128.

The control is the reference one precision down: `torch.linalg.eig` of A
in complex64, its vectors normalised, the pairs inside the circle.

This file imports numpy and torch only: nothing of the port.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK = 256   # vectors a residual product takes at once


class Context:
    def __init__(self, config: dict, inst: dict, device):
        self.c = complex(*config["c"])
        self.r = float(config["r"])
        self.device = torch.device(device)
        self.A = torch.as_tensor(inst["A"], dtype=torch.complex128, device=self.device)
        lam = np.asarray(inst["lam"], dtype=np.complex128)
        self.lam = lam[self.inside(lam)]

    def inside(self, lam: np.ndarray) -> np.ndarray:
        return np.abs(lam - self.c) <= self.r


def prepare(config: dict, inst: dict, device) -> Context:
    return Context(config, inst, device)


def eigenvalues(ctx: Context) -> np.ndarray:
    return ctx.lam


def residuals(ctx: Context, lam: np.ndarray, X: np.ndarray) -> np.ndarray:
    out = []
    for j in range(0, X.shape[1], BLOCK):
        x = torch.as_tensor(X[:, j:j + BLOCK], dtype=torch.complex128, device=ctx.device)
        x = x / torch.linalg.vector_norm(x, dim=0)
        lt = torch.as_tensor(lam[j:j + BLOCK], dtype=torch.complex128, device=ctx.device)
        R = ctx.A @ x - x * lt
        out.append(torch.linalg.vector_norm(R, dim=0).cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)


def control(ctx: Context):
    """(lam, X) inside the circle from the complex64 eig of A."""
    lam, V = torch.linalg.eig(ctx.A.to(torch.complex64))
    lam, V = lam.cpu().numpy(), V.cpu().numpy()
    keep = ctx.inside(lam.astype(np.complex128))
    V = V[:, keep]
    return lam[keep].astype(np.complex128), (V / np.linalg.norm(V, axis=0)).astype(np.complex128)
