"""A dense non-normal matrix with a planted spectrum: A = X D X^-1.

The construction of LAPACK's test-matrix generator ZLATME (TESTING/MATGEN,
Demmel and McKenney, LAPACK Working Note 9) with SIM = 'T', UPPER = 'F',
RSIGN = 'F', KL = KU = n - 1 (dense) and no scaling (ANORM < 0):

  D   diag(d), MODE 4 with COND = n and DMAX = 1: d arithmetic from 1 down
      to 1/n, that is d_j = j / n, j = 1..n;
  X   U S V, U and V random unitary (Haar: the Q of a complex Gaussian
      matrix, R's diagonal made positive), S = diag(s) with MODES 4:
      s arithmetic from 1 down to 1/conds.

A = (U S V) D (V^H S^-1 U^H) is formed on the device in complex128, the
Gaussians drawn from a torch generator seeded from (seed, stream), so the
same seed gives the same A on the same device.  Every seed plants the same
spectrum: what a solve has to find, and how fast FEAST's filter separates
it, is the same in every run; the eigenvectors are the seed's.

Variant k >= 1 (a nearby problem of a sequence of solves) keeps U, S and D
and turns V: V_k = the unitary factor of V + delta / sqrt(n) H_k, H_k
complex Gaussian from the stream (seed, 1, k), so each eigenvector moves by
about delta and every eigenvalue stays where it was planted.

Configuration keys read: n, conds.
"""

from __future__ import annotations

import numpy as np


def spectrum(n: int) -> np.ndarray:
    """The planted eigenvalues d_j = j / n, j = 1..n (ZLATME MODE 4)."""
    return np.arange(1, n + 1, dtype=np.float64) / n


def _generator(device, seed: int, *stream: int):
    import torch

    state = np.random.SeedSequence([int(seed) % (1 << 64), *stream]).generate_state(
        1, np.uint64)[0]
    g = torch.Generator(device=device)
    g.manual_seed(int(state) >> 1)
    return g


def _gaussian(n: int, g, device):
    import torch

    return torch.randn((n, n), dtype=torch.complex128, generator=g, device=device)


def _unitary(G):
    """The Haar unitary of a complex Gaussian G: Q of G = QR with R's
    diagonal made real and positive."""
    import torch

    Q, R = torch.linalg.qr(G)
    d = torch.diagonal(R)
    return Q * (d / d.abs()).unsqueeze(0)


def make(config: dict, seed: int, variants: int, delta: float, device) -> dict:
    import torch

    n, conds = int(config["n"]), float(config["conds"])
    dev = torch.device(device)
    d = torch.as_tensor(spectrum(n), dtype=torch.complex128, device=dev)
    s = torch.linspace(1.0, 1.0 / conds, n, dtype=torch.float64, device=dev).to(
        torch.complex128)
    U = _unitary(_gaussian(n, _generator(dev, seed, 0, 0), dev))
    US = U * s.unsqueeze(0)
    SiUh = U.mH / s.unsqueeze(1)
    del U
    V = _unitary(_gaussian(n, _generator(dev, seed, 0, 1), dev))
    instances = []
    for k in range(variants):
        if k == 0:
            Vk = V
        else:
            H = _gaussian(n, _generator(dev, seed, 1, k), dev)
            Vk = _unitary(V + (float(delta) / np.sqrt(n)) * H)
            del H
        # A = U S Vk D Vk^H S^-1 U^H
        inner = (Vk * d.unsqueeze(0)) @ Vk.mH
        A = (US @ inner) @ SiUh
        del inner, Vk
        instances.append({"A": A, "lam": spectrum(n).astype(np.complex128)})
    del V, US, SiUh
    return {"instances": instances}
