"""The RF gun's shape: T(z) = K - z I + i sqrt(z - s1^2) W1 + i sqrt(z - s2^2) W2.

Frozen copy of the planted branch of `feast_tpu_torch/problems.py::gun_like`
(`_gun_like_parts`, the construction of the JAX package's
`problems.gun_like`), with its numpy draws in the same order from
default_rng(seed):

  d   `planted` values uniform in the cluster (lo, hi), then n - planted
      uniform in (4 hi, 40 hi): K = Q diag(d) Q^T, Q = P4 P3 P2 P1 a product
      of 4 Householder reflectors P = I - 2 v v^T of Gaussian v;
  W1, W2  U V of rank max(4, n // 64), Gaussian U and V, U scaled so that
      ||U V||_2 = 0.6 / sqrt(lo);
  s1 = 0, s2 = sqrt(0.8 lo): both branch points below the cluster.

The host keeps the parts (what the plain reference reads); `matrices`
forms the dense K, W1, W2 on the device in float64 as `gun_like` does (K
by the reflectors' rank-one updates, W by one product).  The first start
is drawn from a fresh default_rng(seed), as `benchmarks/gun.py` draws it.

Configuration keys read: n, m0, planted, cluster.
"""

from __future__ import annotations

import numpy as np


def parts(n: int, seed: int, planted: int, cluster) -> dict:
    g = np.random.default_rng(int(seed) % (1 << 64))
    lo, hi = float(cluster[0]), float(cluster[1])
    d = np.concatenate([g.uniform(lo, hi, planted),
                        g.uniform(4.0 * hi, 40.0 * hi, n - planted)])
    vs = []
    for _ in range(4):
        v = g.standard_normal((n, 1))
        v /= np.linalg.norm(v)
        vs.append(v[:, 0])
    wscale = 0.6 / np.sqrt(lo)
    rk = max(4, n // 64)

    def lowrank():
        U = g.standard_normal((n, rk))
        V = g.standard_normal((rk, n))
        s2max = np.linalg.eigvals((U.T @ U) @ (V @ V.T)).real.max()
        return U * (wscale / np.sqrt(s2max)), V

    U1, V1 = lowrank()
    U2, V2 = lowrank()
    return {"d": d, "vs": np.stack(vs), "U": (U1, U2), "V": (V1, V2),
            "s": (0.0, float(np.sqrt(0.8 * lo))), "planted": int(planted)}


def make(config: dict, seed: int, variants: int, delta: float, device=None) -> dict:
    """The seed's problem (its parts on the host) and first start; the
    device plays no part here: `matrices` forms them on it."""
    if variants != 1:
        raise ValueError("gun_planted makes no nearby variants")
    n, m0 = int(config["n"]), int(config["m0"])
    inst = parts(n, seed, int(config["planted"]), config["cluster"])
    g = np.random.default_rng(int(seed) % (1 << 64))
    X0 = g.standard_normal((n, m0)) + 1j * g.standard_normal((n, m0))
    return {"instances": [inst], "first_start": X0}


def matrices(inst: dict, device):
    """(K, W1, W2) dense float64 tensors on `device`."""
    import torch

    K = torch.diag(torch.as_tensor(inst["d"], device=device))
    for v in inst["vs"]:
        v = torch.as_tensor(v, device=device)
        w = K @ v
        vw = float(torch.dot(v, w))
        K.addr_(v, w, alpha=-2.0)
        K.addr_(w, v, alpha=-2.0)
        K.addr_(v, v, alpha=4.0 * vw)
    W = [torch.as_tensor(U, device=device) @ torch.as_tensor(V, device=device)
         for U, V in zip(inst["U"], inst["V"])]
    return K, W[0], W[1]


def isqrt_shift(s: float):
    """z -> i sqrt(z - s^2), principal square root, on complex tensors."""
    import torch

    def f(z):
        return 1j * torch.sqrt(z - s * s)
    return f
