"""The nonlinear path through the port's public entry `nlfeast`.

The operator is the port's `SPMF` of the problem's dense matrices,

    T(z) = K * 1 + I * (-z) + W1 * i sqrt(z - s1^2) + W2 * i sqrt(z - s2^2),

held in complex128 on the card as `problems.gun_like` holds it.

Configuration keys read: problem, c, r, nodes, iters, tol, spurious,
mixed_prec, store.
"""

from __future__ import annotations


def operator(config: dict, inst: dict, device):
    import torch

    import feast_tpu_torch as ft
    from portbench.harness import load

    problem = load("problems", config["problem"])
    K, W1, W2 = problem.matrices(inst, device)
    n = K.shape[0]
    eye = torch.eye(n, dtype=torch.complex128, device=device)
    s1, s2 = inst["s"]
    terms = [(K, torch.ones_like), (eye, torch.neg), (W1, problem.isqrt_shift(s1)),
             (W2, problem.isqrt_shift(s2))]
    return ft.SPMF(terms, device=device)


def solve(config: dict, T, X0, device):
    import feast_tpu_torch as ft

    return ft.nlfeast(T, X0, nodes=int(config["nodes"]), iters=int(config["iters"]),
                      c=complex(*config["c"]), r=float(config["r"]),
                      tol=float(config["tol"]), spurious=float(config["spurious"]),
                      mixed_prec=bool(config["mixed_prec"]), store=bool(config["store"]),
                      device=device)


def outcome(config: dict, res):
    """(the non-spurious pairs inside the contour on the host; the full
    vectors)."""
    lam, X, _ = res.filtered(spurious=float(config["spurious"]))
    return ({"lam": lam, "X": X, "converged": bool(res.converged),
             "n_iter": int(res.n_iter)}, res.X)


def release():
    pass
