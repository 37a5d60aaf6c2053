"""The dense path through the port's public entry `feast_compiled`.

On the card its sweeps are CUDA graphs, captured by the first call and
replayed by every later one with the same signature.

Configuration keys read: c, r, nodes, iters, tol, mixed_prec.
"""

from __future__ import annotations


def operator(config: dict, inst: dict, device):
    import torch

    return torch.as_tensor(inst["A"], dtype=torch.complex128, device=device)


def solve(config: dict, A, X0, device):
    import feast_tpu_torch as ft

    return ft.feast_compiled(A, X0, c=complex(*config["c"]), r=float(config["r"]),
                             nodes=int(config["nodes"]), iters=int(config["iters"]),
                             tol=float(config["tol"]), mixed_prec=bool(config["mixed_prec"]),
                             device=device)


def outcome(config: dict, res):
    """(the pairs inside the contour on the host, with convergence and
    sweeps; the full (n, m0) Ritz vectors, a restart's next start)."""
    lam, X, _ = res.filtered()
    return ({"lam": lam, "X": X, "converged": bool(res.converged),
             "n_iter": int(res.n_iter)}, res.X)


def release():
    """Drop the cached sweep program: its graphs and its copy of the factors."""
    import feast_tpu_torch as ft

    ft.solvers.clear_graph_cache()
