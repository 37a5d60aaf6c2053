"""Thin complex SVD by a QR reduction and parallel one-sided Jacobi.

Counterpart of `feast_tpu/ops/svd.py`.  The (n, m) input is reduced to an
(m, m) factor (CholeskyQR3, Householder, or nothing: "direct"), then
one-sided Jacobi rotates column pairs in the round-robin order: each of
the m - 1 rounds of a sweep rotates its m/2 disjoint pairs as one batched
tensor operation (gather the pairs, 2x2 rotations, scatter back), so a
sweep is m - 1 rounds of a few dozen launches, not m^2/2 rotations one at
a time.  The singular values are the column norms; U is the normalized
columns (times the QR factor), columns below s_max * eps / 100 zeroed.
Sweeps stop when the worst relative cosine |p^H q| / (|p| |q|) of a sweep
is below 10 eps (one host read per sweep), or after max_sweeps.

One-sided Jacobi keeps small singular values to high relative accuracy,
which the rank cuts of the Beyn and block-SS extractions rely on.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import cx
from ..utils import tracing
from . import qr as qrmod


def _round_robin_pairs(m: int) -> np.ndarray:
    """(m - 1, 2, m // 2) round-robin tournament schedule for even m."""
    players = list(range(m))
    steps = []
    for _ in range(m - 1):
        p = np.array(players[: m // 2])
        q = np.array(players[m // 2:][::-1])
        steps.append(np.stack([p, q]))
        players = [players[0]] + [players[-1]] + players[1:-1]
    return np.stack(steps)


def _jacobi_sweeps(R: torch.Tensor, max_sweeps: int = 30):
    """One-sided Jacobi on an (n, m) matrix, m even: returns (B, V) with
    R = B V^H and B's columns orthogonal.

    B and V are rotated as one stacked (n + m, m) matrix: the same rotation
    of the same column pair, so each element takes the same arithmetic.
    Span: "svd.jacobi" around the sweeps, with their count ("sweeps")."""
    n, m = R.shape
    if m % 2:
        raise ValueError("pad to an even column count before calling")
    sched = torch.as_tensor(_round_robin_pairs(m), device=R.device)
    rdt = cx.real_dtype(R.dtype)
    eps = torch.finfo(rdt).eps
    BV = torch.cat([R, torch.eye(m, dtype=R.dtype, device=R.device)])
    it = 0
    with tracing.span("svd.jacobi", R.device) as sp:
        while True:
            worst = []
            for p, q in sched:
                bp, bq = BV[:, p], BV[:, q]
                app = torch.sum(cx.abs2(bp[:n]), dim=0)
                aqq = torch.sum(cx.abs2(bq[:n]), dim=0)
                apq = cx.cdot_cols(bp[:n], bq[:n])
                absapq = cx.cabs(apq)
                # sqrt(app) sqrt(aqq), not sqrt(app aqq), as the JAX package
                norm_pq = torch.sqrt(app) * torch.sqrt(aqq)
                active = absapq > eps * norm_pq * 0.1
                tau = (aqq - app) / (2.0 * torch.where(active, absapq, 1.0))
                sgn = torch.where(tau >= 0.0, 1.0, -1.0)
                abs_tau = torch.abs(tau)
                big = abs_tau > 1e12
                tau_c = torch.where(big, 0.0, tau)
                t = torch.where(big, sgn / (2.0 * torch.clamp(abs_tau, min=1.0)),
                                sgn / (torch.abs(tau_c) + torch.sqrt(1.0 + tau_c * tau_c)))
                t = torch.where(active, t, 0.0)
                c = 1.0 / torch.sqrt(1.0 + t * t)
                s = cx.phase(apq) * (c * t)
                BV[:, p] = bp * c - bq * s.conj()
                BV[:, q] = bp * s + bq * c
                worst.append(torch.max(torch.where(
                    norm_pq > 0, absapq / torch.where(norm_pq > 0, norm_pq, 1.0), 0.0)))
            it += 1
            if not (float(torch.max(torch.stack(worst))) > 10.0 * eps and it < max_sweeps):
                break
        sp.set("sweeps", it)
    return BV[:n], BV[n:]


def svd(A: torch.Tensor, max_sweeps: int = 30, reduce: str = "cholqr3"):
    """Thin SVD of (n, m), n >= m: (U (n, m), s (m,) descending, Vh (m, m))
    with A = U diag(s) Vh, as numpy's svd(full_matrices=False).

    reduce: "cholqr3" (default; absolute accuracy ~eps s_max), "householder"
    or "direct" (Jacobi on A itself: small singular values keep high
    relative accuracy)."""
    n, m = A.shape
    if n < m:
        raise ValueError("svd expects n >= m (tall or square input)")
    if reduce not in ("cholqr3", "householder", "direct"):
        raise ValueError(f"unknown reduce {reduce!r}")
    pad = m % 2                       # the schedule needs an even column count
    if pad:
        A = torch.nn.functional.pad(A, (0, 1))
        m += 1
        if n < m and reduce != "direct":   # odd square input: a zero row too
            A = torch.nn.functional.pad(A, (0, 0, 0, m - n))
    if reduce == "direct":
        B, V = _jacobi_sweeps(A, max_sweeps)
    else:
        Qq, R = (qrmod.householder_qr(A) if reduce == "householder"
                 else qrmod.cholqr3(A))
        B, V = _jacobi_sweeps(R, max_sweeps)
    s = cx.col_norms(B)
    order = torch.argsort(-s, stable=True)
    s, B, V = s[order], B[:, order], V[:, order]
    eps = torch.finfo(s.dtype).eps
    smax = torch.clamp(s[0], min=eps)
    Ur = B / torch.where(s > smax * eps * 0.01, s, 1.0)
    U = Ur if reduce == "direct" else Qq @ Ur
    if pad:
        # the zero column's sigma 0 sorts last and its right vector is e_m
        m -= 1
        U, s, V = U[:n, :m], s[:m], V[:m, :m]
    return U, s, V.mH.resolve_conj()


def svd_vals(A: torch.Tensor, max_sweeps: int = 30) -> torch.Tensor:
    """Singular values only."""
    return svd(A, max_sweeps=max_sweeps)[1]
