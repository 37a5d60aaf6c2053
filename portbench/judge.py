"""The comparison that decides `correct`.

Every solve the window drove returned the eigenpairs it found inside the
contour.  The plain reference of the configuration (`reference/<name>.py`,
numpy and torch only) works out, from the benchmark's own inputs, for each
instance (`ctx = prepare(config, inst, device)`):

  eigenvalues(ctx)        every eigenvalue inside the contour
  residuals(ctx, lam, X)  the residual of each pair as the configuration's
                          tolerance defines it
  control(ctx)            (lam, X): the reference one precision down, the
                          control that has to come out as not correct

and the judge reduces the solves to four numbers, each held to the limit
in the configuration's `limits`:

  count_off    sum over solves of |pairs returned - eigenvalues inside|
  unconverged  solves that reported no convergence
  eig_err      largest distance from a returned eigenvalue to the nearest
               reference eigenvalue, or from a reference eigenvalue to the
               nearest returned one (the Hausdorff distance), over solves
  residual     largest residual of a returned pair, over solves

A number passes when it is at most its limit; NaN passes nothing.
"""

from __future__ import annotations

import math

import numpy as np

NUMBERS = ("count_off", "unconverged", "eig_err", "residual")


def hausdorff(a: np.ndarray, b: np.ndarray) -> float:
    if len(a) == 0 and len(b) == 0:
        return 0.0
    if len(a) == 0 or len(b) == 0:
        return math.inf
    d = np.abs(np.asarray(a)[:, None] - np.asarray(b)[None, :])
    return float(max(d.min(axis=1).max(), d.min(axis=0).max()))


def compare(reference, config: dict, instances: list, outcomes: list, device) -> dict:
    """The four numbers of `outcomes` (dicts with instance, lam, X,
    converged) against `reference` on `instances`."""
    ctx, ref_lam = {}, {}
    count_off = unconverged = 0
    eig_err = residual = 0.0
    for out in outcomes:
        k = out["instance"]
        if k not in ctx:
            ctx[k] = reference.prepare(config, instances[k], device)
            ref_lam[k] = np.asarray(reference.eigenvalues(ctx[k]))
        lam = np.asarray(out["lam"])
        count_off += abs(len(lam) - len(ref_lam[k]))
        unconverged += not out["converged"]
        eig_err = max(eig_err, hausdorff(lam, ref_lam[k]))
        if len(lam):
            r = np.asarray(reference.residuals(ctx[k], lam, out["X"]))
            worst = float(np.max(r)) if np.all(np.isfinite(r)) else math.inf
            residual = max(residual, worst)
    return {"count_off": count_off, "unconverged": unconverged,
            "eig_err": eig_err, "residual": residual}


def checks(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} in the order of NUMBERS."""
    return {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS}


def passed(checks_: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks_.values())
