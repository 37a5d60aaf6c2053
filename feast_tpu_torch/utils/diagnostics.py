"""Observability: convergence summaries, rational-filter inspection and
phase timing.

Counterpart of `feast_tpu/utils/diagnostics.py`; takes numpy arrays or
tensors on any device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from .. import contour as ct


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def convergence_info(lam, X, residuals, contour: ct.Contour,
                     spurious: float = 1e-3) -> Dict:
    """Counts inside the contour and non-spurious (residual < spurious),
    and the largest residuals among them."""
    lam = _host(lam)
    res = _host(residuals)
    inside = np.asarray(ct.in_contour(lam, contour))
    res_in = res[inside]
    non_spur = res_in[res_in < spurious]
    return {
        "inside": int(inside.sum()),
        "non_spurious": int((res_in < spurious).sum()),
        "max_res_inside": float(res_in.max()) if inside.any() else None,
        "max_res_non_spurious": float(non_spur.max()) if len(non_spur) else None,
        "min_res": float(res.min()) if len(res) else None,
    }


def print_convergence_info(lam, X, residuals, contour: ct.Contour,
                           spurious: float = 1e-3) -> None:
    info = convergence_info(lam, X, residuals, contour, spurious)
    print(f"eigenvalues inside contour:       {info['inside']}")
    print(f"  of which non-spurious (<{spurious:g}): {info['non_spurious']}")
    if info["max_res_inside"] is not None:
        print(f"max residual inside:              {info['max_res_inside']:.3e}")
    if info["max_res_non_spurious"] is not None:
        print(f"max non-spurious residual:        {info['max_res_non_spurious']:.3e}")


def filter_quality(contour: ct.Contour, n_grid: int = 200) -> Dict:
    """The rational filter's worst error inside (on the circle of radius
    r/2) and its largest magnitude on the circles of radius 2r and 4r."""
    c, r = contour.center, contour.radius
    theta = np.linspace(0, 2 * np.pi, n_grid, endpoint=False)
    ring = np.exp(1j * theta)
    return {
        "max_inside_error": float(np.max(np.abs(
            ct.rational_func(c + 0.5 * r * ring, contour) - 1.0))),
        "max_at_2r": float(np.max(np.abs(ct.rational_func(c + 2.0 * r * ring, contour)))),
        "max_at_4r": float(np.max(np.abs(ct.rational_func(c + 4.0 * r * ring, contour)))),
    }


@dataclasses.dataclass
class PhaseTimer:
    """Wall time per phase, with throughput when the phase names its work.
    Host wall clock: synchronize the card before `stop` to time its work."""

    records: List[Dict] = dataclasses.field(default_factory=list)
    _t0: Optional[float] = None
    _phase: Optional[str] = None
    _work: float = 0.0

    def start(self, phase: str, work_units: float = 0.0):
        self._phase = phase
        self._work = work_units
        self._t0 = time.perf_counter()

    def stop(self):
        dt = time.perf_counter() - self._t0
        rec = {"phase": self._phase, "wall_s": dt}
        if self._work:
            rec["units_per_s"] = self._work / dt
        self.records.append(rec)
        return rec

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for r in self.records:
            out[r["phase"]] = out.get(r["phase"], 0.0) + r["wall_s"]
        return out
