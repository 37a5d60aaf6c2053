#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (feast_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                 # all phases, needs one CUDA card
    python3 chip_smoke.py --phases k1,k2  # a subset; no kernels/ok lines

Phases, each printing one JSON line:
  build   compile csrc/*.cu for sm_90a (one nvcc per source, in parallel)
  k1      the panel-LU kernel against its plain PyTorch version: 16 slabs of
          (4096, 128) complex64 at j0 = 0 and 1920; whole factors at n = 1024
          and 4096 (16 nodes); timings over 8 panel positions of an n = 4096
          factor, with torch.linalg.lu_factor as a library yardstick
  k2      the Schur kernel against its plain version at n = 2, 48, 128, with
          torch.linalg.eig as a yardstick
  small   feast_compiled on the bench problem at n = 512 against LAPACK
          eigenvalues (numpy)
  main    feast_compiled(mixed_prec=True) on bench.py's problem (n = 4096,
          m0 = 48, 16 trapezoid nodes, tol 1e-10, iters 20): the kernels'
          launch counters are zeroed just before the first run and read
          just after it; then best of 3 walls, each solve timing its own
          factor phase; every inside Ritz pair's residual recomputed on the
          host in float64
  profile two more main-path solves: per driver phase host walls (each phase
          synchronized), then one under torch.profiler for the device busy
          share, kernel launch calls and the kernels with most device time
Then the kernels line ({"kernels": [...]}) and, last, the ok line.  Any
failed check raises, and the script exits non-zero without the ok line.
The script never imports JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
import time

import numpy as np

PHASES = ("k1", "k2", "small", "main", "profile")
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12      # H100 SXM fp32, outside the tensor cores


def emit(obj):
    print(json.dumps(obj), flush=True)


def require(cond, what):
    if not cond:
        raise AssertionError(what)


def bound_ms(nbytes, flops, peak_flops=PEAK_FP32_FLOPS):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, reps=1):
    """Mean device time of fn() over reps, by CUDA events."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bench_problem(n=4096, m0=48, seed=0):
    """bench.py's _problem: diag(1..n) + 0.05 complex noise, c=20, r=22."""
    rng = np.random.default_rng(seed)
    A = np.diag(np.arange(1.0, n + 1.0)).astype(np.complex128)
    A += 0.05 * (rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n)))
    X0 = rng.standard_normal((n, m0)) + 1j * rng.standard_normal((n, m0))
    return A, X0, 20.0 + 0.0j, 22.0


# ---------------------------------------------------------------------------
# K1: panel LU
# ---------------------------------------------------------------------------

def panel_flops(n, b, j0):
    """fp32 operations of one panel factor (pivot search, multipliers,
    rank-1 updates, L11 inverse), 8 per complex multiply-add."""
    f = 0
    for k in range(b):
        below = n - (j0 + k) - 1
        f += 3 * (below + 1) + 6 * below + 8 * below * (b - k - 1)
    f += sum(8 * (b - l - 1) * (l + 1) for l in range(b - 1))
    return f


def phase_k1(torch, panel_lu, dev):
    B, n, b = 16, 4096, 128
    gen = torch.Generator(device=dev).manual_seed(1)
    out = {"phase": "k1"}
    worst = 0.0
    for j0 in (0, 1920):
        base = torch.randn((B, n, b), dtype=torch.complex64, device=dev, generator=gen)
        sk, pk, ik = panel_lu.panel_factor(base.clone(), j0)
        sp, pp, ip = panel_lu.panel_factor_plain(base.clone(), j0)
        torch.cuda.synchronize()
        require(torch.equal(pk, pp), f"k1 j0={j0}: perm differs from the plain version")
        err = float((sk - sp).abs().max())
        inv_err = float((ik - ip).abs().max())
        L11 = torch.tril(sk[:, j0:j0 + b, :], -1) + torch.eye(b, device=dev)
        eye_err = float((ik @ L11 - torch.eye(b, device=dev)).abs().max())
        require(err <= 1e-5 * float(sp.abs().max()), f"k1 j0={j0}: slab err {err}")
        require(eye_err < 1e-4, f"k1 j0={j0}: invL11 L11 - I = {eye_err}")
        out[f"slab_j0_{j0}"] = {"max_abs_err": err, "invL_err": inv_err,
                                "invL_L11_minus_I": eye_err}
        worst = max(worst, err)

    for nn in (1024, 4096):
        A = torch.randn((B, nn, nn), dtype=torch.complex64, device=dev, generator=gen)
        t0 = time.perf_counter()
        LUk, pk = panel_lu.lu_factor_panel(A)
        torch.cuda.synchronize()
        t_kernel = time.perf_counter() - t0
        t0 = time.perf_counter()
        LUp, pp = panel_lu.lu_factor_panel(A, panel=panel_lu.panel_factor_plain)
        torch.cuda.synchronize()
        t_plain = time.perf_counter() - t0
        require(torch.equal(pk, pp), f"k1 n={nn}: factor perm differs from plain")
        t0 = time.perf_counter()
        LUl, pivl = torch.linalg.lu_factor(A)
        torch.cuda.synchronize()
        t_lib = time.perf_counter() - t0
        Pl, Ll, Ul = torch.lu_unpack(LUl[:2], pivl[:2])
        resid = resid_lib = 0.0
        for i in range(2):
            L = (torch.tril(LUk[i], -1) + torch.eye(nn, device=dev)).to(torch.complex128)
            U = torch.triu(LUk[i]).to(torch.complex128)
            PA = A[i][pk[i]].to(torch.complex128)
            nrm = torch.linalg.norm(PA)
            resid = max(resid, float(torch.linalg.norm(PA - L @ U) / nrm))
            R = (A[i].to(torch.complex128) - Pl[i].to(torch.complex128)
                 @ Ll[i].to(torch.complex128) @ Ul[i].to(torch.complex128))
            resid_lib = max(resid_lib, float(torch.linalg.norm(R) / nrm))
        # a complex64 partial-pivoting LU has backward error ~ sqrt(n) eps32
        # times the growth (about 2e-5 at n = 4096): held to the library's
        # factor of the same matrices
        require(resid < 1e-5 or resid < 3 * resid_lib,
                f"k1 n={nn}: ||PA - LU||/||A|| = {resid} (library {resid_lib})")
        del LUl, pivl, Pl, Ll, Ul
        out[f"factor_n{nn}"] = {"batch": B, "rel_resid": resid,
                                "rel_resid_torch_linalg": resid_lib,
                                "max_abs_err_vs_plain": float((LUk - LUp).abs().max()),
                                "kernel_path_s": t_kernel, "plain_path_s": t_plain,
                                "torch_linalg_lu_factor_s": t_lib}
        del A, LUk, LUp

    # timings at the main path's shapes: 8 panel positions of one factor
    Afull = torch.randn((B, n, n), dtype=torch.complex64, device=dev, generator=gen)
    positions = list(range(0, n, 512))
    k_ms, p_ms, l_ms, b_ms = [], [], [], []
    for j0 in positions:
        saved = Afull[:, :, j0:j0 + b].clone()
        view = Afull[:, :, j0:j0 + b]

        def restore():
            view.copy_(saved)

        restore()
        panel_lu.panel_factor(view, j0)            # warm
        restore()
        torch.cuda.synchronize()
        k_ms.append(cuda_ms(lambda: panel_lu.panel_factor(view, j0)))
        restore()
        torch.cuda.synchronize()
        p_ms.append(cuda_ms(lambda: panel_lu.panel_factor_plain(view, j0)))
        sub = saved[:, j0:, :].contiguous()
        torch.linalg.lu_factor(sub)
        torch.cuda.synchronize()
        l_ms.append(cuda_ms(lambda: torch.linalg.lu_factor(sub)))
        # all n rows read once (the slab max behind tiny), rows >= j0 written,
        # perm and the L11 inverse written
        nbytes = B * (n * b * 8 + (n - j0) * b * 8 + n * 4 + b * b * 8)
        b_ms.append(bound_ms(nbytes, B * panel_flops(n, b, j0)))
        restore()
    bounds = [t for t, _ in b_ms]
    # the regime that carries the larger share of the summed per-position bound
    by = {kind: sum(t for t, k in b_ms if k == kind) for kind in ("bytes", "operations")}
    out["timing"] = {"positions_j0": positions, "batch": B, "n": n, "b": b,
                     "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                     "bound_ms": bounds, "bound_by": [k for _, k in b_ms]}
    emit(out)
    del Afull
    torch.cuda.empty_cache()
    return {"name": "panel_lu", "route": "cuda",
            "source": "feast_tpu_torch/csrc/panel_lu.cu",
            "replaces": "feast_tpu/ops/pallas_lu.py:51",
            "max_abs_err": worst, "ms": float(np.mean(k_ms)),
            "plain_ms": float(np.mean(p_ms)), "bound_ms": float(np.mean(bounds)),
            "bound_by": max(by, key=by.get),
            "library_ms": float(np.mean(l_ms))}


# ---------------------------------------------------------------------------
# K2: Schur
# ---------------------------------------------------------------------------

def schur_flops(n, work):
    """fp32 operations of one decomposition with want_y: Householder
    (T from both sides, Z), the sweeps' rotations of T rows, T columns and
    Z columns (12 n complex multiply-adds per unit of active window), and
    the two triangular back-substitutions; 8 per complex multiply-add."""
    hess = sum(6 * n * (n - k - 1) for k in range(max(n - 2, 0)))
    sweeps = 12 * n * work
    back = 2 * sum(t * (t + 1) // 2 for t in range(n))
    return 8 * (hess + sweeps + back)


def _match_err(a, b):
    from scipy.optimize import linear_sum_assignment

    D = np.abs(a[:, None] - b[None, :])
    r, c = linear_sum_assignment(D)
    return float(D[r, c].max())


def phase_k2(torch, schur_kernel, dev):
    out = {"phase": "k2"}
    row = None
    gen = torch.Generator(device=dev).manual_seed(2)
    for n in (2, 48, 128):
        A = torch.randn((n, n), dtype=torch.complex64, device=dev, generator=gen)
        T, Z, Y, X, st = schur_kernel.schur(A, want_y=True, return_stats=True)
        Tp, Zp, Yp, Xp, stp = schur_kernel.schur_plain(A, want_y=True, return_stats=True)
        torch.cuda.synchronize()
        nrm = float(torch.linalg.norm(A))
        eye = torch.eye(n, dtype=A.dtype, device=dev)
        lam_k = torch.diagonal(T).cpu().numpy()
        lam_p = torch.diagonal(Tp).cpu().numpy()
        lam_err = _match_err(lam_k, lam_p)
        checks = {
            "eig_match_err_rel": lam_err / max(float(np.abs(lam_p).max()), 1e-30),
            "AZ_minus_ZT_rel": float(torch.linalg.norm(A @ Z - Z @ T)) / nrm,
            "ZhZ_minus_I": float((Z.mH @ Z - eye).abs().max()),
            "lower_max": float(torch.tril(T, -1).abs().max()),
            "XY_minus_I": float((X @ Y - eye).abs().max()),
            "sweeps": int(st[0]), "plain_sweeps": int(stp[0]),
        }
        tol = 5e-7 * max(n, 8)  # ~ n eps32: rotations accumulate rounding
        require(checks["eig_match_err_rel"] < 1e-4, f"k2 n={n}: eigenvalues {checks}")
        require(checks["AZ_minus_ZT_rel"] < tol, f"k2 n={n}: AZ - ZT {checks}")
        require(checks["ZhZ_minus_I"] < tol, f"k2 n={n}: Z unitary {checks}")
        require(checks["lower_max"] == 0.0, f"k2 n={n}: T not triangular {checks}")
        require(checks["XY_minus_I"] < 1e-3, f"k2 n={n}: XY - I {checks}")
        reps = 20
        k_ms = cuda_ms(lambda: schur_kernel.schur(A, want_y=True), reps)
        p_ms = cuda_ms(lambda: schur_kernel.schur_plain(A, want_y=True), 1)
        torch.linalg.eig(A)
        l_ms = cuda_ms(lambda: torch.linalg.eig(A), 5)
        nbytes = 5 * n * n * 8
        bms, bby = bound_ms(nbytes, schur_flops(n, int(st[1])))
        checks.update({"kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                       "bound_ms": bms, "bound_by": bby})
        out[f"n{n}"] = checks
        if n == 48:  # the main path's shape (m0 = 48)
            row = {"name": "schur", "route": "cuda",
                   "source": "feast_tpu_torch/csrc/schur.cu",
                   "replaces": "feast_tpu/ops/pallas_eig.py:42",
                   "max_abs_err": lam_err, "ms": k_ms, "plain_ms": p_ms,
                   "bound_ms": bms, "bound_by": bby, "library_ms": l_ms}
    emit(out)
    return row


# ---------------------------------------------------------------------------
# the FEAST main path
# ---------------------------------------------------------------------------

def host_residuals(A, res):
    lam, X, _ = res.filtered()
    return lam, np.linalg.norm(A @ X - X * lam[None, :], axis=0)


def phase_small(torch, ft, dev):
    A, X0, c, r = bench_problem(n=512)
    res = ft.feast_compiled(A, X0, c=c, r=r, nodes=16, iters=20, tol=1e-10,
                            mixed_prec=True, device=dev)
    torch.cuda.synchronize()
    lam, rr = host_residuals(A, res)
    ref = np.linalg.eigvals(A)
    ref = ref[np.abs(ref - c) <= r]
    require(res.converged, "small: not converged")
    require(len(lam) == len(ref), f"small: {len(lam)} inside, LAPACK {len(ref)}")
    err = _match_err(lam, ref)
    require(err < 1e-9 and rr.max() < 1e-10, f"small: eig err {err}, res {rr.max()}")
    emit({"phase": "small", "n": 512, "inside": int(len(lam)),
          "iterations": res.n_iter, "eig_err_vs_lapack": err,
          "max_residual": float(rr.max())})


def phase_main(torch, ft, dev, reps=3):
    panel_lu = importlib.import_module("feast_tpu_torch.ops.panel_lu")
    schur_kernel = importlib.import_module("feast_tpu_torch.ops.schur_kernel")
    fmod = importlib.import_module("feast_tpu_torch.solvers.feast")
    A, X0, c, r = bench_problem()
    At = torch.as_tensor(A, device=dev)
    Xt = torch.as_tensor(X0, device=dev)
    kw = dict(c=c, r=r, nodes=16, iters=20, tol=1e-10, mixed_prec=True, device=dev)
    torch.cuda.synchronize()

    panel_lu.launches = 0
    schur_kernel.launches = 0
    t0 = time.perf_counter()
    res = ft.feast_compiled(At, Xt, **kw)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    launches = {"panel_lu": panel_lu.launches, "schur": schur_kernel.launches}

    # each timed solve also times its own factor phase (node matrices, panel
    # LU, diagonal inverses), synchronized at its end
    factor_scan = fmod._factor_scan
    walls, factors = [], []

    def timed_factor(*a, **k):
        t0 = time.perf_counter()
        out = factor_scan(*a, **k)
        torch.cuda.synchronize()
        factors.append(time.perf_counter() - t0)
        return out

    fmod._factor_scan = timed_factor
    try:
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = ft.feast_compiled(At, Xt, **kw)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    finally:
        fmod._factor_scan = factor_scan
    require(len(factors) == reps, f"main: {len(factors)} factor phases in {reps} solves")
    i_best = int(np.argmin(walls))
    best, factor_s = walls[i_best], factors[i_best]

    lam, rr = host_residuals(A, res)
    require(res.converged, "main: not converged")
    require(len(lam) >= 1, "main: no eigenvalue inside")
    require(np.isfinite(rr).all() and rr.max() < 1e-10,
            f"main: host residual {rr.max()}")
    require(launches["panel_lu"] > 0 and launches["schur"] > 0,
            f"main: kernel launches {launches}")
    emit({"phase": "main", "n": 4096, "m0": 48, "nodes": 16, "tol": 1e-10,
          "inside": int(len(lam)), "iterations": res.n_iter,
          "max_residual_host_f64": float(rr.max()), "warmup_wall_s": warm,
          "walls_s": walls, "factors_s": factors, "best_wall_s": best,
          "factor_s": factor_s,
          "sweeps_s": best - factor_s,
          "per_sweep_s": (best - factor_s) / max(res.n_iter, 1),
          "launches_per_solve": launches,
          "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9})
    return launches


def phase_profile(torch, ft, dev):
    """Two more main-path solves: one with each driver phase wrapped in a
    synchronized host timer (factor, orthonormalization, Rayleigh-Ritz and
    its small eig, node update), one under torch.profiler for the device
    busy share, the kernel launch calls and the kernels with the most
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fmod = importlib.import_module("feast_tpu_torch.solvers.feast")
    A, X0, c, r = bench_problem()
    At, Xt = torch.as_tensor(A, device=dev), torch.as_tensor(X0, device=dev)
    kw = dict(c=c, r=r, nodes=16, iters=20, tol=1e-10, mixed_prec=True, device=dev)

    phases = {}
    wrapped = [(fmod, "_factor_scan"), (fmod.qrmod, "orthonormalize"),
               (fmod, "_rayleigh_ritz"), (fmod.eigmod, "eig"),
               (fmod, "_node_update_scan")]
    saved = [getattr(m, name) for m, name in wrapped]

    def timer(fn, name):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            tot, cnt = phases.get(name, (0.0, 0))
            phases[name] = (tot + time.perf_counter() - t0, cnt + 1)
            return out
        return run

    ft.feast_compiled(At, Xt, **kw)            # warm: library handles, caches
    for (m, name), fn in zip(wrapped, saved):
        setattr(m, name, timer(fn, name))
    try:
        t0 = time.perf_counter()
        ft.feast_compiled(At, Xt, **kw)
        torch.cuda.synchronize()
        wall_timed = time.perf_counter() - t0
    finally:
        for (m, name), fn in zip(wrapped, saved):
            setattr(m, name, fn)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ft.feast_compiled(At, Xt, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in prof.key_averages() if e.key == "cudaLaunchKernel")
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    emit({"phase": "profile", "timed_wall_s": wall_timed,
          "phase_wall_s": {k: {"s": v[0], "calls": v[1]} for k, v in phases.items()},
          "profiled_wall_s": wall, "device_busy_s": busy_us / 1e6,
          "device_idle_share": 1.0 - busy_us / 1e6 / wall,
          "cuda_launch_calls": launches, "kernel_count": sum(e.count for e in kernels),
          "top_kernels_ms": [[e.key[:70], e.count, e.self_device_time_total / 1e3]
                             for e in top]})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma list; the kernels and ok lines need all of them")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    if phases - set(PHASES):
        ap.error(f"unknown phases {sorted(phases - set(PHASES))}; known: {PHASES}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card only",
              file=sys.stderr)
        return 2
    import feast_tpu_torch as ft
    from feast_tpu_torch.kernels import _build
    from feast_tpu_torch.ops import panel_lu, schur_kernel

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    built = _build.build()
    emit({"phase": "build", "wall_s": time.perf_counter() - t0, "per_source_s": built,
          "ptxas": {name: [ln.strip() for ln in _build.build_log(name).splitlines()
                           if "registers" in ln or "smem" in ln]
                    for name in _build.SOURCE_FLAGS},
          "torch": torch.__version__, "cuda": torch.version.cuda})

    rows = []
    if "k1" in phases:
        rows.append(phase_k1(torch, panel_lu, dev))
    if "k2" in phases:
        rows.append(phase_k2(torch, schur_kernel, dev))
    if "small" in phases:
        phase_small(torch, ft, dev)
    launches = None
    if "main" in phases:
        torch.cuda.reset_peak_memory_stats(dev)
        launches = phase_main(torch, ft, dev)
    if "profile" in phases:
        phase_profile(torch, ft, dev)
    if phases != set(PHASES):
        return 0
    for row in rows:
        row["launches"] = launches[row["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: row[k] for k in keys} for row in rows]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
