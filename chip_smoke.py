#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (feast_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py                 # all phases, needs one CUDA card
    python3 chip_smoke.py --phases k3,k4  # a subset; no kernels/ok lines
    python3 chip_smoke.py --phases k2,k4 --baseline DIR
                                          # K2 and K4 of the checkout in DIR
                                          # timed beside these, in turns

Phases, each printing one JSON line:
  build   compile csrc/*.cu for sm_90a (one nvcc per source, in parallel)
  k1      the panel-LU cluster kernel: its launch plan (cluster size, sub-panel
          width, clusters that fit) against the host mirror; bit for bit
          against its plain PyTorch version on 16 slabs of (4096, 128)
          complex64 at j0 = 0 and 1920; whole factors at n = 1024 and 4096
          (16 nodes); timings over 8 panel positions of an n = 4096 factor,
          with torch.linalg.lu_factor as a library yardstick; the row swap
          kernel (csrc/row_swap.cu) at every panel position of that factor
          on K1's permutation, bit for bit its plain version (the gather),
          timed beside it and its bound by bytes; the zero-padded
          route at the nonlinear path's n = 9956 (padded to 9,984, 4 nodes)
          bit for bit against the plain version on the padded matrix, and
          its launches timed at the first and the last two panels; the same
          route bit for bit and timed at the unstructured path's dense coarse
          level (n = 447, padded to 512, one node); and one node (a batch of
          one, the node loop's launch) timed at the 8 positions of n = 4096
  k2      the Schur kernel against its plain version at n = 2, 8 (the sparse
          path's m0), 10 (the unstructured path's), 48 (the dense path's) and
          84 (the nonlinear path's),
          and at 128 against LAPACK's eigenvalues: invariants, sweeps and
          rotation steps, ptxas registers, with torch.linalg.eig as a
          yardstick; then its time and invariants at n = 64, 96, 112 and at
          entries scaled by 1e-20 and 1e18; and the stacked slices' launch, a
          batch of 4 matrices of n = 42, against the plain version, 4
          launches of one matrix and batched torch.linalg.eig
  k3      the complex64 tensor-core (3xTF32) matrix-product kernel against its
          plain version (three real fp32 matmuls on the planes, Karatsuba) and
          complex128 at (256, 256, 256), (300, 130, 384)
          and the dense path's shapes (3968 x 128 x 3968 and 128 x 128 x 48,
          batch 16), with torch.matmul on complex64 as a yardstick; its
          update form in place (C <- C - L21 U12 on a factor buffer's views)
          at the first trailing update of the cells' factors (16 x 10240,
          4 x 20480, 4 x 9984) against complex128 and cuBLAS's baddbmm_,
          timed beside baddbmm_ and its bound (C read and written); then
          feast_compiled with cx.set_gemm_backend("cuda"): at n = 1024 against
          LAPACK eigenvalues, and on the main path's problem (n = 4096), whose
          factor gives the kernel the timed shapes, counting its launches
  k4      the DIA sparse-product kernel against its plain version (shifted
          slices) on four small band structures, at the two DIA levels of the
          sparse path (9 diagonals of the 1000 x 1000 grid pencil, n = 1e6;
          21 diagonals, n = 167,000; m = 8, 8 nodes) and at m = 3 on a ragged
          n; ptxas registers, GB/s and bound, with torch.sparse CSR as a
          yardstick
  diag_inv  the diagonal-block inverses (ops/lu.py::lu_diag_inv, blocks of
          512) on K1's factors of random matrices at the benchmark's shapes:
          16 x 10240 (dense), 4 x 9956 (the gun's chunk, padded to 9,984),
          4 x 20480 (a rank of the four-card cell): the tile kernel
          (csrc/diag_inv.cu) alone, the kernel route (the kernel and the
          doubling) and the plain substitution, each in device ms, host
          wall, launch calls and temporaries; the kernel's tiles of two
          matrices against the plain tile step's (`tiles_plain`: copied
          tiles equal, inverted ones within 1e-5), the route's and the
          complex64 substitution's inverses against the substitution in
          complex128 (1e-4); the kernel's bound by bytes, the route's by
          the operations a triangular inverse needs
  small   feast_compiled on the bench problem at n = 512 against LAPACK
          eigenvalues (numpy)
  main    feast_compiled(mixed_prec=True) on bench.py's problem (n = 4096,
          m0 = 48, 16 trapezoid nodes, tol 1e-10, iters 20), its sweeps CUDA
          graphs: the kernels' launch counters are zeroed just before the
          first (cold) run and read just after it; then best of 3 walls,
          each solve timing its own factor phase; every inside Ritz pair's
          residual recomputed on the host in float64; the same steps run
          eagerly (`_feast_compiled_steps`) once, their K1, K2 and
          diagonal-inverse kernel launches and iterations equal to the
          graphs'
  compiled_graph  the graphs against the same steps run eagerly on main's
          problem and on a B pencil (I + a Hermitian perturbation) at the
          same n: 3 warm eager solves, then the graphs' cold wall, capture
          and instantiation seconds and 3 warm solves (one route after the
          other: the card holds one program); graph replays per solve; one
          warm graph solve under torch.profiler (launch calls, device idle
          share, top kernels), held on main's problem to the profile
          phase's trace of the eager steps, and the cost of the host's
          status read a sweep; the same iterations, sweeps per tier and
          inside count, eigenvalues within 1e-12 relative, host residuals
          below 1e-10, equal K1 and K2 launches, peak memory and the cached
          program's, and the graphs' launch calls at most 5% of the eager
          steps'
  profile the sweep program's steps run eagerly, with per driver phase host
          walls (each phase synchronized), then once under torch.profiler
          (device idle share, launch calls, top kernels)
  sparse  feast_iterative on the 1M-dof generalized grid pencil (K = T (+) T
          5-point stiffness, B = M (x) M 9-point mass, N = 1000, lowest slice,
          m0 = 8, 8 nodes, AMG on strength aggregates with a complex64 V-cycle,
          bicgstab_rr): the DIA kernel's launches counted over the solve and
          by level (each DIA level's offsets, and every level's A, P and R
          format and block size, printed), eigenvalues against the
          exact separable spectrum, residuals recomputed on the host with
          scipy in float64; and a Jacobi-preconditioned complex64 Krylov
          solve at N = 200 that launches the DIA kernel outside AMG
  sparse_profile  one more sweep of the sparse path with per-phase host walls
          (Rayleigh-Ritz, node solves, V-cycle share), and one under
          torch.profiler: device busy share, the DIA kernel's device time and
          share, top kernels
  dense_variants  feast(store=True, mixed_prec=True) on the main phase's
          problem, stacked, then with node_loop=True and with rr="host", each
          held to the stacked solve (the same iterations, eigenvalues to
          1e-10); hermitian=True on diag(1..n) + 0.05 (G + G^H) / 2 against
          numpy's eigvalsh; dual_gen_feast(mixed_prec=True) with B = I, right
          and left residuals on the host in float64 (below 1e-10 and 1e-8);
          the panel and Schur kernels' launches and the wall of each case
  panel_backend  the factor's two panel routes (`ops.lu.set_panel_backend`)
          held against each other and timed, in turns, best of 3: "pallas"
          (K1) and "xla" (the plain blocked loop on the card) on the main
          path's 16 node matrices of n = 4096 (32 K1 launches, then 0), and
          once each on one chunk of the gun's node matrices (4 of n = 9956,
          zero-padded to 9,984 on K1: 78 launches, then 0); each route's
          backward error ||PA - LU|| / ||A|| within 3x
          torch.linalg.lu_factor_ex's; then feast_compiled on the main
          problem under "xla": converged, main's inside count and
          eigenvalues (1e-10 relative), host residuals below 1e-10, no K1
          launch; the backend restored to "pallas" at the end
  fastdiag  the sparse phase's 1M-dof pencil and slice with the
          fast-diagonalization preconditioner (form "kron", float32
          transforms) in place of AMG: setup and solve seconds, sweeps,
          BiCGStab iterations per node and sweep, the checks of the sparse
          phase
  unstructured  benchmarks/unstructured100k.py in process: the P1 FEM pencil
          on 100,000 random points (n = 99,975), lowest slice, m0 = 10, 8
          nodes, reorder "auto" (RCM, then BELL), AMG with a complex64
          V-cycle, node_chunk 1; converged, the exact slice's count (scipy
          eigsh), eigenvalues to 1e-9 relative, host residuals below 1e-10;
          each AMG level's format, and the level-0 BELL product's ms at every
          candidate block size beside the port's CSR product and
          torch.sparse.mm on complex64 CSR
  orchestrate  the unstructured configuration through the checkpointing
          orchestrator (benchmarks/unstructured100k.py's default mode):
          worker subprocesses on the card, the first killed after chunk 3
          of sweep 1; exactly one restart, resumed at chunk 4, and the
          in-process result (sweeps, inside count, eigenvalues to 1e-10
          relative); the wall of the run and of each worker
  parallel  the mesh= layer over NCCL, one rank per card (world size 1 in
          process on one card): first the JAX spellings (its own JSON
          line, "parallel_surface"): orthonormalize and cholqr2 with
          psum_axis="row" on a ("node", "row") mesh bound by bind_mesh at
          the headline's shape (4096 x 48 complex128), gathered, against
          the unsharded call to 1e-13 relative; cmatmul(precision=
          "default") bit for bit cmatmul under both GEMM backends;
          shard_nodes and replicate of a nested tuple; then
          feast_compiled on the headline, its sweeps
          graphs with the node all-reduce captured, after 3 calls of its
          steps run eagerly under the same mesh, then cold and 3 warm: bit
          for bit the eager steps, main's eigenvalues to 1e-12 and
          iterations; then
          feast_iterative on the 1M pencil with fastdiag against fastdiag;
          feast_sliced and feast_sliced_parallel on dense_variants'
          Hermitian matrix over (0.5, 100.5) in 4 slices: the stacked
          slices' program of graphs (mixed_prec) cold, then 3 warm calls,
          then its steps run eagerly once, each call split into the
          stochastic count, the factor and the loop; per slice the eager
          steps' sweeps, convergence and bits; one K2 launch a batched
          sweep; the factor's and the
          loop's peak within the store and its 4 GiB temporaries; the status read's ms a sweep, capture seconds,
          launch calls of two sweeps of replays under the profiler and the
          bytes the cached program holds; then the full-precision call (as the
          JAX package runs it) on the graphs; every call exactly
          eigvalsh's eigenvalues, host residuals below 1e-10, and each
          slice's sweeps, convergence and dropped (unconverged) residuals;
          feast_iterative_rows (node_chunk 1) on the unstructured pencil
          with the row-sharded AMG against unstructured; each call's wall,
          peak memory and K1 and K2 launches (K1 where the call factors in
          complex64: fastdiag factors nothing, the full-precision slices
          factor in complex128)
  nonlinear  the reference's gun configuration: gun_like(9956, seed=0,
          planted=25) built on the card, then nlfeast(mixed_prec=True,
          store=False; 16 nodes, c=105, r=8, m0=84, tol 1e-10) from
          benchmarks/gun.py's X0, one cold and one warm solve and one with
          each driver phase timed (evaluate, factor, solve and refine,
          extract), one under torch.profiler (device busy share, kernel
          launches; the extraction's alone); the panel and Schur kernels'
          launches counted over the cold solve; 25 non-spurious eigenvalues
          inside, each residual recomputed on the host in float64 from the
          parts
  nonlinear_small  beyn and block_ss (32 nodes) and nlfeast_moments on
          gun_like(2048) against nlfeast there (1e-8); companion on
          butterfly(6) (N L = 144) against scipy's eigenvalues of the pencil;
          contour_estimate_eig(mixed_prec=True) on the main phase's matrix
          against the count inside
Then the kernels line ({"kernels": [...]}) and, last, the ok line.  Any
failed check raises, and the script exits non-zero without the ok line.
The script never imports JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import subprocess
import sys
import time

import numpy as np

PHASES = ("k1", "k2", "k3", "k4", "diag_inv", "small", "main", "profile", "compiled_graph",
          "dense_variants",
          "panel_backend", "sparse", "sparse_profile", "fastdiag", "unstructured", "orchestrate",
          "parallel", "nonlinear", "nonlinear_small")
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
PEAK_FP32_FLOPS = 67e12      # H100 SXM fp32, outside the tensor cores
PEAK_TF32_FLOPS = 495e12     # H100 SXM TF32 tensor cores, dense


def emit(obj):
    print(json.dumps(obj), flush=True)


def require(cond, what):
    if not cond:
        raise AssertionError(what)


def bound_ms(nbytes, flops, peak_flops=PEAK_FP32_FLOPS):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_summary(_build, name):
    """nvcc -Xptxas -v lines (registers, shared memory, spills) of a source."""
    return [ln.strip() for ln in _build.build_log(name).splitlines()
            if "registers" in ln or "smem" in ln or "spill" in ln]


def sass_count(_build, name, opcode):
    """How many instructions of `opcode` the built library's SASS holds
    (cuobjdump from the toolkit); None where the toolkit has no cuobjdump."""
    import os
    import shutil

    exe = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    exe = exe if os.path.exists(exe) else shutil.which("cuobjdump")
    if exe is None:
        return None
    sass = subprocess.run([exe, "-sass", str(_build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    return sum(opcode in ln for ln in sass.splitlines())


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
    from feast_tpu_torch.kernels import _build

    B, n, b = 16, 4096, 128
    gen = torch.Generator(device=dev).manual_seed(1)
    out = {"phase": "k1", "ptxas": ptxas_summary(_build, "panel_lu")}
    # the launch plan at the main path's panel positions: cluster size C,
    # sub-panel width w, and the clusters of C = 1, 2, 4, 8 that fit at once
    plans = {}
    for j0 in (0, 1920, n - b):
        plan = panel_lu.card_plan(n, b, j0, B)
        fits = plan["fits"]
        host = panel_lu.launch_plan(n, b, j0, B, lambda C, smem: fits[C])
        require(host == {k: v for k, v in plan.items() if k != "fits"},
                f"k1 j0={j0}: card plan {plan} differs from the host mirror {host}")
        plans[f"j0_{j0}"] = plan
    out["plan"] = plans
    worst = 0.0
    for j0 in (0, 1920):
        base = torch.randn((B, n, b), dtype=torch.complex64, device=dev, generator=gen)
        sk, pk, ik = panel_lu.panel_factor(base.clone(), j0)
        sp, pp, ip = panel_lu.panel_factor_plain(base.clone(), j0)
        torch.cuda.synchronize()
        require(torch.equal(pk, pp), f"k1 j0={j0}: perm differs from the plain version")
        # every element takes the plain version's rounded operations in its
        # order (no fused multiply-add): bit for bit
        require(torch.equal(sk, sp), f"k1 j0={j0}: slab not bit-equal to the plain version")
        require(torch.equal(ik, ip), f"k1 j0={j0}: invL11 not bit-equal to the plain version")
        err = float((sk - sp).abs().max())
        inv_err = float((ik - ip).abs().max())
        L11 = torch.tril(sk[:, j0:j0 + b, :], -1) + torch.eye(b, device=dev)
        eye_err = float((ik @ L11 - torch.eye(b, device=dev)).abs().max())
        require(err <= 1e-5 * float(sp.abs().max()), f"k1 j0={j0}: slab err {err}")
        require(eye_err < 1e-4, f"k1 j0={j0}: invL11 L11 - I = {eye_err}")
        out[f"slab_j0_{j0}"] = {"max_abs_err": err, "invL_err": inv_err,
                                "bit_equal": True, "invL_L11_minus_I": eye_err}
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
    t = [panel_timing(torch, panel_lu, Afull, j0, b) for j0 in positions]
    # the regime that carries the larger share of the summed per-position bound
    by = {kind: sum(x["bound_ms"] for x in t if x["bound_by"] == kind)
          for kind in ("bytes", "operations")}
    out["timing"] = {"positions_j0": positions, "batch": B, "n": n, "b": b}
    out["timing"].update({k: [x[k] for x in t] for k in t[0]})
    k_ms, p_ms, l_ms, bounds = (out["timing"][k] for k in
                                ("kernel_ms", "plain_ms", "library_ms", "bound_ms"))
    # a batch of one at the same positions: the node loop's 512 launches
    t1 = [panel_timing(torch, panel_lu, Afull[:1], j0, b) for j0 in positions]
    out["timing_batch1"] = {k: [x[k] for x in t1] for k in t1[0]}
    out["timing_batch1"].update({f"mean_{k}": float(np.mean([x[k] for x in t1]))
                                 for k in ("kernel_ms", "plain_ms", "library_ms",
                                           "bound_ms")})
    del Afull
    torch.cuda.empty_cache()
    out["row_swap"] = row_swap_timing(torch, panel_lu, dev, gen, B, n, b)
    torch.cuda.empty_cache()
    out["padded_gun"] = k1_padded(torch, panel_lu, dev, gen)
    # the unstructured phase's coarse level: 447 columns, one node a launch
    out["padded_coarse_447"] = k1_padded(torch, panel_lu, dev, gen, B=1, n=447)
    emit(out)
    return {"name": "panel_lu", "route": "cuda",
            "source": "feast_tpu_torch/csrc/panel_lu.cu",
            "replaces": "feast_tpu/ops/pallas_lu.py:51",
            "max_abs_err": worst, "ms": float(np.mean(k_ms)),
            "plain_ms": float(np.mean(p_ms)), "bound_ms": float(np.mean(bounds)),
            "bound_by": max(by, key=by.get),
            "library_ms": float(np.mean(l_ms))}


def panel_timing(torch, panel_lu, A, j0, b=128):
    """Kernel, plain and library ms of one panel launch on the (B, n, b)
    slab of A at j0 (restored between runs and after), with its bound: all
    n rows read once (the slab max behind the zero-pivot floor), rows >= j0
    written, perm and the L11 inverse written."""
    Bsz, n, _ = A.shape
    saved = A[:, :, j0:j0 + b].clone()
    view = A[:, :, j0:j0 + b]
    view.copy_(saved)
    panel_lu.panel_factor(view, j0)            # warm
    view.copy_(saved)
    torch.cuda.synchronize()
    k_ms = cuda_ms(lambda: panel_lu.panel_factor(view, j0))
    view.copy_(saved)
    torch.cuda.synchronize()
    p_ms = cuda_ms(lambda: panel_lu.panel_factor_plain(view, j0))
    sub = saved[:, j0:, :].contiguous()
    # the _ex form: a slab of pad columns is singular, which lu_factor rejects
    torch.linalg.lu_factor_ex(sub)
    torch.cuda.synchronize()
    l_ms = cuda_ms(lambda: torch.linalg.lu_factor_ex(sub))
    view.copy_(saved)
    nbytes = Bsz * (n * b * 8 + (n - j0) * b * 8 + n * 4 + b * b * 8)
    bms, bby = bound_ms(nbytes, Bsz * panel_flops(n, b, j0))
    return {"kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
            "bound_ms": bms, "bound_by": bby}


def row_swap_timing(torch, panel_lu, dev, gen, B, n, b):
    """The row swap kernel (csrc/row_swap.cu) at the factor's shape, B x n,
    at every panel position, on K1's own permutation of a random slab:
    bit for bit its plain version (the gather of every row >= j), then
    kernel and plain ms beside the bound by bytes (each moved row's n - b
    outside entries read and written once, and the b pivot rows' perm)."""
    from feast_tpu_torch.ops import row_swap

    A = torch.randn((B, n, n), dtype=torch.complex64, device=dev, generator=gen)
    keys = ("j0", "moved_rows", "kernel_ms", "plain_ms", "bound_ms")
    rows = {k: [] for k in keys}
    for j0 in range(0, n, b):
        _, pb, _ = panel_lu.panel_factor(A[:, :, j0:j0 + b].clone(), j0)
        moved = torch.zeros((), dtype=torch.int64, device=dev)
        want = A.clone()
        row_swap.apply_panel_perm_plain(want, pb, j0, b)
        row_swap.apply_panel_perm(A, pb, j0, b, moved)
        torch.cuda.synchronize()
        require(torch.equal(A, want), f"row_swap j0={j0}: not bit-equal to the gather")
        del want
        m = int(moved)
        nbytes = 2 * m * (n - b) * 8 + B * b * 4
        for k, v in zip(keys, (j0, m,
                               cuda_ms(lambda: row_swap.apply_panel_perm(A, pb, j0, b), 5),
                               cuda_ms(lambda: row_swap.apply_panel_perm_plain(A, pb, j0, b), 5),
                               bound_ms(nbytes, 0)[0])):
            rows[k].append(v)
    del A
    out = {"batch": B, "n": n, "b": b, "bit_equal": True, **rows}
    out.update({f"mean_{k}": float(np.mean(rows[k])) for k in keys[1:]})
    out["moved_share_pct"] = 100.0 * sum(rows["moved_rows"]) / (
        B * sum(n - j0 for j0 in rows["j0"]))
    return out


GUN_N, GUN_M0 = 9956, 84


def k1_padded(torch, panel_lu, dev, gen, B=4, n=GUN_N, timed=True):
    """The zero-padded route at n (the gun's 9956, padded to 9,984: 78
    panels; or the unstructured AMG's coarse 447, padded to 512, B = 1 as
    its node_chunk gives it), B nodes as one factor chunk: `lu.lu_factor`
    on the card bit for bit against lu_factor_panel(pad(A), plain
    version), cropped; then, if timed, one launch timed at the first
    panel, the last one of A's columns only (j0 = 9728) and the last one
    (j0 = 9856: 100 columns of A, 28 of padding)."""
    lumod = importlib.import_module("feast_tpu_torch.ops.lu")
    n_pad = -(-n // 128) * 128
    A = torch.randn((B, n, n), dtype=torch.complex64, device=dev, generator=gen)
    before = panel_lu.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    LU, perm = lumod.lu_factor(A)
    torch.cuda.synchronize()
    t_route = time.perf_counter() - t0
    launches = panel_lu.launches - before
    buf = torch.zeros((B, n_pad, n_pad), dtype=A.dtype, device=dev)
    buf[:, :n, :n] = A
    t0 = time.perf_counter()
    LUp, permp = panel_lu.lu_factor_panel(buf, panel=panel_lu.panel_factor_plain,
                                          inplace=True)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    require(launches == n_pad // 128, f"k1 padded: {launches} launches, {n_pad // 128} panels")
    require(torch.equal(perm, permp[:, :n]), f"k1 padded n={n}: perm differs from plain")
    require(torch.equal(LU, LUp[:, :n, :n]), f"k1 padded n={n}: LU not bit-equal to plain")
    require(int(perm.max()) < n, f"k1 padded n={n}: a pad row was chosen as a pivot")
    del LU, perm, LUp, permp
    out = {"n": n, "n_pad": n_pad, "batch": B, "bit_equal": True,
           "launches_per_factor": launches, "route_factor_s": t_route,
           "plain_factor_s": t_plain}
    if not timed:
        return out
    buf.zero_()
    buf[:, :n, :n] = A
    del A
    torch.cuda.empty_cache()
    timing = {f"j0_{j0}": panel_timing(torch, panel_lu, buf, j0)
              for j0 in (0, n_pad - 256, n_pad - 128)}
    del buf
    torch.cuda.empty_cache()
    return dict(out, timing=timing)


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


def schur_checks(torch, what, A, T, Z, Y, X, lam_ref):
    """The Schur kernel's invariants (held in complex128, so that entries far
    from 1 neither overflow nor underflow the norms); raises if one fails."""
    A, T, Z, Y, X = (M.to(torch.complex128) for M in (A, T, Z, Y, X))
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    lam_err = _match_err(torch.diagonal(T).cpu().numpy(), np.asarray(lam_ref))
    checks = {
        "eig_match_err": lam_err,
        "eig_match_err_rel": lam_err / max(float(np.abs(lam_ref).max()), 1e-300),
        "AZ_minus_ZT_rel": float(torch.linalg.norm(A @ Z - Z @ T) / torch.linalg.norm(A)),
        "ZhZ_minus_I": float((Z.mH @ Z - eye).abs().max()),
        "lower_max": float(torch.tril(T, -1).abs().max()),
        "XY_minus_I": float((X @ Y - eye).abs().max()),
    }
    tol = 5e-7 * max(n, 8)  # ~ n eps32: rotations accumulate rounding
    require(checks["eig_match_err_rel"] < 1e-4, f"{what}: eigenvalues {checks}")
    require(checks["AZ_minus_ZT_rel"] < tol, f"{what}: AZ - ZT {checks}")
    require(checks["ZhZ_minus_I"] < tol, f"{what}: Z unitary {checks}")
    require(checks["lower_max"] == 0.0, f"{what}: T not triangular {checks}")
    require(checks["XY_minus_I"] < 1e-3, f"{what}: XY - I {checks}")
    return checks


def in_turns(new_fn, base_fn, reps):
    """Device ms of new_fn, and of base_fn (an earlier checkout's kernel)
    when given, timed in turns base, new, new, base; returns (new mean,
    [base ms, base ms] or None)."""
    new_fn()
    if base_fn is None:
        return cuda_ms(new_fn, reps), None
    base_fn()
    b1 = cuda_ms(base_fn, reps)
    n1, n2 = cuda_ms(new_fn, reps), cuda_ms(new_fn, reps)
    return (n1 + n2) / 2, [b1, cuda_ms(base_fn, reps)]


def phase_k2(torch, schur_kernel, dev, base=None):
    from feast_tpu_torch.kernels import _build

    out = {"phase": "k2", "ptxas": ptxas_summary(_build, "schur")}
    row = None
    gen = torch.Generator(device=dev).manual_seed(2)
    # drawn in this order so that n = 2, 48, 128 keep their earlier inputs;
    # n = 84 (the nonlinear path's m0) and n = 10 (the unstructured path's)
    # from generators of their own, so that the later draws keep theirs too
    mats = {n: torch.randn((n, n), dtype=torch.complex64, device=dev, generator=gen)
            for n in (2, 48, 128, 8)}
    for n in (84, 10):
        mats[n] = torch.randn((n, n), dtype=torch.complex64, device=dev,
                              generator=torch.Generator(device=dev).manual_seed(n))
    for n in (2, 8, 10, 48, 84, 128):
        A = mats[n]
        T, Z, Y, X, st = schur_kernel.schur(A, want_y=True, return_stats=True)
        checks = {"sweeps": int(st[0]), "work": int(st[1])}
        if n <= 84:   # the paths' shapes: against the plain version
            Tp, Zp, Yp, Xp, stp = schur_kernel.schur_plain(A, want_y=True,
                                                           return_stats=True)
            lam_ref = torch.diagonal(Tp).cpu().numpy()
            checks.update({"plain_sweeps": int(stp[0]), "plain_work": int(stp[1])})
        else:         # against LAPACK's eigenvalues (the plain version: 15 s)
            lam_ref = np.linalg.eigvals(A.cpu().numpy().astype(np.complex128))
        torch.cuda.synchronize()
        checks.update(schur_checks(torch, f"k2 n={n}", A, T, Z, Y, X, lam_ref))
        lam_err = checks["eig_match_err"]
        if n == 48:  # the one-block kernel took 122 sweeps on this input
            require(abs(checks["sweeps"] - 122) <= 0.05 * 122,
                    f"k2 n=48: {checks['sweeps']} sweeps, 122 +- 5% expected")
        reps = 20
        base_fn = (lambda: base.schur(A, want_y=True)) if base is not None else None
        k_ms, b_ms = in_turns(lambda: schur_kernel.schur(A, want_y=True), base_fn, reps)
        p_ms = (cuda_ms(lambda: schur_kernel.schur_plain(A, want_y=True), 1)
                if n <= 84 else None)
        torch.linalg.eig(A)
        l_ms = cuda_ms(lambda: torch.linalg.eig(A), 5)
        nbytes = 5 * n * n * 8
        bms, bby = bound_ms(nbytes, schur_flops(n, int(st[1])))
        checks.update({"kernel_ms": k_ms, "baseline_ms": b_ms, "plain_ms": p_ms,
                       "library_ms": l_ms, "bound_ms": bms, "bound_by": bby,
                       "ns_per_rotation_step": k_ms * 1e6 / max(int(st[1]), 1)})
        out[f"n{n}"] = checks
        if n == 48:  # the main path's shape (m0 = 48)
            row = {"name": "schur", "route": "cuda",
                   "source": "feast_tpu_torch/csrc/schur.cu",
                   "replaces": "feast_tpu/ops/pallas_eig.py:42",
                   "max_abs_err": lam_err, "ms": k_ms, "plain_ms": p_ms,
                   "bound_ms": bms, "bound_by": bby, "library_ms": l_ms}
    # the rest of the supported range (m0 up to 128), against LAPACK's
    # eigenvalues, timed beside the baseline: where one warp a matrix stands
    # against the earlier kernel
    for n in (64, 96, 112):
        A = torch.randn((n, n), dtype=torch.complex64, device=dev, generator=gen)
        T, Z, Y, X, st = schur_kernel.schur(A, want_y=True, return_stats=True)
        lam_ref = np.linalg.eigvals(A.cpu().numpy().astype(np.complex128))
        checks = schur_checks(torch, f"k2 n={n}", A, T, Z, Y, X, lam_ref)
        base_fn = (lambda: base.schur(A, want_y=True)) if base is not None else None
        k_ms, b_ms = in_turns(lambda: schur_kernel.schur(A, want_y=True), base_fn, 20)
        out[f"n{n}"] = dict(checks, sweeps=int(st[0]), work=int(st[1]), kernel_ms=k_ms,
                            baseline_ms=b_ms)
    # entries far from 1 (the kernel scales A by a power of two first)
    A = mats[48]
    for scale in (1e-20, 1e18):
        As = A * scale
        T, Z, Y, X, st = schur_kernel.schur(As, want_y=True, return_stats=True)
        lam_ref = np.linalg.eigvals(As.cpu().numpy().astype(np.complex128))
        out[f"n48_scaled_{scale:g}"] = dict(
            schur_checks(torch, f"k2 n=48 x {scale:g}", As, T, Z, Y, X, lam_ref),
            sweeps=int(st[0]))
    out["batch4_n42"] = k2_batch(torch, schur_kernel, dev)
    emit(out)
    return row


def k2_batch(torch, schur_kernel, dev, S=4, n=42):
    """The stacked slices' launch (`feast_sliced_parallel`, the `parallel`
    phase): S reduced matrices of m0 = 42 in one launch, each held to the
    plain version's invariants, timed against S launches of one matrix and
    against batched torch.linalg.eig; bytes and operations for the bound
    summed over the batch."""
    A = torch.randn((S, n, n), dtype=torch.complex64, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(n))
    T, Z, Y, X, st = schur_kernel.schur(A, want_y=True, return_stats=True)
    Tp, _, _, _, stp = schur_kernel.schur_plain(A, want_y=True, return_stats=True)
    torch.cuda.synchronize()
    checks = [schur_checks(torch, f"k2 batch {S} x {n} [{s}]", A[s], T[s], Z[s], Y[s],
                           X[s], torch.diagonal(Tp[s]).cpu().numpy()) for s in range(S)]
    alone = [schur_kernel.schur(A[s], want_y=True) for s in range(S)]
    k_ms = cuda_ms(lambda: schur_kernel.schur(A, want_y=True), 20)
    single_ms = cuda_ms(lambda: [schur_kernel.schur(A[s], want_y=True) for s in range(S)], 20)
    p_ms = cuda_ms(lambda: schur_kernel.schur_plain(A, want_y=True), 1)
    torch.linalg.eig(A)
    l_ms = cuda_ms(lambda: torch.linalg.eig(A), 5)
    work = [int(w) for w in st[:, 1]]
    bms, bby = bound_ms(S * 5 * n * n * 8, sum(schur_flops(n, w) for w in work))
    return {"batch": S, "n": n, "kernel_ms": k_ms, "single_launches_ms": single_ms,
            "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": bms, "bound_by": bby,
            "sweeps": [int(x) for x in st[:, 0]], "plain_sweeps": [int(x) for x in stp[:, 0]],
            "work": work, "eig_match_err": max(c["eig_match_err"] for c in checks),
            "batch_equals_alone": all(torch.equal(T[s], a[0]) and torch.equal(Z[s], a[1])
                                      for s, a in enumerate(alone))}


# ---------------------------------------------------------------------------
# K3: complex64 matrix product
# ---------------------------------------------------------------------------

def cmatmul_bound_ms(Bsz, M, K, N):
    """Least time at fp32 accuracy: 6 M N K flop on the fp32 pipe, or
    3 x 6 M N K on the TF32 tensor cores (3xTF32 Karatsuba), whichever is
    less, against 8 (M K + K N + M N) bytes."""
    flops = 6 * Bsz * M * N * K
    t_ops = min(flops / PEAK_FP32_FLOPS, 3 * flops / PEAK_TF32_FLOPS) * 1e3
    t_bytes = 8 * Bsz * (M * K + K * N + M * N) / PEAK_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def trail_bound_ms(Bsz, M, K, N):
    """Least time of the update in place C <- C + alpha A B at fp32
    accuracy: 16 M N bytes of C (read and written once) and 8 (M K + K N)
    of the operands, against 3 x 6 M N K operations on the TF32 tensor
    cores (3xTF32 Karatsuba)."""
    return bound_ms(16 * Bsz * (M * N) + 8 * Bsz * (M * K + K * N),
                    18 * Bsz * M * N * K, PEAK_TF32_FLOPS)


def trail_update(torch, cmk, dev, gen, Bsz, n, e=128, reps=5):
    """The update in place at a factor's first trailing update: C =
    A3[:, e:, e:] of a (Bsz, n, n) buffer, L21 = A3[:, e:, :e], U12 =
    A3[:, :e, e:].  Its error against complex128 on 128 rows of C of the
    first and the last matrix, within twice that of cuBLAS's baddbmm_ on
    the same inputs; every entry outside C unchanged; one launch of the
    update form; then kernel and baddbmm_ timed."""
    buf = torch.randn((Bsz, n, n), dtype=torch.complex64, device=dev, generator=gen)
    M = n - e
    C, L, U = buf[:, e:, e:], buf[:, e:, :e], buf[:, :e, e:]
    rows = torch.cat([torch.arange(64), torch.arange(M - 64, M)]).to(dev)
    pick = (0, Bsz - 1)

    def sample(T):
        return torch.stack([T[i].index_select(0, rows) for i in pick]).to(torch.complex128)

    ref = sample(C) - sample(L) @ torch.stack([U[i] for i in pick]).to(torch.complex128)
    lib = buf.clone()
    lib[:, e:, e:].baddbmm_(lib[:, e:, :e], lib[:, :e, e:], alpha=-1)
    err_lib = float((sample(lib[:, e:, e:]) - ref).abs().max())
    del lib
    keep = buf.clone()
    acc0, prod0 = cmk.acc_launches, cmk.launches
    cmk.addmm_(C, L, U, -1.0)
    torch.cuda.synchronize()
    require(cmk.acc_launches == acc0 + 1 and cmk.launches == prod0,
            f"k3 update {Bsz}x{n}: launches {cmk.acc_launches - acc0}, {cmk.launches - prod0}")
    require(torch.equal(buf[:, :e], keep[:, :e]) and torch.equal(buf[:, e:, :e], keep[:, e:, :e]),
            f"k3 update {Bsz}x{n}: an entry outside C changed")
    del keep
    err = float((sample(C) - ref).abs().max())
    # 3xTF32 is fp32-accurate: within twice the library's fp32 error
    require(err <= 2 * err_lib, f"k3 update {Bsz}x{n}: complex128 err {err} > 2 x {err_lib}")
    k_ms = cuda_ms(lambda: cmk.addmm_(C, L, U, -1.0), reps)
    l_ms = cuda_ms(lambda: C.baddbmm_(L, U, alpha=-1), reps)
    bms, bby = trail_bound_ms(Bsz, M, e, M)
    require(k_ms >= bms, f"k3 update {Bsz}x{n}: {k_ms} ms is below the bound {bms} ms")
    del buf, C, L, U
    torch.cuda.empty_cache()
    return {"max_abs_err_vs_complex128": err, "library_err_vs_complex128": err_lib,
            "err_ratio": err / err_lib, "kernel_ms": k_ms, "library_ms": l_ms,
            "bound_ms": bms, "bound_by": bby, "share_of_bound_pct": 100 * bms / k_ms,
            "tensor_tflops_executed": 18 * Bsz * M * M * e / k_ms / 1e9}


def phase_k3(torch, ft, dev):
    from feast_tpu_torch.kernels import _build

    cmk = importlib.import_module("feast_tpu_torch.ops.cmatmul_kernel")
    cx = ft.cx
    gen = torch.Generator(device=dev).manual_seed(3)
    # wgmma compiles to HGMMA
    tc = sass_count(_build, "cmatmul", "HGMMA")
    require(tc is None or tc > 0, "k3: no tensor-core instruction in the kernel")
    out = {"phase": "k3", "ptxas": ptxas_summary(_build, "cmatmul"),
           "mma": cmk.MMA, "sass_tensor_core_instructions": tc}
    row = None
    # (batch, M, K, N); the last three are the dense path's, 16 nodes: a
    # diagonal-block solve and the first trailing updates of the n = 1024
    # and n = 4096 factors
    shapes = [(1, 256, 256, 256), (1, 300, 130, 384), (16, 128, 128, 48),
              (16, 896, 128, 896), (16, 3968, 128, 3968)]
    for Bsz, M, K, N in shapes:
        a = torch.randn((Bsz, M, K), dtype=torch.complex64, device=dev, generator=gen)
        b = torch.randn((Bsz, K, N), dtype=torch.complex64, device=dev, generator=gen)
        got = cmk.cmatmul(a, b)
        want = cx._cmatmul_planes(a, b)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ref = (a[0].to(torch.complex128) @ b[0].to(torch.complex128))
        err64 = float((got[0] - ref).abs().max())
        err64_plain = float((want[0] - ref).abs().max())
        # fp32 sums of K products of O(1) terms in another order than the
        # library's: the JAX test's bound, 1e-3 sqrt(K) absolute
        require(err <= 1e-3 * np.sqrt(K), f"k3 {M}x{K}x{N}: err {err} vs plain")
        require(err64 <= 1e-3 * np.sqrt(K), f"k3 {M}x{K}x{N}: err {err64} vs complex128")
        # 3xTF32 is fp32-accurate: within twice the fp32 plain version's error
        require(err64 <= 2 * err64_plain,
                f"k3 {M}x{K}x{N}: complex128 err {err64} > 2 x plain {err64_plain}")
        reps = 3 if M * N * K * Bsz > 1e10 else 20
        k_ms = cuda_ms(lambda: cmk.cmatmul(a, b), reps)
        p_ms = cuda_ms(lambda: cx._cmatmul_planes(a, b), reps)
        l_ms = cuda_ms(lambda: torch.matmul(a, b), reps)
        bms, bby = cmatmul_bound_ms(Bsz, M, K, N)
        require(k_ms >= bms, f"k3 {M}x{K}x{N}: {k_ms} ms is below the bound {bms} ms")
        out[f"{Bsz}x{M}x{K}x{N}"] = {
            "max_abs_err": err, "max_abs_err_vs_complex128": err64,
            "plain_err_vs_complex128": err64_plain, "err_ratio": err64 / err64_plain,
            "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
            "bound_ms": bms, "bound_by": bby,
            # nine TF32 products (3 per real product, 3 real per complex)
            "tensor_tflops_executed": 18 * Bsz * M * N * K / k_ms / 1e9}
        if M == 3968:
            row = {"name": "cmatmul", "route": "cuda",
                   "source": "feast_tpu_torch/csrc/cmatmul.cu",
                   "replaces": "feast_tpu/ops/pallas_kernels.py:47",
                   "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                   "bound_ms": bms, "bound_by": bby, "library_ms": l_ms}
        del a, b, got, want
    torch.cuda.empty_cache()
    # the update form at the first trailing update of the cells' factors:
    # dense10240, a rank of dense20480.node4, a chunk of the gun (n = 9956
    # padded to 9,984)
    acc_row = None
    for Bsz, n in ((16, 10240), (4, 20480), (4, 9984)):
        info = trail_update(torch, cmk, dev, gen, Bsz, n)
        out[f"update_{Bsz}x{n - 128}x128x{n - 128}"] = info
        if n == 10240:
            acc_row = {"name": "cmatmul_acc", "route": "cuda",
                       "source": "feast_tpu_torch/csrc/cmatmul.cu",
                       "replaces": "cuBLAS cgemm (baddbmm_), ops/panel_lu.py",
                       "max_abs_err": info["max_abs_err_vs_complex128"],
                       "ms": info["kernel_ms"], "plain_ms": None,
                       "bound_ms": info["bound_ms"], "bound_by": info["bound_by"],
                       "library_ms": info["library_ms"]}

    # the dense path through the kernel: every complex64 product of the
    # factor and of the solves goes to it
    def dense_solve(n):
        A, X0, c, r = bench_problem(n=n)
        cx.set_gemm_backend("cuda")
        try:
            cmk.launches = 0
            t0 = time.perf_counter()
            res = ft.feast_compiled(A, X0, c=c, r=r, nodes=16, iters=20, tol=1e-10,
                                    mixed_prec=True, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = cmk.launches
        finally:
            cx.set_gemm_backend("torch")
        lam, rr = host_residuals(A, res)
        require(res.converged and rr.max() < 1e-10,
                f"k3 dense n={n}: converged {res.converged}, residual {rr.max()}")
        require(launches > 0, f"k3 dense n={n}: the kernel was not launched")
        info = {"inside": int(len(lam)), "iterations": res.n_iter,
                "max_residual_host_f64": float(rr.max()), "wall_s": wall,
                "launches": launches}
        return A, c, r, lam, info

    A, c, r, lam, info = dense_solve(1024)
    ref = np.linalg.eigvals(A)
    ref = ref[np.abs(ref - c) <= r]
    require(len(lam) == len(ref), f"k3 dense n=1024: {len(lam)} inside, LAPACK {len(ref)}")
    info["eig_err_vs_lapack"] = _match_err(lam, ref)
    require(info["eig_err_vs_lapack"] < 1e-10,
            f"k3 dense n=1024: eig err {info['eig_err_vs_lapack']}")
    out["dense_n1024_backend_cuda"] = info
    # the main path's problem: its first trailing update is the shape timed above
    _, _, _, lam, info = dense_solve(4096)
    require(len(lam) >= 1, "k3 dense n=4096: no eigenvalue inside")
    out["dense_n4096_backend_cuda"] = info
    emit(out)
    row["launches"] = info["launches"]
    return [row, acc_row]


# ---------------------------------------------------------------------------
# K4: DIA sparse product
# ---------------------------------------------------------------------------

def grid_offsets(N):
    """Diagonals of the 9-point operators on an N x N grid, row-major."""
    return (-N - 1, -N, -N + 1, -1, 0, 1, N - 1, N, N + 1)


def _dia_to_sparse_csr(torch, data, offsets, ncols):
    """torch.sparse CSR tensor of one (ndiag, n) DIA operator."""
    n = data.shape[-1]
    rows, cols, vals = [], [], []
    for k, off in enumerate(offsets):
        lo, hi = max(0, -off), min(n, ncols - off)
        i = torch.arange(lo, hi, device=data.device)
        rows.append(i)
        cols.append(i + off)
        vals.append(data[k, lo:hi])
    coo = torch.sparse_coo_tensor(torch.stack([torch.cat(rows), torch.cat(cols)]),
                                  torch.cat(vals), (n, ncols)).coalesce()
    return coo.to_sparse_csr()


# Diagonals of the second DIA level of the sparse path's AMG hierarchy
# (N = 1000 grid pencil, strength aggregates: 167,000 rows), as the sparse
# phase prints them under "levels"
LEVEL1_OFFSETS = (-669, -668, -667, -336, -335, -334, -333, -332, -2, -1, 0, 1, 2,
                  332, 333, 334, 335, 336, 667, 668, 669)


def phase_k4(torch, dev, base=None):
    from feast_tpu_torch.kernels import _build

    dk = importlib.import_module("feast_tpu_torch.ops.dia_kernel")
    gen = torch.Generator(device=dev).manual_seed(4)
    out = {"phase": "k4", "ptxas": ptxas_summary(_build, "dia_spmm")}
    row = None
    cases = [("small_tridiag", (-1, 0, 1), 700, 16, 1),
             ("small_wide", (-32, -1, 0, 1, 32), 512, 8, 1),
             ("small_upper", (2, 5), 300, 16, 1), ("small_lower", (-7, -3), 300, 16, 1),
             ("level0", grid_offsets(1000), 1_000_000, 8, 8)]
    cases.append(("level1", LEVEL1_OFFSETS, 167_000, 8, 8))
    # odd m: rows of 24 bytes, so the 16-byte loads give way to 8-byte ones;
    # n ragged against the 256-item blocks
    cases.append(("m3_ragged", grid_offsets(500), 250_001, 3, 4))
    for name, offs, n, m, Bsz in cases:
        data = torch.randn((Bsz, len(offs), n), dtype=torch.complex64, device=dev,
                           generator=gen)
        X = torch.randn((Bsz, n, m), dtype=torch.complex64, device=dev, generator=gen)
        want = dk.dia_matvec_plain(data, offs, X)
        scale = float(want.abs().max())
        got = dk.dia_matvec(data, offs, X)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        # both sum ndiag fp32 products per entry in the same order; the
        # kernel contracts multiply-adds, the plain version rounds each
        # product: 1e-5 of the largest entry
        require(err <= 1e-5 * scale, f"k4 {name}: err {err} (scale {scale})")
        # one shared operator against batched X, as the unshifted products use it
        got1 = dk.dia_matvec(data[0], offs, X)
        err1 = float((got1 - dk.dia_matvec_plain(data[0], offs, X)).abs().max())
        require(err1 <= 1e-5 * scale, f"k4 {name}: shared-data err {err1}")
        del got, got1
        reps = 10
        base_fn = (lambda: base.dia_matvec(data, offs, X)) if base is not None else None
        k_ms, b_ms = in_turns(lambda: dk.dia_matvec(data, offs, X), base_fn, reps)
        p_ms = cuda_ms(lambda: dk.dia_matvec_plain(data, offs, X), reps)
        try:  # the library's product of the same operators, one node at a time
            csr = [_dia_to_sparse_csr(torch, data[i], offs, n) for i in range(Bsz)]
            lib = torch.stack([torch.sparse.mm(csr[i], X[i]) for i in range(Bsz)])
            lib_err = float((lib - want).abs().max())
            require(lib_err <= 1e-4 * scale, f"k4 library yardstick disagrees: {lib_err}")
            l_ms = cuda_ms(lambda: [torch.sparse.mm(csr[i], X[i]) for i in range(Bsz)], reps)
            del csr, lib
        except (RuntimeError, NotImplementedError) as e:  # no complex64 CSR product
            out.setdefault("library_unavailable", str(e)[:200])
            l_ms = None
        inrange = sum(min(n, n - off) - max(0, -off) for off in offs)
        nbytes = Bsz * 8 * (len(offs) * n + 2 * n * m)
        bms, bby = bound_ms(nbytes, 8 * Bsz * inrange * m)
        out[name] = {
            "offsets": list(offs), "n": n, "m": m, "batch": Bsz,
            "max_abs_err": err, "scale": scale, "kernel_ms": k_ms,
            "baseline_ms": b_ms, "plain_ms": p_ms,
            "library_ms": l_ms, "bound_ms": bms, "bound_by": bby,
            "gbytes_per_s": nbytes / k_ms / 1e6, "bound_share": bms / k_ms}
        if name == "level0":
            row = {"name": "dia_spmm", "route": "cuda",
                   "source": "feast_tpu_torch/csrc/dia_spmm.cu",
                   "replaces": "feast_tpu/ops/pallas_kernels.py:108",
                   "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                   "bound_ms": bms, "bound_by": bby, "library_ms": l_ms}
        del data, X, want
    torch.cuda.empty_cache()
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


def phase_main(torch, ft, dev, refs, reps=3):
    panel_lu = importlib.import_module("feast_tpu_torch.ops.panel_lu")
    schur_kernel = importlib.import_module("feast_tpu_torch.ops.schur_kernel")
    diag_inv = importlib.import_module("feast_tpu_torch.ops.diag_inv")
    cmk = importlib.import_module("feast_tpu_torch.ops.cmatmul_kernel")
    fmod = importlib.import_module("feast_tpu_torch.solvers.feast")
    A, X0, c, r = bench_problem()
    At = torch.as_tensor(A, device=dev)
    Xt = torch.as_tensor(X0, device=dev)
    kw = dict(c=c, r=r, nodes=16, iters=20, tol=1e-10, mixed_prec=True, device=dev)
    torch.cuda.synchronize()

    def counted(fn):
        panel_lu.launches = 0
        schur_kernel.launches = 0
        diag_inv.launches = 0
        cmk.acc_launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {"panel_lu": panel_lu.launches, "schur": schur_kernel.launches,
                     "diag_inv": diag_inv.launches, "cmatmul_acc": cmk.acc_launches}

    t0 = time.perf_counter()
    res, launches = counted(lambda: ft.feast_compiled(At, Xt, **kw))
    warm = time.perf_counter() - t0
    require(len(fmod._PROGRAMS) == 1, "main: feast_compiled did not run its sweeps as graphs")
    prog = next(iter(fmod._PROGRAMS.values()))
    require(prog.graphs and prog.replays > 0, "main: no graph replayed")

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
    # the same steps run eagerly on the same inputs: the kernels' launches
    # must agree
    res_steps, launches_steps = counted(lambda: fmod._feast_compiled_steps(At, Xt, **kw))

    lam, rr = host_residuals(A, res)
    require(res.converged, "main: not converged")
    require(len(lam) >= 1, "main: no eigenvalue inside")
    require(np.isfinite(rr).all() and rr.max() < 1e-10,
            f"main: host residual {rr.max()}")
    require(all(v > 0 for v in launches.values()), f"main: kernel launches {launches}")
    require(launches == launches_steps and res.n_iter == res_steps.n_iter,
            f"main: launches {launches} in {res.n_iter} iterations, the eager steps "
            f"{launches_steps} in {res_steps.n_iter}")
    emit({"phase": "main", "n": 4096, "m0": 48, "nodes": 16, "tol": 1e-10,
          "inside": int(len(lam)), "iterations": res.n_iter,
          "max_residual_host_f64": float(rr.max()), "warmup_wall_s": warm,
          "walls_s": walls, "factors_s": factors, "best_wall_s": best,
          "factor_s": factor_s,
          "sweeps_s": best - factor_s,
          "per_sweep_s": (best - factor_s) / max(res.n_iter, 1),
          "launches_per_solve": launches, "launches_eager_steps": launches_steps,
          "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9})
    refs["main"] = {"lam": lam[np.argsort(lam.real)], "n_iter": res.n_iter}
    return launches, int(len(lam))


def pencil_B(n=4096, seed=1):
    """A Hermitian positive definite B near the identity for the B pencil:
    I + 0.02 (G + G^H) / (2 sqrt(n)), G complex Gaussian."""
    rng = np.random.default_rng(seed)
    G = rng.standard_normal((n, n)) + 1j * rng.standard_normal((n, n))
    return np.eye(n, dtype=np.complex128) + 0.01 * (G + G.conj().T) / np.sqrt(n)


def pencil_residuals(A, B, res):
    """Host float64 residual ||A x - lam B x|| of each inside Ritz pair."""
    lam, X, _ = res.filtered()
    BX = X if B is None else B @ X
    return lam, np.linalg.norm(A @ X - BX * lam[None, :], axis=0)


def read_cost_ms(torch, prog, sweeps, reps=2):
    """What the host's one status read a sweep costs: the complex128 tier's
    two graphs replayed `sweeps` times with the read between them (copy to
    pinned memory, stream sync) and without it (one sync at the end), best
    of reps each, in turns; ms per sweep.  The replays run past the solve's
    end on the program's buffers, which the next solve loads anew."""
    def sweep_loop(read):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(sweeps):
            out = prog._step("fine_rr")
            if read:
                prog._read(out["status"])
            prog._step("fine_update")
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    walls = {True: [], False: []}
    for _ in range(reps):
        for read in (True, False):
            walls[read].append(sweep_loop(read))
    return (min(walls[True]) - min(walls[False])) / sweeps * 1e3


def phase_compiled_graph(torch, ft, dev, smi, refs, reps=3):
    """feast_compiled's sweeps as CUDA graphs against the same steps run
    eagerly (`_feast_compiled_steps`) on the main problem and on a B pencil
    at the same n, one route after the other (the card holds one program,
    so a call of the other route builds its own): an eager solve that
    builds the program, reps eager solves, a cold graph solve (capture and
    instantiation timed), reps graph solves, a warm graph solve under
    torch.profiler and the memory the cached program holds; on the main
    problem also the cost of the host's status read a sweep
    (`read_cost_ms`) and the eager steps' trace, the profile phase's where
    it ran (`refs["steps_trace"]`).  The two must run the same iterations,
    sweeps per tier and inside count, agree to 1e-12 relative and launch K1
    and K2 as often; on the main problem the graphs' warm solve makes at
    most 5% of the eager steps' launch calls."""
    fmod = importlib.import_module("feast_tpu_torch.solvers.feast")
    panel_lu = importlib.import_module("feast_tpu_torch.ops.panel_lu")
    schur_kernel = importlib.import_module("feast_tpu_torch.ops.schur_kernel")
    A, X0, c, r = bench_problem()
    At, Xt = torch.as_tensor(A, device=dev), torch.as_tensor(X0, device=dev)
    kw = dict(c=c, r=r, nodes=16, iters=20, tol=1e-10, mixed_prec=True, device=dev)
    out = {"phase": "compiled_graph", "card": smi}
    for label, B in (("headline", None), ("B_pencil", pencil_B())):
        headline = B is None
        Bt = None if B is None else torch.as_tensor(B, device=dev)

        def graph():
            return ft.feast_compiled(At, Xt, B=Bt, **kw)

        def steps():
            return fmod._feast_compiled_steps(At, Xt, B=Bt, **kw)

        def run(fn):
            panel_lu.launches = 0
            schur_kernel.launches = 0
            torch.cuda.reset_peak_memory_stats(dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            return res, {"wall_s": time.perf_counter() - t0,
                         "k1": panel_lu.launches, "k2": schur_kernel.launches,
                         "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
                         "sweeps": list(next(iter(fmod._PROGRAMS.values())).sweeps)}

        steps_s = {}
        t_step = time.perf_counter()

        def lap(name):
            nonlocal t_step
            now = time.perf_counter()
            steps_s[name] = now - t_step
            t_step = now

        fmod.clear_graph_cache()
        torch.cuda.empty_cache()
        run(steps)
        lap("steps_cold")
        if headline and "steps_trace" not in refs:    # the profile phase's, else here
            refs["steps_trace"] = traced(torch, steps, cpu=False)
            lap("steps_traced")
        tp = refs["steps_trace"] if headline else None
        walls = {"graph": [], "steps": []}
        for _ in range(reps):
            res_s, warm_steps = run(steps)
            walls["steps"].append(warm_steps["wall_s"])
        lap("steps_reps")
        fmod.clear_graph_cache()
        torch.cuda.empty_cache()
        res_g, cold = run(graph)
        prog = next(iter(fmod._PROGRAMS.values()))
        cold.update(capture_s=prog.capture_s, instantiate_s=prog.instantiate_s,
                    replays=prog.replays)
        lap("cold")
        for _ in range(reps):
            before = prog.replays
            res_g, info = run(graph)
            walls["graph"].append(info["wall_s"])
            warm_graph = dict(info, replays=prog.replays - before)
        lap("graph_reps")
        tg = traced(torch, graph, cpu=False)
        lap("graph_traced")
        if headline:
            read_ms = read_cost_ms(torch, prog, res_g.n_iter)
            lap("read_cost")
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated(dev), torch.cuda.memory_reserved(dev)
        fmod.clear_graph_cache()
        del prog
        torch.cuda.empty_cache()
        held = [(a - b) / 1e9 for a, b in zip(held, (torch.cuda.memory_allocated(dev),
                                                      torch.cuda.memory_reserved(dev)))]

        lam_g, rr_g = pencil_residuals(A, B, res_g)
        lam_s, rr_s = pencil_residuals(A, B, res_s)
        lam_g, lam_s = lam_g[np.argsort(lam_g.real)], lam_s[np.argsort(lam_s.real)]
        same_count = len(lam_g) == len(lam_s)
        diff = float(np.max(np.abs(lam_g - lam_s) / np.abs(lam_s))) if same_count else np.inf
        row = {"inside": len(lam_g), "inside_steps": len(lam_s),
               "n_iter": res_g.n_iter, "n_iter_steps": res_s.n_iter,
               "max_relerr_vs_steps": diff,
               "bit_equal": bool(same_count and np.array_equal(lam_g, lam_s)),
               "max_residual_host_f64": float(rr_g.max()),
               "max_residual_steps_host_f64": float(rr_s.max()),
               "cold": cold, "warm_graph": warm_graph, "warm_steps": warm_steps,
               "graph_walls_s": walls["graph"], "steps_walls_s": walls["steps"],
               "graph_best_s": min(walls["graph"]), "steps_best_s": min(walls["steps"]),
               "graph_launch_calls": tg["launch_calls"], "graph_launches": tg["graph_launches"],
               "graph_device_idle_share": tg["device_idle_share"],
               "graph_kernel_count": tg["kernel_count"],
               "graph_profiled_wall_s": tg["wall_s"],
               "graph_top_kernels_ms": top_kernels(tg, k=8),
               "cache_allocated_gb": held[0], "cache_reserved_gb": held[1],
               "steps_s": steps_s}
        if headline:
            row.update(steps_launch_calls=tp["launch_calls"],
                       steps_device_idle_share=tp["device_idle_share"],
                       steps_kernel_count=tp["kernel_count"],
                       steps_profiled_wall_s=tp["wall_s"],
                       status_read_ms_per_sweep=read_ms)
        out[label] = row
        what = f"compiled_graph {label}"
        require(res_g.converged and res_s.converged, f"{what}: not converged")
        require(res_g.n_iter == res_s.n_iter and same_count,
                f"{what}: {res_g.n_iter} iterations and {len(lam_g)} inside, the eager "
                f"steps {res_s.n_iter} and {len(lam_s)}")
        require(diff <= 1e-12, f"{what}: eigenvalues {diff} relative from the eager steps")
        require(rr_g.max() < 1e-10 and rr_s.max() < 1e-10,
                f"{what}: host residuals {rr_g.max()}, eager steps {rr_s.max()}")
        for info in (cold, warm_graph):
            require(info["k1"] == warm_steps["k1"] and info["k2"] == warm_steps["k2"],
                    f"{what}: K1 {info['k1']}, K2 {info['k2']} launches, the eager steps "
                    f"{warm_steps['k1']}, {warm_steps['k2']}")
        require(warm_graph["replays"] > 0, f"{what}: no graph replayed")
        if headline:
            require(tg["launch_calls"] <= 0.05 * tp["launch_calls"],
                    f"{what}: {tg['launch_calls']} launch calls, the eager steps "
                    f"{tp['launch_calls']}")
        require(cold["sweeps"] == warm_graph["sweeps"] == warm_steps["sweeps"],
                f"{what}: sweeps per tier {cold['sweeps']}, {warm_graph['sweeps']}, the "
                f"eager steps {warm_steps['sweeps']}")
        del Bt, res_g, res_s
    fmod.clear_graph_cache()
    emit(out)


def lu_backward_error(torch, A, LU, perm, count):
    """max over the first `count` matrices of ||PA - LU|| / ||A|| in
    complex128, the factor's own (`ops.lu`) and torch.linalg.lu_factor_ex's
    of the same matrices."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=torch.complex128, device=A.device)
    own = lib = 0.0
    for i in range(count):
        Ai = A[i].to(torch.complex128)
        nrm = torch.linalg.norm(Ai)
        L = torch.tril(LU[i].to(torch.complex128), -1) + eye
        R = L @ torch.triu(LU[i].to(torch.complex128)) - Ai[perm[i]]
        own = max(own, float(torch.linalg.norm(R) / nrm))
        del L, R
        LUl, pivl, _ = torch.linalg.lu_factor_ex(A[i])
        Pl, Ll, Ul = torch.lu_unpack(LUl, pivl)
        R = Ai - Pl.to(torch.complex128) @ (Ll.to(torch.complex128) @ Ul.to(torch.complex128))
        lib = max(lib, float(torch.linalg.norm(R) / nrm))
        del LUl, pivl, Pl, Ll, Ul, R, Ai
    return own, lib


def phase_panel_backend(torch, ft, dev, refs, smi, reps=3):
    """The two panel routes of the factor on the card: "pallas" (K1) and
    "xla" (the plain blocked loop, no K1), on the main path's node
    matrices and on one chunk of the gun's; then feast_compiled on the main
    problem under "xla" against `main`.  The backend is "pallas" again
    when the phase ends, whatever happened."""
    lumod = importlib.import_module("feast_tpu_torch.ops.lu")
    panel_lu = importlib.import_module("feast_tpu_torch.ops.panel_lu")
    fmod = importlib.import_module("feast_tpu_torch.solvers.feast")
    if "main" not in refs:
        phase_main(torch, ft, dev, refs)

    def factor(S, backend):
        lumod.set_panel_backend(backend)
        before = panel_lu.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        LU, perm = lumod.lu_factor(S)
        torch.cuda.synchronize()
        return LU, perm, time.perf_counter() - t0, panel_lu.launches - before

    def both_routes(label, S, panels, reps, check):
        out = {"label": label, "batch": S.shape[0], "n": S.shape[-1], "card": smi}
        walls = {"pallas": [], "xla": []}
        for _ in range(reps):                  # in turns: host walls drift between calls
            for backend in ("pallas", "xla"):
                LU, perm, wall, launches = factor(S, backend)
                walls[backend].append(wall)
                want = panels if backend == "pallas" else 0
                require(launches == want,
                        f"panel_backend {label}: {launches} K1 launches under "
                        f"{backend!r}, {want} expected")
                out[f"k1_launches_{backend}"] = launches
                if f"resid_{backend}" not in out:
                    own, lib = lu_backward_error(torch, S, LU, perm, check)
                    require(own < 3 * lib,
                            f"panel_backend {label} {backend!r}: ||PA - LU||/||A|| = "
                            f"{own}, library {lib}")
                    out[f"resid_{backend}"] = own
                    out["resid_torch_linalg"] = lib
                del LU, perm
        for backend, w in walls.items():
            out[f"{backend}_s"] = w
            out[f"{backend}_best_s"] = min(w)
        emit(dict(out, phase="panel_backend"))
        return out

    A, X0, c, r = bench_problem()
    At = torch.as_tensor(A, device=dev)
    try:
        # the main path's node matrices, formed as _factor_scan forms them
        z = ft.circular_contour_trapezoidal(c, r, 16).device_nodes(torch.complex128, dev)
        S = torch.empty((16, 4096, 4096), dtype=torch.complex64, device=dev)
        for i in range(16):
            S[i] = fmod._shifted_single(At, None, z[i])
        both_routes("main_nodes", S, 32, reps, 2)
        del S
        torch.cuda.empty_cache()

        # one chunk of the gun's node matrices, as nlfeast evaluates them
        T = ft.problems.gun_like(GUN_N, seed=0, planted=25, device=dev)
        z = ft.circular_contour_trapezoidal(GUN_KW["c"], GUN_KW["r"],
                                            GUN_KW["nodes"]).device_nodes(torch.complex128, dev)
        S = T.eval_nodes(z[:4], out_dtype=torch.complex64)
        del T
        torch.cuda.empty_cache()
        both_routes("gun_chunk", S, -(-GUN_N // 128), 1, 1)
        del S
        torch.cuda.empty_cache()

        # the whole dense solve under "xla"
        lumod.set_panel_backend("xla")
        panel_lu.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ft.feast_compiled(At, torch.as_tensor(X0, device=dev), c=c, r=r, nodes=16,
                                iters=20, tol=1e-10, mixed_prec=True, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = panel_lu.launches
    finally:
        lumod.set_panel_backend("pallas")
    lam, rr = host_residuals(A, res)
    lam = lam[np.argsort(lam.real)]
    ref = refs["main"]["lam"]
    diff = (float(np.max(np.abs(lam - ref) / np.abs(ref))) if len(lam) == len(ref)
            else np.inf)
    require(res.converged and len(lam) == len(ref) and diff < 1e-10,
            f"panel_backend: feast_compiled under 'xla' converged={res.converged}, "
            f"{len(lam)} inside (main {len(ref)}), {diff} relative from main")
    require(np.isfinite(rr).all() and rr.max() < 1e-10,
            f"panel_backend: feast_compiled under 'xla' host residual {rr.max()}")
    require(launches == 0, f"panel_backend: {launches} K1 launches under 'xla'")
    require(lumod._PANEL_BACKEND == "pallas", "panel_backend: backend not restored")
    emit({"phase": "panel_backend", "label": "feast_compiled_xla", "card": smi,
          "wall_s": wall, "iterations": res.n_iter, "inside": int(len(lam)),
          "max_relerr_vs_main": diff, "max_residual_host_f64": float(rr.max()),
          "k1_launches": launches})


def traced(torch, fn, cpu=True):
    """fn() once under torch.profiler, summed from the raw trace events
    (building the profiler's per-event objects with key_averages() takes
    minutes for the 1e5-1e6 events of one solve): wall, device busy time
    and idle share, cudaLaunchKernel calls, every launch call of the
    runtime and driver (kernels, K1's cudaLaunchKernelEx, graph launches)
    and the graph launches among them, kernels run, and [name, count, ms]
    per kernel name, most device time first.  cpu=False leaves out the
    host operators' events (the launch calls stay: they are the CUDA
    runtime's).  The profiler's copies of `record_function` ranges on the
    device's track ("gpu_user_annotation", among them the solvers'
    "span.<name>" ranges) are no device work and are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] * cpu + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name, launches, calls, graphs = {}, 0, 0, 0
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            kind = getattr(e, "activity_type", None)
            if (kind and "annotation" in str(kind())) or name.startswith("span."):
                continue
            cnt, ns = by_name.get(name, (0, 0))
            by_name[name] = (cnt + 1, ns + e.duration_ns())
        elif name.startswith(("cudaLaunch", "cuLaunch", "cudaGraphLaunch")):
            calls += 1
            launches += name == "cudaLaunchKernel"
            graphs += name == "cudaGraphLaunch"
    busy = sum(ns for _, ns in by_name.values()) / 1e9
    ranked = sorted(([k, c, ns / 1e6] for k, (c, ns) in by_name.items()),
                    key=lambda row: row[2], reverse=True)
    return {"wall_s": wall, "device_busy_s": busy, "device_idle_share": 1.0 - busy / wall,
            "cuda_launch_calls": launches, "launch_calls": calls, "graph_launches": graphs,
            "kernel_count": sum(c for c, _ in by_name.values()),
            "kernels": ranked}


def top_kernels(tr, k=12, width=70):
    return [[name[:width], cnt, ms] for name, cnt, ms in tr["kernels"][:k]]


def phase_profile(torch, ft, dev, refs):
    """Two more main-path solves through the sweep program's steps run
    eagerly (`_feast_compiled_steps`): one with each driver phase wrapped
    in a synchronized host timer (factor, orthonormalization, the
    Rayleigh-Ritz step, which holds an orthonormalization, and its small
    eig, node update; the graphs' replays have no host boundaries inside
    a step), one under torch.profiler (device idle share, launch calls, top
    kernels), which `compiled_graph` holds the graphs' trace to."""
    fmod = importlib.import_module("feast_tpu_torch.solvers.feast")
    A, X0, c, r = bench_problem()
    At, Xt = torch.as_tensor(A, device=dev), torch.as_tensor(X0, device=dev)
    kw = dict(c=c, r=r, nodes=16, iters=20, tol=1e-10, mixed_prec=True, device=dev)

    phases = {}
    wrapped = [(fmod, "_factor_scan"), (fmod.qrmod, "orthonormalize"),
               (fmod, "_rr_step"), (fmod.eigmod, "eig"), (fmod.eigmod, "_eig_flagged"),
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

    for (m, name), fn in zip(wrapped, saved):
        setattr(m, name, timer(fn, name))
    try:
        t0 = time.perf_counter()
        fmod._feast_compiled_steps(At, Xt, **kw)
        torch.cuda.synchronize()
        wall_timed = time.perf_counter() - t0
    finally:
        for (m, name), fn in zip(wrapped, saved):
            setattr(m, name, fn)
    tr = traced(torch, lambda: fmod._feast_compiled_steps(At, Xt, **kw), cpu=False)
    fmod.clear_graph_cache()
    refs["steps_trace"] = tr
    emit({"phase": "profile", "route": "_feast_compiled_steps", "timed_wall_s": wall_timed,
          "phase_wall_s": {k: {"s": v[0], "calls": v[1]} for k, v in phases.items()},
          "profiled_wall_s": tr["wall_s"], "device_busy_s": tr["device_busy_s"],
          "device_idle_share": tr["device_idle_share"],
          "cuda_launch_calls": tr["cuda_launch_calls"], "launch_calls": tr["launch_calls"],
          "kernel_count": tr["kernel_count"], "top_kernels_ms": top_kernels(tr)})


# ---------------------------------------------------------------------------
# the sparse iterative path
# ---------------------------------------------------------------------------

def grid_factors(N):
    """The 1-D stiffness T = tridiag(-1, 2, -1) and mass M = tridiag(1, 4, 1) / 6
    whose Kronecker sums and products make `build_pencil`'s pencil."""
    import scipy.sparse as sp

    T1 = sp.diags([np.full(N, 2.0), -np.ones(N - 1), -np.ones(N - 1)],
                  [0, 1, -1], format="csr")
    M1 = sp.diags([np.full(N, 4 / 6), np.full(N - 1, 1 / 6),
                   np.full(N - 1, 1 / 6)], [0, 1, -1], format="csr")
    return T1, M1


def build_pencil(N):
    """2-D tensor pencil on an N x N grid: K = T (+) T (5-point stiffness),
    B = M (x) M (9-point bilinear mass, M = tridiag(1, 4, 1) / 6), and the
    exact separable spectrum (t_i + t_j) / (m_i m_j), sorted."""
    import scipy.sparse as sp

    T1, M1 = grid_factors(N)
    I = sp.identity(N, format="csr")
    K = (sp.kron(T1, I) + sp.kron(I, T1)).tocsr().astype(np.complex128)
    B = sp.kron(M1, M1).tocsr().astype(np.complex128)
    k = np.arange(1, N + 1)
    t = 2 - 2 * np.cos(k * np.pi / (N + 1))
    m = (2 + np.cos(k * np.pi / (N + 1))) / 3
    lam = np.sort(((t[:, None] + t[None, :]) / (m[:, None] * m[None, :])).ravel())
    return K, B, lam


def lowest_slice(lam):
    """The lowest cluster: the 5 smallest, whose degenerate pair pulls in a 6th."""
    return complex((lam[0] + lam[4]) / 2), float((lam[4] - lam[0]) * 0.75)


SPARSE_KW = dict(nodes=8, iters=8, tol=1e-10, precondition="amg",
                 solver="bicgstab_rr", solve_tol=1e-9, solve_iters=120)


def sparse_amg_opts(torch):
    """complex64 V-cycle on strength-of-connection aggregates.  The package
    default ("auto": contiguous runs of 3 rows on banded levels) coarsens
    the grid along one axis only; already on a 60 x 60 grid with 6 levels
    BiCGStab then needs its whole iteration cap of 120
    (tests/test_torch_amg.py::test_auto_aggregation_stalls_on_deep_2d_hierarchy)."""
    return {"dtype": torch.float32, "aggregate": "strength"}


class Patched:
    """Replace attributes for the length of a with block."""

    def __init__(self, *triples):
        self.triples = triples

    def __enter__(self):
        self.saved = [getattr(m, name) for m, name, _ in self.triples]
        for m, name, new in self.triples:
            setattr(m, name, new)

    def __exit__(self, *exc):
        for (m, name, _), old in zip(self.triples, self.saved):
            setattr(m, name, old)


def phase_sparse(torch, ft, dev, N=1000):
    dk = importlib.import_module("feast_tpu_torch.ops.dia_kernel")
    schur_kernel = importlib.import_module("feast_tpu_torch.ops.schur_kernel")
    amgmod = importlib.import_module("feast_tpu_torch.ops.amg")
    krylov = importlib.import_module("feast_tpu_torch.ops.krylov")
    spmod = importlib.import_module("feast_tpu_torch.ops.sparse")

    # the DIA kernel outside AMG: a Jacobi-preconditioned complex64 BiCGStab
    # on the N = 200 pencil at a shift left of the spectrum
    Ks, Bs, _ = build_pencil(200)
    ns = Ks.shape[0]
    zs = -1.0 + 0.5j
    Kop = spmod.as_operator(Ks, torch.complex64, dev)
    Bop = spmod.as_operator(Bs, torch.complex64, dev)
    zt = torch.tensor(zs, dtype=torch.complex64, device=dev)
    rng = np.random.default_rng(1)
    rhs = rng.standard_normal((ns, 4)) + 1j * rng.standard_normal((ns, 4))
    dk.launches = 0
    sol = krylov.bicgstab(spmod.shifted_matvec(Kop, Bop, zt),
                          torch.as_tensor(rhs, dtype=torch.complex64, device=dev),
                          tol=1e-5, maxiter=500,
                          M=spmod.jacobi_preconditioner(Kop, Bop, zt))
    torch.cuda.synchronize()
    xs = sol.x.cpu().numpy().astype(np.complex128)
    rel = (np.linalg.norm((Ks - zs * Bs) @ xs - rhs, axis=0) / np.linalg.norm(rhs, axis=0)).max()
    require(isinstance(Kop, spmod.DIA) and dk.launches > 0,
            "sparse: the complex64 Jacobi solve did not launch the DIA kernel")
    require(bool(sol.converged.all()) and rel < 1e-4,
            f"sparse: complex64 Jacobi solve residual {rel}")
    jacobi = {"n": ns, "iters": int(sol.iters), "true_rel_residual_host_f64": float(rel),
              "dia_launches": dk.launches}

    t0 = time.perf_counter()
    K, B, lam = build_pencil(N)
    n = N * N
    c, r = lowest_slice(lam)
    exact = lam[np.abs(lam - c) <= r]
    X0 = np.random.default_rng(0)
    X0 = X0.standard_normal((n, 8)) + 1j * X0.standard_normal((n, 8))
    build_s = time.perf_counter() - t0

    kept = {}
    build_amg, rr_solver = amgmod.build_amg, krylov.bicgstab_rr
    iters_log = []

    def timed_build(*a, **k):
        t0 = time.perf_counter()
        kept["amg"] = build_amg(*a, **k)
        torch.cuda.synchronize()
        kept["setup_s"] = time.perf_counter() - t0
        return kept["amg"]

    def logged_solver(*a, **k):
        sol = rr_solver(*a, **k)
        iters_log.append(sol.iters.cpu().tolist())
        return sol

    # K4 launches by the row count of the operator (one DIA level each)
    per_level, dia_matvec = {}, dk.dia_matvec

    def counted(data, *a, **k):
        before = dk.launches
        out = dia_matvec(data, *a, **k)
        n_rows = int(data.shape[-1])
        per_level[n_rows] = per_level.get(n_rows, 0) + dk.launches - before
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    dk.launches = 0
    schur_kernel.launches = 0
    with Patched((amgmod, "build_amg", timed_build), (krylov, "bicgstab_rr", logged_solver),
                 (dk, "dia_matvec", counted)):
        t0 = time.perf_counter()
        res = ft.feast_iterative(K, B, X0, c=c, r=r, device=dev,
                                 amg_opts=sparse_amg_opts(torch), **SPARSE_KW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {"dia_spmm": dk.launches, "schur": schur_kernel.launches}
    peak = torch.cuda.max_memory_allocated(dev) / 1e9

    lamf, Xf, _ = res.filtered()
    order = np.argsort(lamf.real)
    lamf, Xf = lamf[order], Xf[:, order]
    host_res = np.linalg.norm(K @ Xf - (B @ Xf) * lamf[None, :], axis=0)
    require(res.converged, "sparse: not converged")
    require(len(lamf) == len(exact) == 6, f"sparse: {len(lamf)} inside, exact {len(exact)}")
    relerr = float(np.max(np.abs(lamf - exact) / exact))
    require(relerr < 1e-9, f"sparse: eigenvalue relative error {relerr}")
    require(np.isfinite(host_res).all() and host_res.max() < 1e-10,
            f"sparse: host residual {host_res.max()}")
    amg = kept["amg"]
    dia_rows = [L.A_op.shape[0] for L in amg.levels if isinstance(L.A_op, spmod.DIA)]
    require(launches["dia_spmm"] > 0 and all(per_level.get(r, 0) > 0 for r in dia_rows),
            f"sparse: the DIA kernel was not launched on every DIA level: {per_level}")
    emit({"phase": "sparse", "N": N, "n": n, "m0": 8, "nodes": 8,
          "inside": int(len(lamf)), "iterations": res.n_iter, "sweeps": res.n_sweeps,
          "max_eig_relerr": relerr, "max_residual_host_f64": float(host_res.max()),
          "wall_s": wall, "amg_setup_s": kept["setup_s"],
          "solve_s": wall - kept["setup_s"], "pencil_build_s": build_s,
          "per_sweep_s": (wall - kept["setup_s"]) / max(res.n_sweeps, 1),
          "launches_per_solve": launches,
          "bicgstab_iters_per_sweep_per_node": iters_log,
          "levels": [[type(L.A_op).__name__, L.A_op.shape[0],
                      getattr(L.A_op, "ndiag", None), type(L.P).__name__,
                      list(getattr(L.A_op, "offsets", ()))]
                     for L in amg.levels] + [["dense", amg.Ac.shape[0], None, None, []]],
          "formats_A_bs_P_bs_R_bs": [[x for op in (L.A_op, L.P, L.R)
                                      for x in (type(op).__name__, getattr(op, "bs", None))]
                                     for L in amg.levels],
          "dia_launches_by_rows": per_level,
          "peak_mem_gb": peak, "jacobi_complex64_n40000": jacobi})
    return launches["dia_spmm"], (K, B, X0, c, r, amg)


def phase_sparse_profile(torch, ft, dev, problem):
    """One sweep of the sparse path (Rayleigh-Ritz, then the node solves from
    a cold start) twice on the hierarchy of the `sparse` phase: once with
    host timers around its phases, each synchronized, once under
    torch.profiler."""
    amgmod = importlib.import_module("feast_tpu_torch.ops.amg")
    krylov = importlib.import_module("feast_tpu_torch.ops.krylov")
    ifmod = importlib.import_module("feast_tpu_torch.solvers.ifeast")
    dk = importlib.import_module("feast_tpu_torch.ops.dia_kernel")
    K, B, X0, c, r, amg = problem
    kw = dict(SPARSE_KW, iters=0, c=c, r=r, device=dev, amg_opts=sparse_amg_opts(torch))
    phases = {}

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

    make_precond = amgmod.shifted_preconditioner

    def timed_precond(*a, **k):
        return timer(timer(make_precond, "vcycle_setup")(*a, **k), "vcycle")

    reuse = (amgmod, "build_amg", lambda *a, **k: amg)
    with Patched(reuse, (amgmod, "shifted_preconditioner", timed_precond),
                 (krylov, "bicgstab_rr", timer(krylov.bicgstab_rr, "node_solves")),
                 (ifmod.qrmod, "orthonormalize", timer(ifmod.qrmod.orthonormalize, "orthonormalize")),
                 (ifmod.eigmod, "gen_eig", timer(ifmod.eigmod.gen_eig, "gen_eig"))):
        dk.launches = 0
        t0 = time.perf_counter()
        ft.feast_iterative(K, B, X0, **kw)
        torch.cuda.synchronize()
        wall_timed = time.perf_counter() - t0
        k4 = dk.launches
    with Patched(reuse):
        tr = traced(torch, lambda: ft.feast_iterative(K, B, X0, **kw))
    k4_kernels = [row for row in tr["kernels"] if "dia_spmm_kernel" in row[0]]
    k4_ms = sum(ms for _, _, ms in k4_kernels)
    emit({"phase": "sparse_profile", "one_sweep_timed_wall_s": wall_timed,
          "k4_device_ms": k4_ms, "k4_launches_profiled": sum(c for _, c, _ in k4_kernels),
          "k4_share_of_busy": k4_ms / 1e3 / max(tr["device_busy_s"], 1e-9),
          "phase_wall_s": {k: {"s": v[0], "calls": v[1]} for k, v in phases.items()},
          "dia_launches_one_sweep": k4,
          "profiled_wall_s": tr["wall_s"], "device_busy_s": tr["device_busy_s"],
          "device_idle_share": tr["device_idle_share"],
          "kernel_count": tr["kernel_count"], "top_kernels_ms": top_kernels(tr)})


# ---------------------------------------------------------------------------
# the nonlinear path
# ---------------------------------------------------------------------------

GUN_KW = dict(nodes=16, iters=10, c=105.0 + 0.0j, r=8.0, tol=1e-10, spurious=1e-5,
              mixed_prec=True, store=False)


def gun_host_residuals(T, lam, X):
    """||T(lam) x|| and ||T(lam) x|| / ||T(lam)||_F of each pair, in float64
    on the host from the parts: T(z) = K - z I + i sqrt(z - s1^2) W1
    + i sqrt(z - s2^2) W2 (M is the identity in planted mode)."""
    K, W1, W2 = (T.mats[j].real.cpu().numpy() for j in (0, 2, 3))
    s1, s2 = 0.0, np.sqrt(0.8 * 100.0)          # gun_like's planted branch points
    f1 = 1j * np.sqrt(lam - s1 * s1 + 0j)
    f2 = 1j * np.sqrt(lam - s2 * s2 + 0j)
    R = K @ X - X * lam + f1 * (W1 @ X) + f2 * (W2 @ X)
    mats = [K, np.eye(K.shape[0]), W1, W2]
    G = np.array([[np.vdot(a, b) for b in mats] for a in mats])
    co = np.stack([np.ones_like(lam), -lam, f1, f2])
    fro = np.sqrt(np.einsum("jm,jk,km->m", co.conj(), G, co).real)
    absres = np.linalg.norm(R, axis=0)
    return absres, absres / fro


def phase_nonlinear(torch, ft, dev):
    """The reference's gun configuration: N = 9956, m0 = 84, 16 nodes."""
    panel_lu = importlib.import_module("feast_tpu_torch.ops.panel_lu")
    schur_kernel = importlib.import_module("feast_tpu_torch.ops.schur_kernel")
    nlmod = importlib.import_module("feast_tpu_torch.solvers.nlfeast")
    lumod = nlmod.lumod
    n, m0 = GUN_N, GUN_M0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    T = ft.problems.gun_like(n, seed=0, planted=25, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)                 # as benchmarks/gun.py draws it
    X0 = rng.standard_normal((n, m0)) + 1j * rng.standard_normal((n, m0))

    def solve():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = ft.nlfeast(T, X0, device=dev, **GUN_KW)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev) / 1e9     # T's 4 n^2 complex128 among it
    panel_lu.launches = 0
    schur_kernel.launches = 0
    out, cold_s = solve()
    launches = {"panel_lu": panel_lu.launches, "schur": schur_kernel.launches}
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    out, warm_s = solve()

    # a third solve with each driver phase synchronized and timed
    phases = {}

    def timer(fn, name):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*a, **k)
            torch.cuda.synchronize()
            tot, cnt = phases.get(name, (0.0, 0))
            phases[name] = (tot + time.perf_counter() - t0, cnt + 1)
            return res
        return run

    extract, extract_args = nlmod._extract, []

    def kept(*a):
        extract_args.append(a)
        return extract(*a)

    with Patched((T, "eval_nodes", timer(T.eval_nodes, "evaluate")),
                 (lumod, "lu_factor_inplace", timer(lumod.lu_factor_inplace, "factor")),
                 (lumod, "lu_diag_inv", timer(lumod.lu_diag_inv, "factor")),
                 (nlmod, "_node_solve", timer(nlmod._node_solve, "solve_refine")),
                 (nlmod, "_extract", timer(kept, "extract"))):
        _, timed_s = solve()
    profiled = {}
    for name, fn in (("solve", solve), ("extract_alone", lambda: extract(*extract_args[0]))):
        tr = traced(torch, fn)
        profiled[name] = dict({k: tr[k] for k in ("wall_s", "device_busy_s",
                                                  "device_idle_share", "cuda_launch_calls",
                                                  "kernel_count")},
                              top_kernels_ms=top_kernels(tr, 8, 60))

    lam, X, res = out.filtered(spurious=GUN_KW["spurious"])
    absres, relres = gun_host_residuals(T, lam, X)
    require(out.converged, "nonlinear: not converged")
    require(len(lam) == 25, f"nonlinear: {len(lam)} non-spurious eigenvalues inside, 25 planted")
    require(np.isfinite(absres).all() and relres.max() < GUN_KW["tol"]
            and absres.max() < 1e-10,
            f"nonlinear: host residual {absres.max()} (relative {relres.max()})")
    require(launches["panel_lu"] > 0 and launches["schur"] > 0,
            f"nonlinear: kernel launches {launches}")
    emit({"phase": "nonlinear", "n": n, "m0": m0, "nodes": 16, "c": 105.0, "r": 8.0,
          "tol": GUN_KW["tol"], "inside_nonspurious": int(len(lam)),
          "sweeps": out.n_iter, "max_residual_solver": float(res.max()),
          "max_residual_host_f64": float(absres.max()),
          "max_relative_residual_host_f64": float(relres.max()),
          "build_s": build_s, "cold_s": cold_s, "warm_s": warm_s,
          "timed_s": timed_s,
          "phase_wall_s": {k: {"s": v[0], "calls": v[1]} for k, v in phases.items()},
          "launches_per_solve": launches, "allocated_before_solve_gb": before,
          "peak_mem_gb": peak, "profile": profiled,
          "eigenvalues_real": np.sort(lam.real).tolist()})
    return launches




def _match_within(a, b, tol, what):
    require(len(a) == len(b), f"{what}: {len(a)} eigenvalues against {len(b)}")
    err = _match_err(np.asarray(a), np.asarray(b)) if len(a) else 0.0
    require(err < tol, f"{what}: eigenvalues differ by {err}")
    return err


def phase_nonlinear_small(torch, ft, dev, inside_main=None, n=2048, bench_n=4096):
    """The other nonlinear entry points at cut sizes: beyn, block_ss and
    nlfeast_moments on gun_like(2048) against nlfeast there; companion on
    butterfly(6) against scipy; the stochastic count on the dense headline's
    matrix with complex64 factors (the panel kernel at n = 4096), against
    the count the main phase found inside (LAPACK's when main did not run)."""
    import scipy.linalg as sla

    panel_lu = importlib.import_module("feast_tpu_torch.ops.panel_lu")
    out = {"phase": "nonlinear_small"}
    c, r = 105.0 + 0.0j, 8.0
    T = ft.problems.gun_like(n, seed=0, planted=25, device=dev)
    rng = np.random.default_rng(0)
    X0 = rng.standard_normal((n, 40)) + 1j * rng.standard_normal((n, 40))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    ref, t_ref = timed(lambda: ft.nlfeast(T, X0, device=dev, **GUN_KW))
    lam_ref, _, _ = ref.filtered(spurious=1e-5)
    require(ref.converged and len(lam_ref) == 25, f"nonlinear_small: nlfeast found {len(lam_ref)}")
    out["nlfeast"] = {"n": n, "m0": 40, "sweeps": ref.n_iter, "s": t_ref}
    # single shot on 32 nodes: the holomorphic remainder's quadrature error
    # decays as (r / 25)^N, 25 the distance to the branch point s2^2 = 80
    b, t_b = timed(lambda: ft.beyn(T, X0, nodes=32, c=c, r=r, relative_res=True, device=dev))
    lb, rb = b.lam.cpu().numpy(), b.res.cpu().numpy()
    good = (np.abs(lb - c) <= r) & (rb < 1e-6)
    out["beyn"] = {"nodes": 32, "m0": 40, "s": t_b,
                   "eig_err_vs_nlfeast": _match_within(lb[good], lam_ref, 1e-8, "beyn")}
    ss, t_ss = timed(lambda: ft.block_ss(T, X0[:, :20], nodes=32, moments=2, c=c, r=r,
                                         device=dev))
    ls, rs = ss.lam.cpu().numpy(), ss.res.cpu().numpy()
    good = (np.abs(ls - c) <= r) & (rs < 1e-6)
    out["block_ss"] = {"nodes": 32, "m0": 20, "moments": 2, "s": t_ss,
                       "eig_err_vs_nlfeast": _match_within(ls[good], lam_ref, 1e-8, "block_ss")}
    mo, t_mo = timed(lambda: ft.nlfeast_moments(T, X0[:, :20], nodes=16, iters=10, moments=2,
                                                c=c, r=r, tol=1e-10, spurious=1e-5,
                                                device=dev))
    lm, _, rm = mo.filtered(spurious=1e-5)
    require(mo.converged and rm.max() < 1e-10, f"nonlinear_small: moments residual {rm.max()}")
    out["nlfeast_moments"] = {"nodes": 16, "m0": 20, "moments": 2, "s": t_mo,
                              "sweeps": mo.n_iter,
                              "eig_err_vs_nlfeast": _match_within(lm, lam_ref, 1e-8, "moments")}
    del T

    # butterfly on a 6 x 6 grid (N L = 144): the plain complex128 Schur of the
    # 8 x 8 one (N L = 256) took 60-120 s of the script's time limit
    _, coeffs = ft.problems.butterfly(6, device=dev)
    comp, t_c = timed(lambda: ft.companion(coeffs, device=dev))
    N, L = coeffs[0].shape[0], len(coeffs) - 1
    C1 = np.zeros((N * L, N * L), dtype=np.complex128)
    C2 = np.zeros_like(C1)
    C1[:N, :N] = coeffs[0]
    for i in range(N, N * L):
        C1[i, i] = 1.0
        C2[i, i - N] = 1.0
    for i in range(L):
        C2[:N, N * i:N * (i + 1)] = -coeffs[i + 1]
    want = sla.eigvals(C1, C2)
    got = comp.lam.cpu().numpy()
    scale = float(np.abs(want).max())
    out["companion"] = {"N": N, "degree": L, "s": t_c,
                        "eig_err_vs_scipy_rel": _match_within(got, want, 1e-10 * scale,
                                                              "companion") / scale,
                        "max_relative_residual": float(comp.res.max())}
    require(float(comp.res.max()) < 1e-10, f"companion: residual {float(comp.res.max())}")

    A, _, c0, r0 = bench_problem(n=bench_n)
    k = ft.circular_contour_trapezoidal(c0, r0, 16)
    panel_lu.launches = 0
    est, t_e = timed(lambda: ft.contour_estimate_eig(A, k, samples=100, seed=0,
                                                     mixed_prec=True, device=dev))
    if inside_main is None:
        inside_main = int((np.abs(np.linalg.eigvals(A) - c0) <= r0).sum())
    require(panel_lu.launches > 0, "contour_estimate_eig: the panel kernel was not launched")
    # Hutchinson's estimate with 100 probes: standard deviation near 1 here
    require(abs(est - inside_main) <= 5,
            f"contour_estimate_eig: {est} against {inside_main} inside")
    out["contour_estimate_eig"] = {"n": A.shape[0], "samples": 100, "estimate": est,
                                   "inside": inside_main, "s": t_e,
                                   "panel_lu_launches": panel_lu.launches}
    emit(out)


# ---------------------------------------------------------------------------
# the other dense drivers, fastdiag, and the unstructured pencil (BELL)
# ---------------------------------------------------------------------------

def _inside_sorted(res):
    lam, X, _ = res.filtered()
    order = np.argsort(lam.real)
    return lam[order], X[:, order]


def hermitian_problem(n=4096):
    """diag(1..n) + 0.05 (G + G^H) / 2, G complex Gaussian from seed 0."""
    G = np.random.default_rng(0)
    G = G.standard_normal((n, n)) + 1j * G.standard_normal((n, n))
    return np.diag(np.arange(1.0, n + 1.0)) + 0.05 * (G + G.conj().T) / 2


def phase_dense_variants(torch, ft, dev, refs, n=4096):
    """The dense drivers' other options on bench.py's headline problem
    (n = 4096, m0 = 48, 16 nodes, c = 20, r = 22, tol 1e-10, mixed_prec):
    feast(store=True) stacked, then node_loop=True and rr="host", each held
    to the stacked solve (the same iteration count, inside eigenvalues to
    1e-10); hermitian=True on diag(1..n) + 0.05 (G + G^H) / 2 (G from seed
    0) against numpy's eigvalsh; dual_gen_feast(mixed_prec=True) with B = I,
    right and left residuals recomputed on the host in float64.  Each case
    counts its panel-kernel and Schur-kernel launches."""
    panel_lu = importlib.import_module("feast_tpu_torch.ops.panel_lu")
    schur_kernel = importlib.import_module("feast_tpu_torch.ops.schur_kernel")
    A, X0, c, r = bench_problem(n=n)
    At, Xt = torch.as_tensor(A, device=dev), torch.as_tensor(X0, device=dev)
    kw = dict(c=c, r=r, nodes=16, iters=20, tol=1e-10, mixed_prec=True, device=dev)
    cases = {}

    def run(label, fn):
        panel_lu.launches = schur_kernel.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        cases[label] = {"wall_s": time.perf_counter() - t0, "iterations": res.n_iter,
                        "converged": bool(res.converged),
                        "k1_launches": panel_lu.launches, "k2_launches": schur_kernel.launches,
                        "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
        require(res.converged, f"dense_variants: {label} not converged")
        require(panel_lu.launches > 0, f"dense_variants: {label} launched no panel kernel")
        return res

    stacked = run("stacked", lambda: ft.feast(At, Xt, store=True, **kw))
    lam_s, _ = _inside_sorted(stacked)
    require(schur_kernel.launches > 0, "dense_variants: stacked launched no Schur kernel")
    for label, extra in (("node_loop", {"node_loop": True}), ("rr_host", {"rr": "host"})):
        res = run(label, lambda: ft.feast(At, Xt, store=True, **extra, **kw))
        lam, X = _inside_sorted(res)
        rr = np.linalg.norm(A @ X - X * lam[None, :], axis=0)
        diff = float(np.max(np.abs(lam - lam_s))) if len(lam) == len(lam_s) else np.inf
        cases[label].update(inside=int(len(lam)), max_diff_vs_stacked=diff,
                            max_residual_host_f64=float(rr.max()))
        require(res.n_iter == stacked.n_iter and diff < 1e-10,
                f"dense_variants: {label} n_iter {res.n_iter} vs {stacked.n_iter}, "
                f"eigenvalues {diff} from the stacked solve")
        require(rr.max() < 1e-10, f"dense_variants: {label} host residual {rr.max()}")
    require(cases["node_loop"]["k2_launches"] > 0,
            "dense_variants: node_loop launched no Schur kernel")
    cases["stacked"]["inside"] = int(len(lam_s))

    H = hermitian_problem(n)
    t0 = time.perf_counter()
    ref = np.linalg.eigvalsh(H)
    ref_s = time.perf_counter() - t0
    refs["eigvalsh"] = ref
    ref = ref[np.abs(ref - c) <= r]
    Ht = torch.as_tensor(H, device=dev)
    res = run("hermitian", lambda: ft.feast(Ht, Xt, hermitian=True, **kw))
    lam, X = _inside_sorted(res)
    require(len(lam) == len(ref), f"dense_variants: hermitian {len(lam)} inside, eigvalsh {len(ref)}")
    err = float(np.max(np.abs(lam - ref)))
    rr = np.linalg.norm(H @ X - X * lam[None, :], axis=0)
    require(err < 1e-10 and rr.max() < 1e-10,
            f"dense_variants: hermitian eigenvalues {err} from eigvalsh, residual {rr.max()}")
    cases["hermitian"].update(inside=int(len(lam)), max_err_vs_eigvalsh=err,
                              max_residual_host_f64=float(rr.max()), eigvalsh_host_s=ref_s)
    del Ht, H

    It = torch.eye(n, dtype=torch.complex128, device=dev)
    res = run("dual", lambda: ft.dual_gen_feast(At, It, Xt, Xt.clone(), **kw))
    lam, Xr, Xl, _ = res.filtered()
    right = np.linalg.norm(A @ Xr - Xr * lam[None, :], axis=0)
    left = np.linalg.norm(Xl.conj().T @ A - lam[:, None] * Xl.conj().T, axis=1)
    require(len(lam) == len(lam_s), f"dense_variants: dual {len(lam)} inside, stacked {len(lam_s)}")
    require(right.max() < 1e-10 and left.max() < 1e-8,
            f"dense_variants: dual right {right.max()}, left {left.max()}")
    cases["dual"].update(inside=int(len(lam)), max_right_residual_host_f64=float(right.max()),
                         max_left_residual_host_f64=float(left.max()))
    emit({"phase": "dense_variants", "n": n, "m0": 48, "nodes": 16, "tol": 1e-10,
          "cases": cases})


def phase_fastdiag(torch, ft, dev, refs, N=1000):
    """The sparse phase's 1M-dof pencil and slice, with the node solves
    preconditioned by fast diagonalization (`ops/fastdiag.py`, form "kron",
    float32 transforms) instead of AMG: benchmarks/sparse1m.py's --fd
    configuration."""
    fastdiag = importlib.import_module("feast_tpu_torch.ops.fastdiag")
    krylov = importlib.import_module("feast_tpu_torch.ops.krylov")
    schur_kernel = importlib.import_module("feast_tpu_torch.ops.schur_kernel")
    K, B, lam = build_pencil(N)
    T1, M1 = grid_factors(N)
    c, r = lowest_slice(lam)
    exact = lam[np.abs(lam - c) <= r]
    X0 = np.random.default_rng(0)
    X0 = X0.standard_normal((N * N, 8)) + 1j * X0.standard_normal((N * N, 8))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    fd = fastdiag.build(A1=T1, B1=M1, form="kron", dtype=torch.float32, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    iters_log, rr_solver = [], krylov.bicgstab_rr

    def logged_solver(*a, **k):
        sol = rr_solver(*a, **k)
        iters_log.append(sol.iters.cpu().tolist())
        return sol

    kw = {k: v for k, v in SPARSE_KW.items() if k != "precondition"}
    schur_kernel.launches = 0
    with Patched((krylov, "bicgstab_rr", logged_solver)):
        t0 = time.perf_counter()
        res = ft.feast_iterative(K, B, X0, c=c, r=r, device=dev,
                                 precondition=fastdiag.preconditioner(fd), **kw)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
    lamf, Xf = _inside_sorted(res)
    host_res = np.linalg.norm(K @ Xf - (B @ Xf) * lamf[None, :], axis=0)
    require(res.converged, "fastdiag: not converged")
    require(len(lamf) == len(exact) == 6, f"fastdiag: {len(lamf)} inside, exact {len(exact)}")
    relerr = float(np.max(np.abs(lamf - exact) / exact))
    require(relerr < 1e-9, f"fastdiag: eigenvalue relative error {relerr}")
    require(np.isfinite(host_res).all() and host_res.max() < 1e-10,
            f"fastdiag: host residual {host_res.max()}")
    require(schur_kernel.launches > 0, "fastdiag: the Rayleigh-Ritz launched no Schur kernel")
    emit({"phase": "fastdiag", "N": N, "n": N * N, "m0": 8, "nodes": 8,
          "inside": int(len(lamf)), "iterations": res.n_iter, "sweeps": res.n_sweeps,
          "max_eig_relerr": relerr, "max_residual_host_f64": float(host_res.max()),
          "setup_s": setup_s, "solve_s": solve_s,
          "bicgstab_iters_per_sweep_per_node": iters_log,
          "k2_launches": schur_kernel.launches,
          "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9})
    refs["fastdiag"] = {"lam": lamf, "n_sweeps": res.n_sweeps, "n_iter": res.n_iter}


def _level_format(spmod, op):
    """Format of one AMG level operator: [kind, rows, bs, kmax, fill, spill nnz]."""
    if isinstance(op, spmod.BELL):
        spill = 0 if op.spill is None else op.spill.nnz
        stored = op.data.shape[-3] * op.data.shape[-2] * op.data.shape[-1]
        nnz = int(op.data.count_nonzero()) + spill
        return ["BELL", op.shape[0], op.bs, op.kmax, stored / max(nnz, 1), spill]
    return [type(op).__name__, op.shape[0], None, None, None, None]


UNSTRUCTURED_KW = dict(nodes=8, tol=1e-10, precondition="amg", solver="bicgstab_rr",
                      solve_tol=1e-9, solve_iters=200)


def unstructured_problem(ft, n_points=100_000):
    """benchmarks/unstructured100k.py's pencil (seed 1), its lowest slice
    from scipy's shift-invert eigsh, and X0 (n, 10) from seed 3:
    (K, M, c, r, want, X0, build seconds, eigsh seconds)."""
    import scipy.sparse.linalg as spl

    t0 = time.perf_counter()
    K, M, _ = ft.problems.fem2d_unstructured(n_points, seed=1)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    exact = np.sort(spl.eigsh(K.real.tocsc(), k=10, M=M.real.tocsc(), sigma=0,
                              which="LM", return_eigenvectors=False))
    exact_s = time.perf_counter() - t0
    c = (exact[0] + exact[5]) / 2
    r = (exact[5] - exact[0]) / 2 + 0.4 * (exact[6] - exact[5])
    rng = np.random.default_rng(3)
    X0 = rng.standard_normal((K.shape[0], 10)) + 1j * rng.standard_normal((K.shape[0], 10))
    return (K, M, complex(c), float(r), exact[np.abs(exact - c) <= r], X0, build_s,
            exact_s)


def check_unstructured(label, res, K, M, want, ref):
    """Converged to the exact slice (1e-9 relative), host residuals below
    1e-10, and, given the in-process result `ref`, its inside count and
    sweeps with eigenvalues within 1e-10 relative.  Returns the check's
    numbers."""
    lamf, Xf = _inside_sorted(res)
    host_res = np.linalg.norm(K @ Xf - (M @ Xf) * lamf[None, :], axis=0)
    require(res.converged, f"{label}: not converged")
    require(len(lamf) == len(want), f"{label}: {len(lamf)} inside, exact {len(want)}")
    relerr = float(np.max(np.abs(lamf.real - want) / want))
    require(relerr < 1e-9, f"{label}: eigenvalue relative error {relerr}")
    require(np.isfinite(host_res).all() and host_res.max() < 1e-10,
            f"{label}: host residual {host_res.max()}")
    out = {"inside": int(len(lamf)), "sweeps": res.n_sweeps, "max_eig_relerr": relerr,
           "max_residual_host_f64": float(host_res.max())}
    if ref is not None:
        diff = float(np.max(np.abs(lamf - ref["lam"]) / np.abs(ref["lam"])))
        require(res.n_sweeps == ref["n_sweeps"] and diff < 1e-10,
                f"{label}: {res.n_sweeps} sweeps against {ref['n_sweeps']}, eigenvalues "
                f"{diff} relative from the in-process solve")
        out["max_relerr_vs_in_process"] = diff
    return out


def phase_unstructured(torch, ft, dev, refs, n_points=100_000):
    """benchmarks/unstructured100k.py in process: the lowest slice of the P1
    FEM pencil on a Delaunay triangulation of 100,000 random points (n =
    99,975), m0 = 10, 8 nodes, tol 1e-10, reorder="auto" (RCM, then BELL),
    AMG with a complex64 V-cycle, bicgstab_rr (solve_tol 1e-9, 200
    iterations), node_chunk 1, at most 10 sweeps; the exact slice by scipy's
    shift-invert eigsh.  Prints each AMG level's format and the BELL
    product's time at level 0 for every candidate block size, beside the
    port's CSR product and torch.sparse.mm."""
    spmod = importlib.import_module("feast_tpu_torch.ops.sparse")
    amgmod = importlib.import_module("feast_tpu_torch.ops.amg")
    krylov = importlib.import_module("feast_tpu_torch.ops.krylov")
    rdmod = importlib.import_module("feast_tpu_torch.ops.reorder")
    panel_lu = importlib.import_module("feast_tpu_torch.ops.panel_lu")
    schur_kernel = importlib.import_module("feast_tpu_torch.ops.schur_kernel")
    K, M, c, r, want, X0, build_s, exact_s = unstructured_problem(ft, n_points)
    refs["unstructured_problem"] = (K, M, c, r, want, X0)
    n = K.shape[0]

    kept, iters_log = {}, []
    build_amg, rr_solver = amgmod.build_amg, krylov.bicgstab_rr

    def timed_build(*a, **k):
        t0 = time.perf_counter()
        kept["amg"] = build_amg(*a, **k)
        torch.cuda.synchronize()
        kept["setup_s"] = time.perf_counter() - t0
        return kept["amg"]

    def logged_solver(*a, **k):
        sol = rr_solver(*a, **k)
        iters_log.append(sol.iters.cpu().tolist())
        return sol

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    panel_lu.launches = schur_kernel.launches = 0
    with Patched((amgmod, "build_amg", timed_build), (krylov, "bicgstab_rr", logged_solver)):
        t0 = time.perf_counter()
        res = ft.feast_iterative(K, M, X0, c=c, r=r, iters=10, reorder="auto",
                                 node_chunk=1, amg_opts={"dtype": torch.float32},
                                 device=dev, **UNSTRUCTURED_KW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {"panel_lu": panel_lu.launches, "schur": schur_kernel.launches}
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    checked = check_unstructured("unstructured", res, K, M, want, None)
    refs["unstructured"] = {"lam": _inside_sorted(res)[0], "n_sweeps": res.n_sweeps}
    require(launches["panel_lu"] > 0 and launches["schur"] > 0,
            f"unstructured: kernel launches {launches}")
    amg = kept["amg"]
    levels = [_level_format(spmod, L.A_op) + [type(L.P).__name__] for L in amg.levels]
    levels.append(["dense", amg.Ac.shape[0], None, None, None, None, None])
    require(any(row[0] == "BELL" for row in levels), f"unstructured: no BELL level: {levels}")

    # the level-0 product of the V-cycle (one node, m0 = 10 columns, complex64)
    # at every candidate block size, on the pencil as the driver permutes it
    perm, _ = rdmod.plan_reorder(K, M)
    Kp = K if perm is None else K[perm][:, perm].tocsr()
    Xd = torch.randn((1, n, 10), dtype=torch.complex64, device=dev)
    bell_ms = {}
    for bs in spmod._BELL_CANDIDATE_BS:
        op = spmod.BELL.from_scipy(Kp, bs, torch.complex64, device=dev)
        op.matvec(Xd)
        bell_ms[bs] = {"ms": cuda_ms(lambda: op.matvec(Xd), reps=20), "kmax": op.kmax,
                       "spill_nnz": 0 if op.spill is None else op.spill.nnz}
        del op
    Kcsr = torch.sparse_csr_tensor(torch.as_tensor(Kp.indptr, device=dev),
                                   torch.as_tensor(Kp.indices, device=dev),
                                   torch.as_tensor(Kp.data, dtype=torch.complex64, device=dev),
                                   Kp.shape)
    torch.sparse.mm(Kcsr, Xd[0])         # warm: the library's handle
    csr_ms = cuda_ms(lambda: torch.sparse.mm(Kcsr, Xd[0]), reps=20)
    csr_port = spmod.CSR.from_scipy(Kp, torch.complex64, dev)
    csr_port.matvec(Xd)
    csr_port_ms = cuda_ms(lambda: csr_port.matvec(Xd), reps=20)
    emit({"phase": "unstructured", "n": n, "nnz": int(K.nnz), "m0": 10, "nodes": 8,
          "want": int(len(want)), "iterations": res.n_iter, **checked, "wall_s": wall,
          "amg_setup_s": kept["setup_s"], "solve_s": wall - kept["setup_s"],
          "pencil_build_s": build_s, "eigsh_s": exact_s,
          "levels_kind_rows_bs_kmax_fill_spill_P": levels,
          "picked_bs_level0": spmod.bell_pick_bs(Kp, torch.complex64),
          "bell_level0_ms_by_bs": bell_ms, "torch_sparse_csr_mm_ms": csr_ms,
          "port_csr_ms": csr_port_ms,
          "bicgstab_iters_per_sweep_per_node": iters_log,
          "launches_per_solve": launches, "peak_mem_gb": peak})


# ---------------------------------------------------------------------------
# the checkpointing orchestrator and the parallel layer
# ---------------------------------------------------------------------------

def phase_orchestrate(torch, ft, dev, refs, smi):
    """benchmarks/unstructured100k.py's default mode: the `unstructured`
    configuration through `feast_iterative_checkpointed` (worker
    subprocesses on the card, sweeps_per_worker covering every sweep,
    node_chunk 1 with chunk checkpoints), the first worker killed right after
    chunk 3 of sweep 1 (FEAST_ORCH_CRASH_AFTER_CHUNK): exactly one restart,
    which resumes sweep 1 at chunk 4, and the in-process result (sweeps,
    inside count, eigenvalues to 1e-10 relative).  The checkpoint
    directory is a temporary one."""
    import os
    import shutil
    import tempfile

    orch = importlib.import_module("feast_tpu_torch.orchestrate")
    if "unstructured" not in refs:
        phase_unstructured(torch, ft, dev, refs)
    K, M, c, r, want, X0 = refs["unstructured_problem"]
    cdir = tempfile.mkdtemp(prefix="feast_orchestrate_")
    ok = False
    try:
        marker = os.path.join(cdir, "crash.marker")
        t0 = time.perf_counter()
        res = orch.feast_iterative_checkpointed(
            K, M, X0, checkpoint_dir=os.path.join(cdir, "ck"), c=c, r=r, max_sweeps=10,
            max_restarts=2, sweeps_per_worker=10, amg_f32=True, reorder="auto",
            node_chunk=1, device="cuda", verbose=False,
            worker_env={"FEAST_ORCH_CRASH_AFTER_CHUNK": marker + ":3"}, **UNSTRUCTURED_KW)
        wall = time.perf_counter() - t0
        with open(os.path.join(cdir, "ck", "log.jsonl")) as f:
            log = [json.loads(ln) for ln in f]
        ok = True
    finally:
        if not ok:        # the last worker's output, before the directory goes
            print("".join(orch._tail_lines(os.path.join(cdir, "ck", "worker.log"), 40)),
                  file=sys.stderr)
        shutil.rmtree(cdir, ignore_errors=True)
    checked = check_unstructured("orchestrate", res, K, M, want, refs["unstructured"])
    restarts = [e for e in log if e["event"] == "worker_restart"]
    resumed = [e["resumed_from_chunk"] for e in log if "resumed_from_chunk" in e]
    require(len(restarts) == 1 and resumed == [4],
            f"orchestrate: {len(restarts)} restarts, resumed from chunks {resumed}")
    # a worker's wall: from the run's start or the previous worker's end
    ends = [e["t"] for e in log if e["event"] in ("worker_restart", "done")]
    starts = [log[0]["t"]] + ends[:-1]
    emit({"phase": "orchestrate", "n": K.shape[0], "card": smi, "wall_s": wall,
          "restarts": len(restarts), "resumed_from_chunk": resumed,
          "worker_walls_s": [round(b - a, 1) for a, b in zip(starts, ends)],
          "sweep_s": [e["sweep_s"] for e in log if e["event"] == "sweep"], **checked})


class Split:
    """Inside the block, the stacked-slice driver's stochastic count
    (`spectral_slices`) and factor (the program's `_factor_into`) are
    timed, each synchronized at its end; `s`
    holds the seconds of the last call.  The count also resets the peak
    memory statistics at its end, with the memory then allocated in
    `base`: the peak after it is the factor's and the loop's."""

    def __init__(self, torch, sl):
        self.torch, self.sl, self.s, self.base = torch, sl, {}, 0
        self.names = {"spectral_slices": "spectral_slices", "_factor_into": "factor"}

    def _timed(self, fn, key):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            self.torch.cuda.synchronize()
            self.s[key] = self.s.get(key, 0.0) + time.perf_counter() - t0
            if key == "spectral_slices":
                self.base = self.torch.cuda.memory_allocated()
                self.torch.cuda.reset_peak_memory_stats()
            return out
        return run

    def __enter__(self):
        self.saved = {name: getattr(self.sl, name) for name in self.names}
        for name, key in self.names.items():
            setattr(self.sl, name, self._timed(self.saved[name], key))
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.sl, name, fn)


def sliced_read_cost_ms(torch, prog, sweeps, reps=2):
    """`read_cost_ms` for the sliced program: its two graphs replayed
    `sweeps` times with the (2, S) status read between them and without,
    best of reps each, in turns; ms per sweep."""
    def sweep_loop(read):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(sweeps):
            out = prog._step("rr")
            if read:
                prog._read(out["status"])
            prog._step("update")
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    walls = {True: [], False: []}
    for _ in range(reps):
        for read in (True, False):
            walls[read].append(sweep_loop(read))
    return (min(walls[True]) - min(walls[False])) / sweeps * 1e3


def counted_call(torch, calls):
    """call(label, fn, k1=True): fn() synchronized, its wall, K1 and K2
    launches and peak memory over the start into calls[label]; raises
    unless K2 (and K1 where k1) launched."""
    from feast_tpu_torch.ops import panel_lu, schur_kernel

    def call(label, fn, k1=True):
        panel_lu.launches = schur_kernel.launches = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        calls[label] = {"wall_s": time.perf_counter() - t0,
                        "k1_launches": panel_lu.launches,
                        "k2_launches": schur_kernel.launches,
                        "peak_over_start_gb": (torch.cuda.max_memory_allocated()
                                               - before) / 1e9}
        require(schur_kernel.launches > 0 and (panel_lu.launches > 0 or not k1),
                f"parallel: {label} launches {calls[label]}")
        return res
    return call


def parallel_surface(torch, ft, world, reps=2):
    """The JAX package's spellings of the row-reduced QR, cmatmul's
    precision and pytree sharding on the card, each held and timed on
    this rank: orthonormalize and cholqr2 with psum_axis="row" on a
    (1, world) ("node", "row") mesh bound by bind_mesh, on the headline's
    shape (n = 4096, m0 = 48, complex128; orthonormalize's columns over
    1 .. 1e-200), gathered, against the unsharded call on the whole
    matrix to 1e-13 relative; cx.cmatmul(precision="default") bit for bit
    cx.cmatmul under the "torch" and "cuda" GEMM backends (the latter
    K3's launches, counted nowhere); shard_nodes and replicate of a
    nested tuple keeping its structure.  Seconds are the best of `reps`
    synchronized calls."""
    from feast_tpu_torch import cx
    from feast_tpu_torch.ops import qr
    from feast_tpu_torch.parallel import mesh as pmesh

    def best(fn):
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return out, min(walls)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    n, m = 4096, 48
    gen = torch.Generator(device="cuda").manual_seed(11)
    A = torch.randn((n, m), dtype=torch.complex128, device="cuda", generator=gen)
    wide = A * torch.logspace(0, -200, m, dtype=torch.float64, device="cuda")
    rmesh = ft.parallel.node_row_mesh(1, world, device_type="cuda")
    out = {"shape": [n, m], "mesh": {"node": 1, "row": world}}
    with pmesh.bind_mesh(rmesh):
        Qb, out["orthonormalize_row_s"] = best(lambda: qr.orthonormalize(
            ft.parallel.shard_rows(wide, rmesh), psum_axis="row"))
        (Q2b, R2), out["cholqr2_row_s"] = best(lambda: qr.cholqr2(
            ft.parallel.shard_rows(A, rmesh), psum_axis="row"))
    Q, t_q = best(lambda: qr.orthonormalize(wide))
    Q2, R2_ref = qr.cholqr2(A)
    out["orthonormalize_s"] = t_q
    out["orthonormalize_relerr"] = rel(pmesh.all_gather(Qb, rmesh, "row"), Q)
    out["cholqr2_relerr"] = max(rel(pmesh.all_gather(Q2b, rmesh, "row"), Q2),
                                rel(R2, R2_ref))
    out["orthonormalize_orth_err"] = float(
        (Q.mH @ Q - torch.eye(m, dtype=Q.dtype, device="cuda")).abs().max())
    require(out["orthonormalize_relerr"] < 1e-13 and out["cholqr2_relerr"] < 1e-13
            and not R2.is_conj(),
            f"parallel surface: row-reduced QR against the unsharded call {out}")

    a = torch.randn((16, 3968, 128), dtype=torch.complex64, device="cuda", generator=gen)
    b = torch.randn((16, 128, 48), dtype=torch.complex64, device="cuda", generator=gen)
    try:
        for backend in ("torch", "cuda"):
            cx.set_gemm_backend(backend)
            plain, _ = best(lambda: cx.cmatmul(a, b))
            got, out[f"cmatmul_default_{backend}_s"] = best(
                lambda: cx.cmatmul(a, b, precision="default"))
            require(torch.equal(got, plain),
                    f"parallel surface: cmatmul(precision='default') differs from "
                    f"cmatmul under the {backend!r} backend")
    finally:
        cx.set_gemm_backend("torch")
    out["cmatmul_shape"] = [16, 3968, 128, 48]

    z = torch.arange(world * 2, dtype=torch.float64, device="cuda").to(torch.complex128)
    tree = (z, (z.real, None), [z * 2])
    got = ft.parallel.shard_nodes(tree, ft.parallel.node_mesh(device_type="cuda"))
    rep = ft.parallel.replicate({"t": tree}, ft.parallel.node_mesh(device_type="cuda"))
    k = torch.distributed.get_rank()
    require(isinstance(got, tuple) and got[1][1] is None and isinstance(got[2], list)
            and torch.equal(got[0], z[2 * k:2 * k + 2])
            and torch.equal(got[2][0], 2 * z[2 * k:2 * k + 2])
            and list(rep) == ["t"] and rep["t"][1][1] is None
            and torch.equal(rep["t"][1][0], z.real),
            "parallel surface: shard_nodes / replicate lost the tuple's structure")
    return out


def parallel_rank(rank, world, store, refs, smi):
    """One rank of the `parallel` phase (NCCL, one card a rank): the mesh=
    calls of the slice, each checked against its single-process reference
    in `refs`, each call's K1 and K2 launches counted on this rank."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    import feast_tpu_torch as ft
    from feast_tpu_torch.ops import fastdiag

    fmod = importlib.import_module("feast_tpu_torch.solvers.feast")
    dist.init_process_group("nccl", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    try:
        mesh = ft.parallel.node_mesh(device_type="cuda")
        t0 = time.perf_counter()
        surface = parallel_surface(torch, ft, world)
        surface["wall_s"] = time.perf_counter() - t0
        if rank == 0:
            emit({"phase": "parallel_surface", "world": world, "card": smi, **surface})
        calls = {}
        call = counted_call(torch, calls)
        parallel_compiled(torch, ft, fmod, mesh, refs, calls, call)

        N = 1000
        K, B, lam_exact = build_pencil(N)
        T1, M1 = grid_factors(N)
        c, r = lowest_slice(lam_exact)
        X0 = np.random.default_rng(0)
        X0 = X0.standard_normal((N * N, 8)) + 1j * X0.standard_normal((N * N, 8))
        fd = fastdiag.build(A1=T1, B1=M1, form="kron", dtype=torch.float32, device="cuda")
        kw = {k: v for k, v in SPARSE_KW.items() if k != "precondition"}
        # fastdiag factors nothing: this call's path has no panel kernel
        res = call("feast_iterative", lambda: ft.feast_iterative(
            K, B, X0, c=c, r=r, mesh=mesh, precondition=fastdiag.preconditioner(fd),
            device="cuda", **kw),
            k1=False)
        lam, _ = _inside_sorted(res)
        ref = refs["fastdiag"]
        diff = (float(np.max(np.abs(lam - ref["lam"]) / np.abs(ref["lam"])))
                if len(lam) == len(ref["lam"]) else np.inf)
        require(res.converged and res.n_sweeps == ref["n_sweeps"] and diff < 1e-10,
                f"parallel: feast_iterative {res.n_sweeps} sweeps against "
                f"{ref['n_sweeps']}, eigenvalues {diff} relative from fastdiag's")
        calls["feast_iterative"].update(sweeps=res.n_sweeps, inside=len(lam),
                                        max_relerr_vs_fastdiag=diff)
        del K, B, fd, X0

        parallel_sliced(torch, ft, fmod, mesh, world, refs, calls, call)

        K, M, c, r, want, X0 = refs["unstructured_problem"]
        rmesh = ft.parallel.node_row_mesh(world, 1, device_type="cuda")
        res = call("feast_iterative_rows", lambda: ft.parallel.feast_iterative_rows(
            K, M, X0, mesh=rmesh, c=c, r=r, iters=10, amg_opts={"dtype": torch.float32},
            node_chunk=1, **UNSTRUCTURED_KW))
        calls["feast_iterative_rows"].update(
            check_unstructured("parallel feast_iterative_rows", res, K, M, want,
                               refs["unstructured"]))
        if rank == 0:
            emit({"phase": "parallel", "world": world, "backend": dist.get_backend(),
                  "card": smi, "calls": calls})
    finally:
        fmod.clear_graph_cache()    # the graphs hold the group's all-reduce
        dist.destroy_process_group()


def _bit_equal(a, b):
    import torch

    return (a.n_iter == b.n_iter and a.converged == b.converged
            and all(torch.equal(x, y) for x, y in zip(a[:4], b[:4])))


def parallel_compiled(torch, ft, fmod, mesh, refs, calls, call, reps=3):
    """feast_compiled(mesh=) on the headline: reps calls of its steps run
    eagerly, then its sweeps as graphs with the node all-reduce captured, a
    cold call (capture timed) and reps warm calls (one route after the
    other: the card holds one program), one warm graph call under the
    profiler; bit for bit the eager steps, with their K1 and K2 launches,
    and main's eigenvalues to 1e-12 with main's iterations."""
    A, X0, c, r = bench_problem()
    At, Xt = torch.as_tensor(A, device="cuda"), torch.as_tensor(X0, device="cuda")
    kw = dict(c=c, r=r, nodes=16, iters=20, tol=1e-10, mixed_prec=True, mesh=mesh,
              device="cuda")

    def graph():
        return ft.feast_compiled(At, Xt, **kw)

    def steps():
        return fmod._feast_compiled_steps(At, Xt, **kw)

    walls = {"graph": [], "steps": []}
    launches = {"graph": set(), "steps": set()}

    def timed(route, fn):
        out = call(f"feast_compiled_{route}", fn)
        got = calls.pop(f"feast_compiled_{route}")
        walls[route].append(got["wall_s"])
        launches[route].add((got["k1_launches"], got["k2_launches"]))
        return out

    fmod.clear_graph_cache()
    torch.cuda.empty_cache()
    for _ in range(reps):
        res_s = timed("steps", steps)
    fmod.clear_graph_cache()
    res = call("feast_compiled", graph)
    prog = next(iter(fmod._PROGRAMS.values()))
    require(prog.graphs and prog.replays > 0,
            "parallel: feast_compiled(mesh=) did not replay its graphs")
    info = dict(calls["feast_compiled"], capture_s=prog.capture_s,
                instantiate_s=prog.instantiate_s, replays_cold=prog.replays,
                sweeps=list(prog.sweeps))
    for _ in range(reps):
        res = timed("graph", graph)
    tr = traced(torch, graph, cpu=False)
    held = torch.cuda.memory_allocated()
    fmod.clear_graph_cache()
    del prog
    held = (held - torch.cuda.memory_allocated()) / 1e9
    lam, _ = _inside_sorted(res)
    ref = refs["main"]
    diff = float(np.max(np.abs(lam - ref["lam"]))) if len(lam) == len(ref["lam"]) else np.inf
    require(res.converged and res.n_iter == ref["n_iter"] and diff < 1e-12,
            f"parallel: feast_compiled n_iter {res.n_iter} against {ref['n_iter']}, "
            f"eigenvalues {diff} from main's")
    require(_bit_equal(res, res_s), "parallel: feast_compiled(mesh=) graphs differ from "
            "the eager steps under the same mesh")
    require(len(launches["graph"]) == 1 and launches["graph"] == launches["steps"]
            and (info["k1_launches"], info["k2_launches"]) in launches["graph"],
            f"parallel: feast_compiled(mesh=) K1, K2 launches {launches}, cold "
            f"{info['k1_launches']}, {info['k2_launches']}")
    calls["feast_compiled"] = dict(
        info, iterations=res.n_iter, inside=len(lam), max_diff_vs_main=diff,
        bit_equal_steps=True, graph_walls_s=walls["graph"], steps_walls_s=walls["steps"],
        graph_best_s=min(walls["graph"]), steps_best_s=min(walls["steps"]),
        graph_launch_calls=tr["launch_calls"], graph_launches=tr["graph_launches"],
        graph_device_idle_share=tr["device_idle_share"], graph_profiled_wall_s=tr["wall_s"],
        cache_allocated_gb=held)
    del At, Xt


def check_sliced(label, out, H, want, tol):
    """Exactly eigvalsh's eigenvalues, each with its host residual below
    1e-10; a slice that stops at its cap with a spurious value inside (the
    uniform m0's tie, slicing.py) contributes its converged pairs."""
    order = np.argsort(out.lam.real)
    lam, X = out.lam[order], out.X[:, order]
    rr = np.linalg.norm(H @ X - X * lam[None, :], axis=0)
    err = float(np.max(np.abs(lam - want))) if len(lam) == len(want) else np.inf
    require(err < 1e-10 and rr.max() < 1e-10,
            f"parallel: {label} {len(lam)} eigenvalues, eigvalsh {len(want)}; "
            f"{err} from eigvalsh, host residuals up to {rr.max()}")
    spurious = [[float(x) for x in np.sort(s.filtered()[2]) if x >= tol]
                for s in out.per_slice]
    return dict(found=len(lam), max_err_vs_eigvalsh=err, max_residual_host_f64=float(rr.max()),
                m0=out.per_slice[0].X.shape[1], iterations=[x.n_iter for x in out.per_slice],
                converged=[x.converged for x in out.per_slice], dropped_residuals=spurious)


def parallel_sliced(torch, ft, fmod, mesh, world, refs, calls, call, reps=3):
    """feast_sliced (node mesh), then feast_sliced_parallel (slice mesh) on
    dense_variants' Hermitian matrix over (0.5, 100.5) in 4 slices: the
    program's graphs (mixed_prec) cold, then 3 warm calls, then its steps
    run eagerly (`_feast_sliced_parallel_steps`) once, and the
    full-precision call on the graphs.  Each call split into the
    stochastic count, the factor and the loop; the graphs' capture,
    sweeps, fallbacks, status-read cost, launch calls (two sweeps of
    replays under the profiler), peak memory against the factor store and
    the bytes the cached program holds.  Per slice the graphs and the
    eager steps give the same bits; the graphs launch K2 once a batched
    sweep."""
    from torch.distributed.device_mesh import init_device_mesh

    sl = importlib.import_module("feast_tpu_torch.parallel.slicing")
    H = hermitian_problem()
    lo, hi = 0.5, 100.5
    want = refs["eigvalsh"][(refs["eigvalsh"] > lo) & (refs["eigvalsh"] < hi)]
    smesh = init_device_mesh("cuda", (world,), mesh_dim_names=("slice",))
    skw = dict(nodes=16, iters=30, tol=1e-10)
    out = call("feast_sliced", lambda: ft.parallel.feast_sliced(
        H, (lo, hi), 4, mesh=mesh, mixed_prec=True, **skw))
    calls["feast_sliced"].update(check_sliced("feast_sliced", out, H, want, skw["tol"]))

    Ht = torch.as_tensor(H, device="cuda")
    split = Split(torch, sl)

    def run(label, fn, k1=True):
        split.s = {}
        with split:
            res = call(label, fn, k1=k1)
        info = calls[label]
        info["split_s"] = dict(split.s, loop=info["wall_s"] - sum(split.s.values()))
        info["peak_factor_loop_gb"] = (torch.cuda.max_memory_allocated() - split.base) / 1e9
        info.update(check_sliced(label, res, H, want, skw["tol"]))
        return res

    def graph(mixed=True):
        return lambda: ft.parallel.feast_sliced_parallel(
            Ht, (lo, hi), 4, mesh=smesh, mixed_prec=mixed, **skw)

    fmod.clear_graph_cache()
    torch.cuda.empty_cache()
    res_g = run("feast_sliced_parallel", graph())
    prog = next(iter(fmod._PROGRAMS.values()))
    cold = calls["feast_sliced_parallel"]
    store_gb = prog.buf["store"].numel() * prog.buf["store"].element_size() / 1e9
    cold.update(capture_s=prog.capture_s, instantiate_s=prog.instantiate_s,
                sweeps=prog.sweeps, fallbacks=prog.fallbacks, replays=prog.replays,
                store_gb=store_gb)
    walls, warm = [], None
    for i in range(reps):
        before = prog.replays
        res_w = run("feast_sliced_parallel_warm", graph())
        walls.append(calls["feast_sliced_parallel_warm"]["wall_s"])
        if warm is None or walls[-1] <= min(walls):
            warm = dict(calls["feast_sliced_parallel_warm"], replays=prog.replays - before)
    calls.pop("feast_sliced_parallel_warm")
    read_ms = sliced_read_cost_ms(torch, prog, min(prog.sweeps, 8))

    def two_sweeps():
        for _ in range(2):
            prog._read(prog._step("rr")["status"])
            prog._step("update")

    # the loop's own launches: two sweeps of replays (a whole call under the
    # profiler holds the stochastic count's 1.3e6 kernels, a minute to read)
    tr = traced(torch, two_sweeps, cpu=False)
    held = torch.cuda.memory_allocated()
    fmod.clear_graph_cache()
    del prog
    held = (held - torch.cuda.memory_allocated()) / 1e9
    # the same steps run eagerly: per slice the graphs' sweeps and bits
    res_s = run("feast_sliced_parallel_steps", lambda: sl._feast_sliced_parallel_steps(
        Ht, (lo, hi), 4, mesh=smesh, mixed_prec=True, **skw))
    fmod.clear_graph_cache()
    steps = calls["feast_sliced_parallel_steps"]
    require(all(_bit_equal(a, b) for a, b in zip(res_g.per_slice, res_s.per_slice)),
            "parallel: the sliced graphs differ from their steps run eagerly")
    require(all(_bit_equal(a, b) for a, b in zip(res_g.per_slice, res_w.per_slice)),
            "parallel: a warm sliced graph call differs from the cold one")
    rank, count = torch.distributed.get_rank(), 4 // world     # this rank's slices
    require(cold["k2_launches"] == warm["k2_launches"] == cold["sweeps"]
            == max(r.n_iter for r in res_g.per_slice[rank * count:(rank + 1) * count]),
            f"parallel: sliced graphs K2 {cold['k2_launches']}, {warm['k2_launches']} in "
            f"{cold['sweeps']} sweeps")
    require(cold["k1_launches"] == warm["k1_launches"] == steps["k1_launches"],
            f"parallel: sliced K1 {cold['k1_launches']}, {warm['k1_launches']}, eager "
            f"steps {steps['k1_launches']}")
    # no second copy of the store: above it only the factor's temporaries
    # (chunks of at most 4 GiB, ops/lu.py::batch_chunks) and small buffers
    require(cold["peak_factor_loop_gb"] < store_gb + 4.3 + 1.5,
            f"parallel: sliced graphs' factor and loop peak {cold['peak_factor_loop_gb']} "
            f"GB over a {store_gb} GB store")
    cold.update(warm=warm, warm_walls_s=walls, warm_best_s=min(walls),
                status_read_ms_per_sweep=read_ms,
                two_sweeps_launch_calls=tr["launch_calls"],
                two_sweeps_graph_launches=tr["graph_launches"],
                two_sweeps_kernel_count=tr["kernel_count"],
                two_sweeps_device_idle_share=tr["device_idle_share"],
                two_sweeps_profiled_wall_s=tr["wall_s"], cache_allocated_gb=held)
    # the JAX package's precision: complex128 factors (no panel kernel) on
    # the graphs
    fmod.clear_graph_cache()
    run("feast_sliced_parallel_full_prec", graph(mixed=False), k1=False)
    prog = next(iter(fmod._PROGRAMS.values()))
    calls["feast_sliced_parallel_full_prec"].update(
        capture_s=prog.capture_s, instantiate_s=prog.instantiate_s, sweeps=prog.sweeps,
        fallbacks=prog.fallbacks,
        store_gb=prog.buf["store"].numel() * prog.buf["store"].element_size() / 1e9)
    fmod.clear_graph_cache()
    del prog, Ht


def phase_parallel(torch, ft, dev, refs, smi):
    """The parallel layer on NCCL, one rank per visible card: world size 1
    in this process on one card, spawned ranks on more.  feast_compiled
    (mesh=node_mesh()) on the headline against `main`; feast_iterative
    (mesh=) on the 1M pencil with fastdiag against `fastdiag`; feast_sliced
    (node mesh) and feast_sliced_parallel (slice mesh; mixed_prec, then full
    precision) on dense_variants' Hermitian matrix over (0.5, 100.5) in 4
    slices against eigvalsh; feast_iterative_rows (node_chunk 1) on the
    unstructured pencil with the row-sharded AMG against `unstructured`.
    Missing references are computed first."""
    import os
    import shutil
    import tempfile

    if "main" not in refs:
        phase_main(torch, ft, dev, refs)
    if "fastdiag" not in refs:
        phase_fastdiag(torch, ft, dev, refs)
    if "unstructured" not in refs:
        phase_unstructured(torch, ft, dev, refs)
    if "eigvalsh" not in refs:
        refs["eigvalsh"] = np.linalg.eigvalsh(hermitian_problem())
    world = torch.cuda.device_count()
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="feast_parallel_")
    try:
        store = os.path.join(tmp, "store")
        if world == 1:
            parallel_rank(0, 1, store, refs, smi)
        else:
            torch.multiprocessing.spawn(parallel_rank, args=(world, store, refs, smi),
                                        nprocs=world)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def diag_inv_ops(blocks, block):
    """fp32 operations that the inverses of `blocks` diagonal blocks need,
    both triangles: (the tile kernel's, the doubling's).  A 64-tile is
    64^3 / 6 complex multiply-adds; a level of width s is block / (2 s)
    pairs of two s x s x s products of a triangle by a full block, half a
    full product each.  Together 2 * 4/3 block^3 a block, xTRTRI's count;
    the doubling's dense products do twice their share."""
    tiles = blocks * (block // 64) * 2 * 8 * 64 ** 3 / 6
    products, s = 0, 64
    while s < block:
        products += blocks * 2 * (block // (2 * s)) * 2 * 8 * s ** 3 / 2
        s *= 2
    return tiles, products


def phase_diag_inv(torch, dev, shapes=((16, 10240), (4, 9956), (4, 20480)), block=512):
    """The diagonal-block inverses at the cells' shapes (see the docstring
    at the top): timings, launch calls, temporaries and errors."""
    from feast_tpu_torch.ops import diag_inv
    from feast_tpu_torch.ops import lu as lumod

    def rel(got, want):
        scale = want.abs().amax(dim=(-2, -1), keepdim=True)
        return float(((got.to(want.dtype) - want).abs() / scale).max())

    row = None
    for B, n in shapes:
        gen = torch.Generator(device=dev).manual_seed(B * n)
        buf = lumod.factor_buffer((B,), n, torch.complex64, dev)
        for i in range(B):
            buf[i, :n, :n] = torch.randn((n, n), dtype=torch.complex64, device=dev,
                                         generator=gen)
        LU, _ = lumod.lu_factor_inplace(buf, n)
        torch.cuda.synchronize()
        blocks = B * -(-n // block)
        out = {"phase": "diag_inv", "batch": B, "n": n, "block": block, "blocks": blocks}
        base = torch.cuda.memory_allocated(dev)
        for name, fn, reps in (("kernel", lambda: diag_inv.tiles(LU, block), 5),
                               ("route", lambda: lumod.lu_diag_inv(LU, block), 5),
                               ("plain", lambda: lumod.lu_diag_inv_plain(LU, block), 2)):
            fn()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out[f"{name}_wall_ms"] = (time.perf_counter() - t0) * 1e3
            out[f"{name}_temp_gb"] = (torch.cuda.max_memory_allocated(dev) - base) / 1e9
            out[f"{name}_ms"] = cuda_ms(fn, reps)
            tr = traced(torch, fn, cpu=False)
            out[f"{name}_launch_calls"] = tr["launch_calls"]
            if name == "route":
                out["route_kernels"] = top_kernels(tr, 8)
        # the kernel's tiles against the plain tile step on the same factor:
        # the copied tiles entry for entry, the inverted ones to rounding
        got, want = diag_inv.tiles(LU[:2], block), diag_inv.tiles_plain(LU[:2], block)
        diag = torch.zeros(block, block, dtype=torch.bool, device=dev)
        for i in range(0, block, diag_inv.TILE):
            diag[i:i + diag_inv.TILE, i:i + diag_inv.TILE] = True
        out["tiles_copied_equal"] = all(bool(torch.equal(g[..., ~diag], w[..., ~diag]))
                                        for g, w in zip(got, want))
        out["tiles_err"] = [rel(torch.where(diag, g, 0), torch.where(diag, w, 0))
                            for g, w in zip(got, want)]
        out["tiles_abs_err"] = max(float((torch.where(diag, g - w, 0)).abs().max())
                                   for g, w in zip(got, want))
        require(out["tiles_copied_equal"] and max(out["tiles_err"]) < 1e-5,
                f"diag_inv {B} x {n}: tiles against tiles_plain {out['tiles_err']}, "
                f"copied equal {out['tiles_copied_equal']}")
        got = lumod.lu_diag_inv(LU[:2], block)
        p64 = lumod.lu_diag_inv_plain(LU[:2], block)
        want = lumod.lu_diag_inv_plain(LU[:2].to(torch.complex128), block)
        out["route_err"] = [rel(g, w) for g, w in zip(got, want)]
        out["plain64_err"] = [rel(p, w) for p, w in zip(p64, want)]
        require(max(out["route_err"]) < 1e-4, f"diag_inv {B} x {n}: route error {out['route_err']}")
        del got, p64, want
        tile_ops, product_ops = diag_inv_ops(blocks, block)
        nbytes = blocks * block * block * 8 * 3     # the triangles read, two outputs written
        out["kernel_bound_ms"], out["kernel_bound_by"] = bound_ms(nbytes, tile_ops)
        out["route_bound_ms"], out["route_bound_by"] = bound_ms(nbytes, tile_ops + product_ops)
        emit(out)
        if row is None:         # the dense cell's shape; launches from the main phase
            row = {"name": "diag_inv", "route": "cuda",
                   "source": "feast_tpu_torch/csrc/diag_inv.cu",
                   "replaces": "feast_tpu/ops/lu.py:197", "max_abs_err": out["tiles_abs_err"],
                   "ms": out["kernel_ms"], "plain_ms": out["plain_ms"],
                   "bound_ms": out["kernel_bound_ms"], "bound_by": out["kernel_bound_by"],
                   "library_ms": None}
        del LU, buf
        torch.cuda.empty_cache()
    return row


def load_baseline(root):
    """The K2 and K4 wrappers (ops.schur_kernel, ops.dia_kernel) of the
    feast_tpu_torch package of another checkout, imported under another
    name; its kernels build into that checkout's own _build directory."""
    import importlib.util
    import os

    name = "baseline_feast_tpu_torch"
    pkg = os.path.join(os.path.abspath(root), "feast_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return (importlib.import_module(name + ".ops.schur_kernel"),
            importlib.import_module(name + ".ops.dia_kernel"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma list; the kernels and ok lines need all of them")
    ap.add_argument("--baseline", metavar="DIR",
                    help="a checkout of an earlier commit: k2 and k4 time its "
                         "kernels beside these, in turns")
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
    torch.empty(1, device=dev)    # the context, before the first memory-stats call
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    built = _build.build()
    emit({"phase": "build", "wall_s": time.perf_counter() - t0, "per_source_s": built,
          "ptxas": {name: ptxas_summary(_build, name) for name in _build.SOURCE_FLAGS},
          "torch": torch.__version__, "cuda": torch.version.cuda})

    base_schur = base_dia = None
    if args.baseline:
        base_schur, base_dia = load_baseline(args.baseline)
    walls = {}

    def run(name, fn, *a):
        if name not in phases:
            return None
        t1 = time.perf_counter()
        out = fn(*a)
        gc.collect()          # a phase's tensors held in reference cycles go too
        torch.cuda.empty_cache()
        walls[name] = time.perf_counter() - t1
        return out

    rows = [row for out in (run("k1", phase_k1, torch, panel_lu, dev),
                            run("k2", phase_k2, torch, schur_kernel, dev, base_schur),
                            run("k3", phase_k3, torch, ft, dev),
                            run("k4", phase_k4, torch, dev, base_dia),
                            run("diag_inv", phase_diag_inv, torch, dev)) if out is not None
            for row in (out if isinstance(out, list) else [out])]
    run("small", phase_small, torch, ft, dev)
    launches, inside_main, refs = {}, None, {}
    if "main" in phases:
        torch.cuda.reset_peak_memory_stats(dev)
        launches, inside_main = run("main", phase_main, torch, ft, dev, refs)
    run("profile", phase_profile, torch, ft, dev, refs)
    run("compiled_graph", phase_compiled_graph, torch, ft, dev, smi, refs)
    run("dense_variants", phase_dense_variants, torch, ft, dev, refs)
    run("panel_backend", phase_panel_backend, torch, ft, dev, refs, smi)
    problem = None
    if "sparse" in phases:
        launches["dia_spmm"], problem = run("sparse", phase_sparse, torch, ft, dev)
    if "sparse_profile" in phases:
        if problem is None:
            ap.error("sparse_profile reuses the hierarchy of the sparse phase")
        run("sparse_profile", phase_sparse_profile, torch, ft, dev, problem)
    del problem
    run("fastdiag", phase_fastdiag, torch, ft, dev, refs)
    run("unstructured", phase_unstructured, torch, ft, dev, refs)
    run("orchestrate", phase_orchestrate, torch, ft, dev, refs, smi)
    run("parallel", phase_parallel, torch, ft, dev, refs, smi)
    run("nonlinear", phase_nonlinear, torch, ft, dev)
    run("nonlinear_small", phase_nonlinear_small, torch, ft, dev, inside_main)
    emit({"phase_walls_s": walls, "script_s": time.perf_counter() - t0})
    if phases != set(PHASES):
        return 0
    for row in rows:  # cmatmul carries its count from the k3 phase's dense solve
        row.setdefault("launches", launches.get(row["name"]))
        require(row["launches"] > 0, f"{row['name']}: not launched on its path")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: row[k] for k in keys} for row in rows]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
