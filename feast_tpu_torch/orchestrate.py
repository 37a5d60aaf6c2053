"""Crash-resilient checkpointed FEAST driving.

Counterpart of `feast_tpu/orchestrate.py`.  `feast_iterative_checkpointed`
runs `feast_iterative` one refinement sweep at a time in worker
SUBPROCESSES (the `keep_q` / `nit0` exact-stepping contract), checkpoints
the moment subspace Q after every sweep (atomic tmp + rename), and restarts
a crashed or hung worker from the last checkpoint.  A dead CUDA context
poisons every later call in the same process, so recovery needs process
isolation.

Layout of `checkpoint_dir` (the JAX package's, key for key):
  problem.npz    A, B (scipy CSR blobs or dense), X0  [unless `builder`]
  config.json    solver kwargs + sweep bookkeeping
  state.npz      latest checkpoint: Q, X, lam, res, inside, converged,
                 sweeps, sweep_s [, warm (complex64)]
  partial.npz    the current sweep's sub-sweep checkpoint (node_chunk runs)
  log.jsonl      one line per sweep / restart event
  worker.log     the last worker's output

A worker is `python -m feast_tpu_torch.orchestrate <checkpoint_dir>`.

Differences from the JAX package, on purpose:
  * config.json carries `device` ("cuda" by default, "cpu" for the tests)
    in place of `platform`; a worker reading a JAX-written config (it has
    `platform` and no `device`) runs on the CPU for platform "cpu" and on
    the card otherwise, so a checkpoint directory written by the JAX
    package resumes here;
  * `amg_f32` maps to amg_opts={"dtype": torch.float32};
  * the JAX compilation-cache settings and the PYTHONPATH stripping (both
    remote-TPU workarounds) are left out; the worker's import path still
    rides in its `python -c` preamble;
  * the transient failure signatures are the card's (`TRANSIENT`); a
    kernel fault ("illegal memory access", "unspecified launch failure") is
    deterministic and aborts after two identical failures.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import zipfile
from typing import Optional

import numpy as np

_PROBLEM = "problem.npz"
_CONFIG = "config.json"
_STATE = "state.npz"
_PARTIAL = "partial.npz"
_LOG = "log.jsonl"

# feast_iterative kwargs a checkpointed run may carry (everything must be
# JSON- or npz-serializable; meshes, callables and Contour objects are not)
_ALLOWED = {"r", "nodes", "tol", "tol_mode", "solver", "solve_tol",
            "solve_iters", "precondition", "spurious", "ortho",
            "node_chunk", "rr", "reorder", "debug"}

# the card's failures that a fresh process can outlive; matched against the
# last line of the worker's output, as the JAX package matches its own
TRANSIENT = ("CUDA-capable device(s) is/are busy or unavailable",
             "uncorrectable ECC error encountered")

# what np.load raises on a missing key or a damaged file
_UNREADABLE = (OSError, KeyError, ValueError, EOFError, zipfile.BadZipFile)


def _log(cdir, rec):
    rec = dict(rec, t=round(time.time(), 1))
    with open(os.path.join(cdir, _LOG), "a") as f:
        f.write(json.dumps(rec) + "\n")


def _save_problem(cdir, A, B, X0):
    import scipy.sparse as sp

    payload = {}

    def pack(tag, M):
        if M is None:
            payload[f"{tag}_kind"] = "none"
        elif sp.issparse(M):
            M = sp.csr_matrix(M)
            payload[f"{tag}_kind"] = "csr"
            payload[f"{tag}_data"] = M.data
            payload[f"{tag}_indices"] = M.indices
            payload[f"{tag}_indptr"] = M.indptr
            payload[f"{tag}_shape"] = np.asarray(M.shape)
        else:
            payload[f"{tag}_kind"] = "dense"
            payload[f"{tag}_data"] = np.asarray(M)

    pack("A", A)
    pack("B", B)
    payload["X0"] = np.asarray(X0)
    np.savez(os.path.join(cdir, _PROBLEM), **payload)


def _load_problem(cdir):
    import scipy.sparse as sp

    with np.load(os.path.join(cdir, _PROBLEM), allow_pickle=False) as f:
        def unpack(tag):
            kind = str(f[f"{tag}_kind"])
            if kind == "none":
                return None
            if kind == "csr":
                return sp.csr_matrix(
                    (f[f"{tag}_data"], f[f"{tag}_indices"], f[f"{tag}_indptr"]),
                    shape=tuple(f[f"{tag}_shape"]))
            return f[f"{tag}_data"]

        return unpack("A"), unpack("B"), f["X0"]


def _atomic_savez(path, **payload):
    tmp = path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, path)


def _pull_warm_f32(warm):
    """The per-node Krylov warm blocks as complex64 host arrays, pulled one
    node at a time (each pull 8 n m0 bytes).  Warm blocks are only Krylov
    initial guesses: complex64 halves the checkpoint and costs at most an
    outer iteration."""
    import torch

    out = np.empty(tuple(warm.shape), dtype=np.complex64)
    for i in range(warm.shape[0]):
        out[i] = warm[i].to(torch.complex64).cpu().numpy()
    return out


def _host(x):
    import torch

    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def feast_iterative_checkpointed(
        A=None, B=None, X0=None, *,
        checkpoint_dir: str,
        c: complex = 0.0 + 0.0j,
        max_sweeps: int = 20,
        max_restarts: int = 10,
        worker_timeout: float = 3600.0,
        resume: bool = True,
        builder: Optional[str] = None,
        builder_kwargs: Optional[dict] = None,
        amg_f32: bool = False,
        amg_damp: float = 0.0,
        sweeps_per_worker: int = 1,
        warm_starts: bool = True,
        chunk_checkpoints: bool = True,
        platform: Optional[str] = None,
        device: str = "cuda",
        worker_env: Optional[dict] = None,
        verbose: bool = True,
        **feast_kwargs):
    """Run feast_iterative to convergence, one refinement sweep at a time in
    worker SUBPROCESSES, restarting crashed or hung workers from the last
    checkpoint.

    Problem delivery: pass (A, B, X0), serialized once into
    `checkpoint_dir/problem.npz` (scipy CSR or dense), or
    `builder="pkg.module:function"` (+ builder_kwargs), which every worker
    calls to rebuild (A, B) or (A, B, X0) in its own process.

    amg_f32: amg_opts={"dtype": torch.float32}.  amg_damp: amg_opts
    "damp".  device: the workers' device ("cuda", or "cpu" for the plain
    path).  platform: the JAX spelling; when given it sets the device by
    the rule a worker applies to a JAX-written config ("cpu" the CPU, any
    other the card).  Other kwargs go to feast_iterative verbatim (the JSON-
    serializable `_ALLOWED` subset).

    sweeps_per_worker: sweeps one worker runs before it exits, each still
    checkpointed on its own; subspace and warm blocks carry over in
    process between them.

    warm_starts: checkpoint the per-node Krylov solutions (complex64) beside
    Q, so a fresh worker reseeds its node solves from the previous sweep.

    chunk_checkpoints (effective with node_chunk): after every node chunk
    the worker persists the partial moment sum and that chunk's warm block
    to partial.npz, and a restarted worker resumes the sweep at the next
    chunk instead of at its start.

    max_restarts: failed workers (no new checkpoint) tolerated; the same
    failure twice in a row aborts at once unless its last output line
    carries a `TRANSIENT` signature.  worker_timeout: seconds before a
    worker counts as hung.

    Returns a FeastResult with host (CPU) tensors, n_iter = n_sweeps = the
    node sweeps run.  The run is resumable: calling again with resume=True
    (the default) continues from `checkpoint_dir/state.npz`."""
    if platform is not None:
        device = _worker_device({"platform": platform})
    bad = set(feast_kwargs) - _ALLOWED
    if bad:
        raise ValueError(
            f"feast_iterative_checkpointed cannot serialize kwargs {bad}; "
            f"allowed: {sorted(_ALLOWED)}")
    os.makedirs(checkpoint_dir, exist_ok=True)
    state_path = os.path.join(checkpoint_dir, _STATE)
    if not resume and os.path.exists(state_path):
        os.remove(state_path)

    if builder is None:
        if A is None or X0 is None:
            raise ValueError("pass (A, B, X0) or builder=")
        _save_problem(checkpoint_dir, A, B, X0)
    elif X0 is not None:
        np.savez(os.path.join(checkpoint_dir, "x0.npz"), X0=np.asarray(X0))

    config = {"c": [complex(c).real, complex(c).imag],
              "builder": builder, "builder_kwargs": builder_kwargs or {},
              "amg_f32": bool(amg_f32), "amg_damp": float(amg_damp),
              "sweeps_per_worker": int(sweeps_per_worker),
              "warm_starts": bool(warm_starts),
              "chunk_checkpoints": bool(chunk_checkpoints),
              "device": str(device),
              "kwargs": feast_kwargs}
    with open(os.path.join(checkpoint_dir, _CONFIG), "w") as f:
        json.dump(config, f, indent=1)

    # workers import this package from where the parent did
    pkg_parent = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    if worker_env:
        env.update({k: str(v) for k, v in worker_env.items()})
    preamble = (f"import sys; sys.path.insert(0, {pkg_parent!r}); "
                "from feast_tpu_torch.orchestrate import _worker; "
                f"sys.exit(_worker({os.path.abspath(checkpoint_dir)!r}))")
    worker_log = os.path.join(checkpoint_dir, "worker.log")

    t0 = time.perf_counter()
    _log(checkpoint_dir, {"event": "run_start"})
    restarts = 0
    last_failure = None  # (rc, last line) of the previous failure without progress
    sweeps = _read_sweeps(state_path)
    converged = sweeps_converged(state_path)
    while not converged and sweeps < max_sweeps:
        # output always lands in worker.log (overwritten per attempt), so a
        # crash leaves its stderr on disk
        try:
            with open(worker_log, "w") as lf:
                p = subprocess.run([sys.executable, "-c", preamble], env=env,
                                   timeout=worker_timeout, stdout=lf,
                                   stderr=subprocess.STDOUT)
            rc = p.returncode
        except subprocess.TimeoutExpired:
            rc = "timeout"
        new_sweeps = _read_sweeps(state_path)
        if rc != 0 and new_sweeps == sweeps:
            restarts += 1
            tail = _tail_lines(worker_log, 20)
            _log(checkpoint_dir, {"event": "worker_restart", "rc": str(rc),
                                  "restarts": restarts, "stderr_tail": tail})
            if verbose:
                print(f"[orchestrate] worker died (rc={rc}); restart "
                      f"{restarts}/{max_restarts} from sweep {sweeps}\n"
                      + "\n".join("  | " + t for t in tail[-5:]), flush=True)
            # the same rc and last error line twice in a row without progress
            # is a repeating failure (import error, bad config, kernel
            # fault): retrying cannot help.  The card's transient failures
            # retry up to max_restarts.
            sig = (str(rc), tail[-1] if tail else "")
            transient = any(t in sig[1] for t in TRANSIENT)
            if last_failure == sig and not transient:
                raise RuntimeError(
                    f"worker failed twice identically without progress "
                    f"(rc={rc}, last line: {sig[1]!r}); aborting early - "
                    f"see {worker_log}")
            last_failure = sig
            if transient:
                time.sleep(min(10.0 * restarts, 60.0))  # let the card recover
            if restarts > max_restarts:
                raise RuntimeError(
                    f"worker failed {restarts} times without progress "
                    f"(last rc={rc}); see {checkpoint_dir}/{_LOG}")
            continue
        if rc == 0 and new_sweeps == sweeps and not sweeps_converged(state_path):
            # a non-converged call always runs >= 1 sweep: this would loop
            raise RuntimeError(
                "worker exited cleanly with neither progress nor "
                f"convergence at sweep {sweeps}; see {worker_log}")
        last_failure = None
        sweeps = new_sweeps
        converged = sweeps_converged(state_path)
        if verbose:
            print(f"[orchestrate] sweep {sweeps} checkpointed, "
                  f"converged={converged}", flush=True)

    if not os.path.exists(state_path):
        raise RuntimeError("no checkpoint was ever written")
    import torch

    from .solvers.feast import FeastResult

    with np.load(state_path, allow_pickle=False) as st:
        lam, X, Q = (torch.as_tensor(st[k]) for k in ("lam", "X", "Q"))
        res = torch.as_tensor(st["res"])
        inside = torch.as_tensor(st["inside"].astype(bool))
        conv = bool(st["converged"])
        n_sweeps = int(st["sweeps"])
    _log(checkpoint_dir, {"event": "done", "converged": conv,
                          "sweeps": n_sweeps, "restarts": restarts,
                          "wall_s": round(time.perf_counter() - t0, 2)})
    return FeastResult(lam, X, res, inside, n_sweeps, conv, Q, n_sweeps)


def _tail_lines(path, k=20):
    """Last k non-empty lines of a worker log."""
    try:
        with open(path, "r", errors="replace") as f:
            lines = [ln.rstrip() for ln in f.readlines() if ln.strip()]
        return lines[-k:]
    except OSError:
        return []


def read_restarts(checkpoint_dir) -> int:
    """worker_restart events since the most recent run_start log event."""
    n = 0
    try:
        with open(os.path.join(checkpoint_dir, _LOG)) as f:
            for ln in f:
                try:
                    ev = json.loads(ln).get("event")
                except json.JSONDecodeError:
                    continue
                if ev == "run_start":
                    n = 0
                elif ev == "worker_restart":
                    n += 1
    except OSError:
        pass
    return n


def _read_state(state_path, key, cast, default):
    if not os.path.exists(state_path):
        return default
    try:
        with np.load(state_path, allow_pickle=False) as st:
            return cast(st[key])
    except _UNREADABLE:   # as if absent
        return default


def _read_sweeps(state_path) -> int:
    return _read_state(state_path, "sweeps", int, 0)


def sweeps_converged(state_path) -> bool:
    return _read_state(state_path, "converged", bool, False)


def _worker_device(config) -> str:
    """config["device"]; a JAX-written config has "platform" instead."""
    if config.get("device"):
        return config["device"]
    return "cpu" if config.get("platform") == "cpu" else "cuda"


def _load_resume(partial_path, sweep):
    """resume_chunk for `sweep` from partial.npz, or None (absent, stale or
    unreadable: the sweep restarts from its top)."""
    if not os.path.exists(partial_path):
        return None
    try:
        with np.load(partial_path, allow_pickle=False) as pt:
            if int(pt["for_sweep"]) != sweep:
                return None
            ci_done = int(pt["ci_done"])
            resume = {"ci0": ci_done + 1}
            if ci_done >= 0:
                resume["Qn"] = pt["Qn"]
                resume["warm_new"] = [pt[f"warm_new_{i}"] for i in range(ci_done + 1)]
            if "rr_X" in pt.files:
                resume["rr"] = tuple(pt[k] for k in ("rr_X", "rr_lam", "rr_R",
                                                     "rr_res", "rr_inside"))
            return resume
    except _UNREADABLE:
        return None


def _crash_after_chunk(ci):
    """Test hook: with FEAST_ORCH_CRASH_AFTER_CHUNK="marker_path:idx", die
    right after chunk idx's partial is persisted, once (the marker file)."""
    spec = os.environ.get("FEAST_ORCH_CRASH_AFTER_CHUNK")
    if spec:
        marker, idx = spec.rsplit(":", 1)
        if ci == int(idx) and not os.path.exists(marker):
            with open(marker, "w") as f:
                f.write("crashed\n")
            os._exit(17)


def _crash_once():
    """Test hook: with FEAST_ORCH_CRASH_ONCE=marker_path, die after a
    sweep's compute and before its checkpoint, once (the marker file)."""
    marker = os.environ.get("FEAST_ORCH_CRASH_ONCE")
    if marker and not os.path.exists(marker):
        with open(marker, "w") as f:
            f.write("crashed\n")
        os._exit(17)


def _worker(cdir: str) -> int:
    """Refinement sweeps of one worker: load config, problem and the latest
    checkpoint, run feast_iterative(iters=0, keep_q=True, nit0=<sweeps so
    far>) sweeps_per_worker times, checkpointing each sweep atomically."""
    with open(os.path.join(cdir, _CONFIG)) as f:
        config = json.load(f)

    import torch

    from .solvers.ifeast import feast_iterative

    if config["builder"]:
        import importlib

        mod_name, fn_name = config["builder"].split(":")
        built = getattr(importlib.import_module(mod_name), fn_name)(
            **config["builder_kwargs"])
        A, B, X0 = built if len(built) == 3 else (*built, None)
        if X0 is None:
            x0p = os.path.join(cdir, "x0.npz")
            if not os.path.exists(x0p):
                raise ValueError("builder returned no X0 and no x0.npz")
            X0 = np.load(x0p)["X0"]
    else:
        A, B, X0 = _load_problem(cdir)

    state_path = os.path.join(cdir, _STATE)
    sweeps = _read_sweeps(state_path)
    warm0 = None
    use_warm = bool(config.get("warm_starts", True))
    if sweeps:
        with np.load(state_path, allow_pickle=False) as st:
            X0 = st["Q"]
            if use_warm and "warm" in st.files:
                warm0 = st["warm"]   # complex64; feast_iterative casts on entry

    kwargs = dict(config["kwargs"])
    spw = max(int(config.get("sweeps_per_worker", 1)), 1)
    amg_opts = {"dtype": torch.float32} if config["amg_f32"] else {}
    if config.get("amg_damp"):
        amg_opts["damp"] = float(config["amg_damp"])
    cc = complex(config["c"][0], config["c"][1])
    device = _worker_device(config)

    partial_path = os.path.join(cdir, _PARTIAL)
    use_chunk_ckpt = bool(config.get("chunk_checkpoints", True)) and kwargs.get("node_chunk")
    resume_chunk = _load_resume(partial_path, sweeps + 1) if use_chunk_ckpt else None

    # the payload of this sweep's partial.npz (the RR prelude's blobs must
    # survive into every later per-chunk save)
    partial = {}
    if resume_chunk is not None:
        partial["for_sweep"] = np.asarray(sweeps + 1)
        partial["ci_done"] = np.asarray(resume_chunk["ci0"] - 1)
        if "rr" in resume_chunk:
            partial.update(zip(("rr_X", "rr_lam", "rr_R", "rr_res", "rr_inside"),
                               resume_chunk["rr"]))
        for i, w in enumerate(resume_chunk.get("warm_new", [])):
            partial[f"warm_new_{i}"] = np.asarray(w, dtype=np.complex64)
        if "Qn" in resume_chunk:
            partial["Qn"] = resume_chunk["Qn"]

    def chunk_ckpt(info):
        if info["ci"] == -1:        # RR prelude: a fresh sweep
            partial.clear()
            partial.update(for_sweep=np.asarray(sweeps + 1), ci_done=np.asarray(-1),
                           **dict(zip(("rr_X", "rr_lam", "rr_R", "rr_res", "rr_inside"),
                                      map(_host, info["rr"]))))
        else:
            partial["ci_done"] = np.asarray(info["ci"])
            partial["Qn"] = _host(info["Qn"])
            partial[f"warm_new_{info['ci']}"] = _pull_warm_f32(info["warm_chunk"])
        _atomic_savez(partial_path, **partial)
        _crash_after_chunk(info["ci"])

    for _ in range(spw):
        t0 = time.perf_counter()
        resumed_ci = None if resume_chunk is None else resume_chunk["ci0"]
        out = feast_iterative(A, B, X0, c=cc, iters=0, keep_q=True, nit0=sweeps,
                              amg_opts=amg_opts or None, warm0=warm0,
                              keep_warm=use_warm,
                              chunk_ckpt=chunk_ckpt if use_chunk_ckpt else None,
                              resume_chunk=resume_chunk, device=device, **kwargs)
        resume_chunk = None  # applies to the first sweep only
        partial.clear()
        sweep_s = time.perf_counter() - t0
        done_in_call = int(out.n_sweeps)   # node sweeps this call ran
        _crash_once()

        # Q continues the refinement exactly either way: a converged call
        # returns its input Q unchanged
        extra = {}
        if use_warm:
            if out.warm is not None and done_in_call > 0:
                extra["warm"] = _pull_warm_f32(out.warm)
            elif warm0 is not None:
                # a converged-at-entry call re-saves the previous sweep's
                # warm blocks (the state file is replaced whole)
                extra["warm"] = np.asarray(_host(warm0), dtype=np.complex64)
        sweeps += done_in_call
        inside = out.inside.cpu().numpy()
        res = out.res.cpu().numpy()
        _atomic_savez(state_path, Q=_host(out.Q), X=_host(out.X), lam=_host(out.lam),
                      res=res, inside=inside, converged=np.asarray(bool(out.converged)),
                      sweeps=np.asarray(sweeps), sweep_s=sweep_s, **extra)
        ev = {"event": "sweep", "sweep": sweeps, "converged": bool(out.converged),
              "max_res_inside": float(res[inside].max()) if inside.any() else None,
              "sweep_s": round(sweep_s, 2)}
        if resumed_ci is not None:
            ev["resumed_from_chunk"] = int(resumed_ci)
        _log(cdir, ev)
        print(json.dumps({"sweep": sweeps, "converged": bool(out.converged),
                          "sweep_s": round(sweep_s, 2)}), flush=True)
        if use_chunk_ckpt and os.path.exists(partial_path):
            os.remove(partial_path)  # superseded by the sweep checkpoint
        if out.converged or done_in_call == 0:
            break
        # the next sweep of this worker: subspace and warm blocks carry over
        X0 = out.Q
        warm0 = out.warm if use_warm else None
    return 0


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1]))
