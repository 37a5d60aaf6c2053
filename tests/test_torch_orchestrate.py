"""The port's checkpointing orchestrator (feast_tpu_torch.orchestrate) and
`feast_iterative`'s chunk_ckpt / resume_chunk, on the CPU: worker
subprocesses with device="cpu", against the port's and the JAX package's
in-process runs; a killed worker, a deterministic failure, the card's
transient signature, a sub-sweep crash that resumes at the next chunk
(bit for bit), warm blocks, resume and builder, and a checkpoint directory
written in the JAX package's layout resumed by the port.  The retry
back-off (`time.sleep`) is patched out in the parent."""

import importlib
import json
import os

import numpy as np
import pytest
import torch

import feast_tpu as jt
import feast_tpu_torch as ft
from feast_tpu_torch import orchestrate as orch

tif = importlib.import_module("feast_tpu_torch.solvers.ifeast")

torch.set_num_threads(2)
ENV = {"OMP_NUM_THREADS": "2"}      # workers run beside other test files


@pytest.fixture(autouse=True)
def no_backoff(monkeypatch):
    monkeypatch.setattr(orch.time, "sleep", lambda s: None)


def slice_problem(n=400):
    A = ft.problems.laplacian_1d(n, sparse=True)
    exact = 2 - 2 * np.cos(np.arange(1, 8) * np.pi / (n + 1))
    c = (exact[0] + exact[4]) / 2
    r = (exact[4] - exact[0]) * 0.75
    rng = np.random.default_rng(3)
    X0 = rng.standard_normal((n, 8)) + 1j * rng.standard_normal((n, 8))
    return A, X0, complex(c), float(r), exact[:5]


AMG = dict(nodes=8, tol=1e-10, precondition="amg", solve_tol=1e-10, solve_iters=200)
# the JAX package compiles its sweep anew in every call: a small Jacobi case
JACOBI = dict(nodes=4, tol=1e-10, precondition="jacobi", solve_tol=1e-10, solve_iters=400)


def run(tmp_path, A, X0, c, r, name="ck", **kw):
    kw.setdefault("worker_env", ENV)
    return orch.feast_iterative_checkpointed(
        A, None, X0, c=c, r=r, checkpoint_dir=str(tmp_path / name), device="cpu",
        verbose=False, **kw)


def events(tmp_path, name="ck"):
    with open(tmp_path / name / "log.jsonl") as f:
        return [json.loads(ln) for ln in f]


def converged_to(out, exact, rtol=1e-8):
    lam, _, res = out.filtered()
    assert out.converged and len(lam) == len(exact)
    np.testing.assert_allclose(np.sort(lam.real), exact, rtol=rtol)
    assert res.max() < 1e-10


def test_checkpointed_matches_inprocess_and_jax(tmp_path):
    A, X0, c, r, exact = slice_problem(100)
    ref = ft.feast_iterative(A, None, X0, c=c, r=r, iters=10, device="cpu", **JACOBI)
    out = run(tmp_path, A, X0, c, r, max_sweeps=10, sweeps_per_worker=10, **JACOBI)
    converged_to(out, exact)
    assert out.n_iter == out.n_sweeps == ref.n_sweeps
    np.testing.assert_allclose(out.lam.numpy(), ref.lam.numpy(), rtol=1e-12)
    lam_j, _, _ = jt.feast_iterative(A, None, X0, c=c, r=r, iters=10, **JACOBI).filtered()
    np.testing.assert_allclose(np.sort(out.filtered()[0].real), np.sort(lam_j.real),
                               rtol=1e-12)
    assert [e["sweep"] for e in events(tmp_path) if e["event"] == "sweep"] == \
        list(range(1, out.n_sweeps + 1)) + [out.n_sweeps]    # the last: converged at entry


def test_checkpointed_survives_killed_worker(tmp_path):
    A, X0, c, r, exact = slice_problem()
    marker = str(tmp_path / "crashed.marker")
    out = run(tmp_path, A, X0, c, r, max_sweeps=10, max_restarts=3, sweeps_per_worker=10,
              worker_env=dict(ENV, FEAST_ORCH_CRASH_ONCE=marker), **AMG)
    assert os.path.exists(marker), "the crash was never injected"
    converged_to(out, exact)
    assert orch.read_restarts(str(tmp_path / "ck")) == 1


def test_deterministic_failure_aborts_early_with_forensics(tmp_path):
    A, X0, c, r, _ = slice_problem(100)
    with pytest.raises(RuntimeError, match="failed twice identically"):
        orch.feast_iterative_checkpointed(
            builder="feast_tpu_torch.orchestrate_testutil:build_broken", X0=X0, c=c,
            checkpoint_dir=str(tmp_path / "ck"), max_sweeps=5, max_restarts=10,
            device="cpu", verbose=False, worker_env=ENV, r=r, nodes=4, tol=1e-8)
    restarts = [e for e in events(tmp_path) if e["event"] == "worker_restart"]
    assert len(restarts) == 2            # the early abort, not max_restarts
    for e in restarts:
        assert "injected deterministic builder failure" in "\n".join(e["stderr_tail"])
    assert orch.read_restarts(str(tmp_path / "ck")) == 2


def test_transient_signature_retries_to_max_restarts(tmp_path):
    A, X0, c, r, _ = slice_problem(100)
    with pytest.raises(RuntimeError, match="failed 3 times"):
        orch.feast_iterative_checkpointed(
            builder="feast_tpu_torch.orchestrate_testutil:build_transient_crash", X0=X0,
            c=c, checkpoint_dir=str(tmp_path / "ck"), max_sweeps=5, max_restarts=2,
            device="cpu", verbose=False, worker_env=ENV, r=r, nodes=4, tol=1e-8)
    restarts = [e for e in events(tmp_path) if e["event"] == "worker_restart"]
    assert len(restarts) == 3            # identical failures, no early abort
    assert orch.TRANSIENT[0] in restarts[-1]["stderr_tail"][-1]


def test_subsweep_crash_resumes_at_next_chunk(tmp_path):
    """A worker killed right after chunk 1 of 4 of the first sweep leaves
    partial.npz; its successor resumes that sweep at chunk 2, and the
    sweep's Q equals the uninterrupted sweep's bit for bit."""
    A, X0, c, r, _ = slice_problem()
    kw = dict(AMG, node_chunk=2, max_sweeps=1)
    marker = str(tmp_path / "chunk.marker")
    crashed = run(tmp_path, A, X0, c, r, name="crashed", max_restarts=3,
                  worker_env=dict(ENV, FEAST_ORCH_CRASH_AFTER_CHUNK=marker + ":1"), **kw)
    whole = run(tmp_path, A, X0, c, r, name="whole", **kw)
    assert os.path.exists(marker), "the chunk crash was never injected"
    assert crashed.n_sweeps == whole.n_sweeps == 1
    assert torch.equal(crashed.Q, whole.Q)
    ev = events(tmp_path, "crashed")
    assert [e["event"] for e in ev].count("worker_restart") == 1
    assert [e.get("resumed_from_chunk") for e in ev if e["event"] == "sweep"] == [2]
    assert not os.path.exists(tmp_path / "crashed" / "partial.npz")


def test_chunk_ckpt_resume_chunk_in_process_bit_for_bit():
    A, X0, c, r, _ = slice_problem()
    kw = dict(AMG, c=c, r=r, iters=0, keep_q=True, keep_warm=True, node_chunk=2,
              device="cpu")
    blobs = []
    whole = tif.feast_iterative(A, None, X0, chunk_ckpt=blobs.append, **kw)
    assert [b["ci"] for b in blobs] == [-1, 0, 1, 2, 3]
    assert all(b["nchunks"] == 4 for b in blobs[1:])
    for k in (0, 2):            # stopped after chunk k, then resumed
        resume = {"ci0": k + 1, "Qn": blobs[k + 1]["Qn"], "rr": blobs[0]["rr"],
                  "warm_new": [b["warm_chunk"] for b in blobs[1:k + 2]]}
        seen = []
        part = tif.feast_iterative(A, None, X0, resume_chunk=resume, chunk_ckpt=seen.append,
                                   **kw)
        assert [b["ci"] for b in seen] == list(range(k + 1, 4))   # no RR prelude
        assert torch.equal(part.Q, whole.Q) and torch.equal(part.warm, whole.warm)
    # without "rr" the resumed sweep recomputes its Rayleigh-Ritz phase
    part = tif.feast_iterative(A, None, X0, resume_chunk={
        "ci0": 2, "Qn": blobs[2]["Qn"], "warm_new": [b["warm_chunk"] for b in blobs[1:3]]},
        **kw)
    assert torch.equal(part.Q, whole.Q)


def test_checkpointed_persists_warm_starts(tmp_path):
    A, X0, c, r, exact = slice_problem()
    out1 = run(tmp_path, A, X0, c, r, max_sweeps=1, **AMG)
    assert not out1.converged
    with np.load(tmp_path / "ck" / "state.npz") as st:
        assert st["warm"].shape == (8, 400, 8) and st["warm"].dtype == np.complex64
        assert np.abs(st["warm"]).max() > 0
    converged_to(run(tmp_path, A, X0, c, r, max_sweeps=10, sweeps_per_worker=10, **AMG),
                 exact)


def test_checkpointed_resume_and_builder(tmp_path):
    A, X0, c, r, exact = slice_problem()
    kw = dict(builder="feast_tpu_torch.orchestrate_testutil:build_slice_problem",
              builder_kwargs={"n": 400}, c=c, r=r, checkpoint_dir=str(tmp_path / "ck"),
              device="cpu", verbose=False, worker_env=ENV, **AMG)
    out1 = orch.feast_iterative_checkpointed(X0=X0, max_sweeps=1, **kw)
    assert not out1.converged and out1.n_iter == 1
    assert not orch.sweeps_converged(str(tmp_path / "ck" / "state.npz"))
    out2 = orch.feast_iterative_checkpointed(max_sweeps=10, sweeps_per_worker=10, **kw)
    assert out2.n_iter > 1
    converged_to(out2, exact)
    assert orch.sweeps_converged(str(tmp_path / "ck" / "state.npz"))


def test_resumes_a_jax_layout_checkpoint(tmp_path):
    """state.npz, problem.npz and config.json as the JAX package writes them
    (config with "platform", no "device"), after one JAX sweep; the port's
    worker (`python -m feast_tpu_torch.orchestrate`) runs it to the JAX
    package's converged eigenvalues."""
    import subprocess
    import sys

    from feast_tpu import orchestrate as jorch

    A, X0, c, r, exact = slice_problem(100)
    one = jt.feast_iterative(A, None, X0, c=c, r=r, iters=0, keep_q=True, keep_warm=True,
                             **JACOBI)
    cdir = tmp_path / "jax"
    cdir.mkdir()
    jorch._save_problem(str(cdir), A, None, X0)
    jorch._atomic_savez(
        str(cdir / "state.npz"), Q=jt.cx.to_numpy(one.Q), X=jt.cx.to_numpy(one.X),
        lam=jt.cx.to_numpy(one.lam), res=np.asarray(one.res), inside=np.asarray(one.inside),
        converged=np.asarray(bool(one.converged)), sweeps=np.asarray(int(one.n_sweeps)),
        sweep_s=0.0, warm=jorch._pull_warm_f32(one.warm))
    kwargs = {k: v for k, v in JACOBI.items()}
    kwargs["r"] = r
    with open(cdir / "config.json", "w") as f:
        json.dump({"c": [c.real, c.imag], "builder": None, "builder_kwargs": {},
                   "amg_f32": False, "amg_damp": 0.0, "sweeps_per_worker": 10,
                   "warm_starts": True, "chunk_checkpoints": True, "platform": "cpu",
                   "kwargs": kwargs}, f)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-m", "feast_tpu_torch.orchestrate", str(cdir)],
                   check=True, cwd=repo, env=dict(os.environ, **ENV), capture_output=True)
    ref = jt.feast_iterative(A, None, X0, c=c, r=r, iters=10, **JACOBI)
    with np.load(cdir / "state.npz") as st:
        assert bool(st["converged"]) and int(st["sweeps"]) == ref.n_iter
        lam = st["lam"][st["inside"]]
    lam_j, _, _ = ref.filtered()
    np.testing.assert_allclose(np.sort(lam.real), np.sort(lam_j.real), rtol=1e-10)
    np.testing.assert_allclose(np.sort(lam.real), exact, rtol=1e-8)


def test_orchestrate_exports_match_jax():
    from feast_tpu import orchestrate as jorch
    from feast_tpu import orchestrate_testutil as jtu
    from feast_tpu_torch import orchestrate_testutil as ttu

    for jmod, tmod in ((jorch, orch), (jtu, ttu)):
        public = {n for n, v in vars(jmod).items() if not n.startswith("_") and callable(v)
                  and getattr(v, "__module__", "") == jmod.__name__}
        assert public <= set(vars(tmod)), sorted(public - set(vars(tmod)))
    with pytest.raises(ValueError, match="serialize"):
        orch.feast_iterative_checkpointed(np.eye(3), None, np.ones((3, 1)),
                                          checkpoint_dir="unused", mesh=object())
