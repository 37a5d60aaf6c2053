"""Builder functions for the orchestrator's tests (a worker `builder=`
target must be an importable module:function)."""

from . import problems


def build_slice_problem(n: int = 400):
    """(A, B) for the 1-D Laplacian slice of tests/test_torch_orchestrate."""
    return problems.laplacian_1d(n, sparse=True), None


def build_broken(n: int = 400):
    """A builder that fails the same way in every worker: its stderr tail
    must land in log.jsonl and the orchestrator must abort after 2
    identical failures, not max_restarts."""
    raise RuntimeError("injected deterministic builder failure")


def build_transient_crash(n: int = 400):
    """A builder that dies with the card's first transient signature
    (`orchestrate.TRANSIENT`): the orchestrator must keep retrying up to
    max_restarts instead of aborting on two identical failures."""
    raise RuntimeError("CUDA error: CUDA-capable device(s) is/are busy or unavailable")
