"""The node sum of `feast_compiled(mesh=)` as a step and a span of its own.

On 4 gloo ranks (`_torch_ranks.Ranks`) the sweep program run eagerly
records one `feast.node_sum` span after each `feast.update`, with the
tier, the payload's bytes and the ranks, gives the same bits on every
rank, and matches the JAX package's `feast_compiled` on a 4-device node
mesh.  Without a mesh there is no such span.  The card's graphs of the
split are held to the eager steps in `test_torch_cuda.py`.
"""

import importlib

import numpy as np
import pytest

import feast_tpu as jt
import feast_tpu_torch as ft
from _torch_ranks import Ranks
from feast_tpu.parallel import node_mesh as jax_node_mesh
from feast_tpu_torch.utils import tracing

fmod = importlib.import_module("feast_tpu_torch.solvers.feast")

N, M0, NODES = 40, 8, 16
KW = dict(c=5.5 + 0j, r=3.2, nodes=NODES, iters=20, tol=1e-10)
KEYS = ("lam", "X", "res", "inside", "n_iter", "converged")


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    r = Ranks(4, str(tmp_path_factory.mktemp("ranks4")))
    yield r
    r.close()


@pytest.fixture(scope="module")
def problem():
    """diag(1..40) turned by a well-conditioned similarity: 3..8 inside."""
    rng = np.random.default_rng(16)
    S = np.eye(N) + 0.05 * (rng.standard_normal((N, N)) + 1j * rng.standard_normal((N, N)))
    A = S @ np.diag(np.arange(1.0, N + 1)) @ np.linalg.inv(S)
    X0 = rng.standard_normal((N, M0)) + 1j * rng.standard_normal((N, M0))
    return A, X0


def check_spans(spans, dtype_bytes, ranks):
    """One node sum after each update, of the update's tier; each carries
    the (n, m0) payload's bytes and the ranks."""
    seq = [(name, a.get("tier")) for name, a in spans if name != "feast.factor"]
    updates = [t for name, t in seq if name == "feast.update"]
    assert updates and seq == [x for t in updates
                               for x in (("feast.update", t), ("feast.node_sum", t))]
    for name, a in spans:
        if name == "feast.node_sum":
            assert a["ranks"] == ranks
            assert a["bytes"] == N * M0 * dtype_bytes[a["tier"]]
    assert [a["nodes"] for name, a in spans if name == "feast.factor"] == [NODES // ranks]


@pytest.mark.parametrize("mixed", [True, False], ids=["mixed", "full"])
def test_node_sum_spans_and_results_on_four_ranks(ranks4, problem, mixed):
    A, X0 = problem
    outs = ranks4.run("node_sum_spans", A=A, X0=X0, mixed_prec=mixed, **KW)
    sizes = {"c64": 8, "c128": 16}
    for o in outs:
        check_spans(o["steps"]["spans"], sizes, 4)
        assert o["steps"]["spans"] == outs[0]["steps"]["spans"]
        for k in KEYS:
            np.testing.assert_array_equal(o["steps"][k], outs[0]["steps"][k])
    got = outs[0]["steps"]
    assert got["converged"]
    lam = np.sort(got["lam"][got["inside"]].real)
    np.testing.assert_allclose(lam, np.arange(3.0, 9.0), atol=1e-9)
    # the JAX package on the same inputs over a 4-device node mesh
    ref = jt.feast_compiled(A, X0, mesh=jax_node_mesh(4), mixed_prec=mixed, **KW)
    assert got["n_iter"] == int(ref.n_iter) and got["converged"] == bool(ref.converged)
    lam_j, _, res_j = ref.filtered()
    order = np.argsort(got["lam"][got["inside"]].real)
    np.testing.assert_allclose(got["lam"][got["inside"]][order],
                               lam_j[np.argsort(lam_j.real)], rtol=0, atol=1e-10)
    np.testing.assert_allclose(got["res"][got["inside"]][order],
                               res_j[np.argsort(lam_j.real)], rtol=0, atol=1e-10)
    # the complex64 tier runs only with mixed precision
    tiers = {a["tier"] for name, a in got["spans"] if name == "feast.node_sum"}
    assert tiers == ({"c64", "c128"} if mixed else {"c128"})


@pytest.mark.parametrize("mixed", [True, False], ids=["mixed", "full"])
def test_no_node_sum_without_a_mesh(problem, mixed):
    A, X0 = problem
    with tracing.recording():
        res = ft.feast_compiled(A, X0, mixed_prec=mixed, device="cpu", **KW)
    recs = tracing.spans()
    fmod.clear_graph_cache()
    assert res.converged
    names = [r["name"] for r in recs]
    assert "feast.update" in names and "feast.node_sum" not in names
    assert [r["attrs"]["nodes"] for r in recs if r["name"] == "feast.factor"] == [NODES]
    tiers = {r["attrs"]["tier"] for r in recs if r["name"] == "feast.update"}
    assert tiers == ({"c64", "c128"} if mixed else {"c128"})


def test_in_place_node_sum(ranks4):
    """`node_sum_` leaves the sum over the ranks in the tensor each passed."""
    x = np.arange(6.0) + 1j
    for s, kept in ranks4.run("in_place"):
        assert kept
        np.testing.assert_array_equal(s, x * (1 + 2 + 3 + 4))
