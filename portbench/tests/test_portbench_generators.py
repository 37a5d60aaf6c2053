"""The frozen generators: the same seed gives the same inputs, and they are
the constructions they were copied from."""

import numpy as np
import torch

from portbench.harness import load
from portbench import mix as mixmod
from portbench.mix import random_start
from portbench.tests import tiny


def test_dense_same_seed_same_inputs():
    gen = load("problems", "dense_planted")
    cfg = tiny.dense(32)
    for seed in (0, 2**31 + 12345, -7):
        a, b = gen.make(cfg, seed, 2, 0.01, "cpu"), gen.make(cfg, seed, 2, 0.01, "cpu")
        for x, y in zip(a["instances"], b["instances"]):
            assert torch.equal(x["A"], y["A"])
    a, b = gen.make(cfg, 1, 1, 0.0, "cpu"), gen.make(cfg, 2, 1, 0.0, "cpu")
    assert not torch.equal(a["instances"][0]["A"], b["instances"][0]["A"])


def test_dense_plants_its_spectrum_under_a_nonnormal_similarity():
    """ZLATME's A = X D X^-1: eigenvalues j / n, eigenvector matrix of
    condition conds, A far from normal."""
    n = 64
    cfg = tiny.dense(n)
    inst = load("problems", "dense_planted").make(cfg, 3, 1, 0.0, "cpu")["instances"][0]
    A = inst["A"].numpy()
    w, X = np.linalg.eig(A)
    assert np.abs(np.sort_complex(w) - np.arange(1, n + 1) / n).max() < 1e-12
    assert np.array_equal(inst["lam"], np.arange(1, n + 1) / n)
    assert 0.5 * cfg["conds"] < np.linalg.cond(X) < 2 * cfg["conds"]
    assert np.abs(A @ A.conj().T - A.conj().T @ A).max() > 1e-2


def test_dense_restart_variant_turns_the_vectors_and_keeps_the_spectrum():
    n, delta = 64, 0.01
    cfg = tiny.dense(n)
    a, b = load("problems", "dense_planted").make(cfg, 3, 2, delta, "cpu")["instances"]
    w = np.linalg.eigvals(b["A"].numpy())
    assert np.abs(np.sort_complex(w) - np.arange(1, n + 1) / n).max() < 1e-12
    step = np.linalg.norm((b["A"] - a["A"]).numpy(), 2) / np.linalg.norm(a["A"].numpy(), 2)
    assert delta / 10 < step < 10 * delta * cfg["conds"]


def test_gun_same_seed_same_inputs_and_is_gun_like():
    """The frozen copy builds the port's gun_like matrices bit for bit."""
    import feast_tpu_torch as ft

    gen = load("problems", "gun_planted")
    cfg = tiny.gun(256)
    a, b = gen.make(cfg, 5, 1, 0.0), gen.make(cfg, 5, 1, 0.0)
    for k in ("d", "vs"):
        assert np.array_equal(a["instances"][0][k], b["instances"][0][k])
    assert np.array_equal(a["first_start"], b["first_start"])
    K, W1, W2 = gen.matrices(a["instances"][0], "cpu")
    T = ft.problems.gun_like(256, seed=5, planted=6, device="cpu")
    assert torch.equal(K.to(torch.complex128), T.mats[0])
    assert torch.equal(W1.to(torch.complex128), T.mats[2])
    assert torch.equal(W2.to(torch.complex128), T.mats[3])


def test_sequence_goes_through_the_variants_and_starts():
    cfg = tiny.dense(32)
    inputs = mixmod.make(load("problems", "dense_planted"), cfg, tiny.RESTART, 11, "cpu")
    assert len(inputs["instances"]) == 2
    assert np.array_equal(inputs["first_start"], random_start(11, 0, 32, cfg["m0"]))

    class Entry:
        def solve(self, config, op, X0, device):
            return op, X0

        def outcome(self, config, res):
            return {"op": res[0], "X0": res[1]}, res[1] + 1

    seq = mixmod.Sequence(Entry(), cfg, tiny.RESTART, inputs, ["a", "b"], 11, "cpu",
                          lambda: None)
    outs = [seq.step() for _ in range(4)]
    assert [o["op"] for o in outs] == ["a", "b", "a", "b"]
    assert [o["instance"] for o in outs] == [0, 1, 0, 1]
    assert np.allclose(outs[2]["X0"], inputs["first_start"] + 2)
    seq = mixmod.Sequence(Entry(), cfg, tiny.COLD, inputs, ["a"], 11, "cpu", lambda: None)
    outs = [seq.step() for _ in range(3)]
    assert np.array_equal(outs[2]["X0"], random_start(11, 2, 32, cfg["m0"]))


def test_random_starts_follow_seed_and_index():
    a = random_start(2**31 + 99, 3, 8, 2)
    assert np.array_equal(a, random_start(2**31 + 99, 3, 8, 2))
    assert not np.array_equal(a, random_start(2**31 + 99, 4, 8, 2))


def test_traced_window_is_whole_cycles():
    assert mixmod.trace_solves(tiny.COLD, 3) == 3
    assert mixmod.trace_solves(tiny.RESTART, 3) == 4
    assert mixmod.trace_solves(tiny.RESTART, 4) == 4
