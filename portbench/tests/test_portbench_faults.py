"""`correct` comes out false when the timed path is broken underneath.

Each test drives a whole run (`harness.run_cell`) on the CPU at a small
size, past the harness's look for a card, with the port's entry point
replaced by one that breaks its answer in one way:

  unchanged  the solve hands back its start subspace as its vectors
  half       half of the pairs found inside the contour left out
  altered    one eigenvalue altered where it is produced

The cells run on one card, so no exchange between cards can be left out.
A sound run of the same size comes out correct.
"""

import time

import numpy as np
import pytest
import torch

import feast_tpu_torch as ft
from portbench import harness
from portbench.tests import tiny


def unchanged(res, X0):
    X = torch.as_tensor(np.asarray(X0), dtype=res.X.dtype)
    return res._replace(X=X / torch.linalg.vector_norm(X, dim=0))


def half(res, X0):
    inside = res.inside.clone()
    idx = torch.nonzero(inside).flatten()
    inside[idx[::2]] = False
    return res._replace(inside=inside)


def altered(res, X0):
    lam = res.lam.clone()
    k = int(torch.nonzero(res.inside).flatten()[0])
    lam[k] = lam[k] * (1 + 1e-4)
    return res._replace(lam=lam)


def broken(real, fault):
    def solve(*args, **kw):
        return fault(real(*args, **kw), args[1])
    return solve


CELLS = {"dense": ("feast_compiled", tiny.dense, tiny.COLD),
         "dense_restart": ("feast_compiled", tiny.dense, tiny.RESTART),
         "gun": ("nlfeast", tiny.gun, tiny.COLD)}


def run(cell):
    _, cfg, mix = CELLS[cell]
    result, _ = harness.run_cell({"name": cell}, cfg(), mix, 20261018, 0.0, False, "cpu",
                                 time.perf_counter())
    return result


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(cell):
    result = run(cell)
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("fault", [unchanged, half, altered], ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_fault_is_not_correct(cell, fault, monkeypatch):
    entry = CELLS[cell][0]
    monkeypatch.setattr(ft, entry, broken(getattr(ft, entry), fault))
    result = run(cell)
    assert not result["correct"], (fault.__name__, result["checks"])
