"""The control of `correct`: the plain reference one precision down (the
complex64 eig of A; the gun's Schur-complement reference in complex64), put
in the program's place, comes out as not correct, here at a size a test
run holds.  `portbench/control.py` runs it at the cells' own sizes on the
card.  The tests marked `cuda` run a sound cell and the control on the
card at a small size, through the port's CUDA-graph path."""

import time

import pytest

from portbench import harness, judge
from portbench.control import control_checks
from portbench.tests import tiny


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the port's kernels and graphs)")
    return "cuda"


@pytest.mark.parametrize("cfg,mix", [(tiny.dense, tiny.COLD), (tiny.dense, tiny.RESTART),
                                     (tiny.gun, tiny.COLD)],
                         ids=["dense_cold", "dense_restart", "gun_cold"])
def test_control_is_not_correct(cfg, mix):
    checks = control_checks(cfg(), mix, 7, "cpu")
    assert not judge.passed(checks), checks


@pytest.mark.cuda
@pytest.mark.parametrize("mix", [tiny.COLD, tiny.RESTART], ids=["cold", "restart"])
def test_sound_dense_run_on_the_card(card, mix):
    result, _ = harness.run_cell({"name": "card"}, tiny.dense(512), mix, 11, 2.0, True,
                                 card, time.perf_counter(),
                                 [{"name": "k1_roofline_pct", "unit": "%"},
                                  {"name": "sweeps", "unit": "sweeps/solve"}])
    assert result["correct"], result["checks"]
    assert 0 < result["metrics"]["k1_roofline_pct"]["value"] <= 100


@pytest.mark.cuda
def test_control_on_the_card(card):
    checks = control_checks(tiny.dense(512), tiny.COLD, 7, card)
    assert not judge.passed(checks), checks
