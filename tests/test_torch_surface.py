"""The port's public surface against the JAX package's, read from source.

For every module of `feast_tpu` (the Pallas kernels' modules aside, whose
counterparts are the port's hand-written kernels), every public function
and class, and every public method of such a class, has a counterpart at
the same module path in `feast_tpu_torch` that takes every JAX argument
name.  Both packages are parsed with `ast`, nothing imported, so a JAX
name added without a counterpart fails here.  The only exceptions are
`KEPT`, each with its reason and the ROADMAP.md "Kept on purpose" line it
rests on.  Then the spellings kept on purpose at run time: `cx.cmatmul`'s
`precision=` and the orchestrator's `platform=`."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from feast_tpu_torch import cx as tcx

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = ROOT / "feast_tpu", ROOT / "feast_tpu_torch"

_CX_PAIR = ("the port computes on native complex dtypes, so the real-pair "
            "type and its helpers have no counterpart (ROADMAP.md North star: "
            "'the port may use native torch complex dtypes'; feast_tpu_torch/cx.py)")
_PYTREE = ("JAX pytree registration; torch has no pytree to register a class "
           "with, and the port's classes cross no jit boundary")
_HLO = ("HLO inspection of the XLA program; the port has no HLO, and records "
        "each all-gather's size instead (ROADMAP.md Kept on purpose: "
        "'No HLO tooling')")

# (JAX module, name or Class.member or function:argument) -> reason.
KEPT = {
    **{("cx.py", name): _CX_PAIR for name in (
        "CX", "as_cx", "concatenate", "expi", "eye", "from_numpy", "full_like",
        "hdot", "stack", "take_cols", "to_numpy", "where", "zeros")},
    **{(mod, f"{cls}.{m}"): _PYTREE
       for mod, cls in (("contour.py", "Contour"), ("nep.py", "SPMF"),
                        ("ops/sparse.py", "CSR"), ("ops/sparse.py", "DIA"),
                        ("ops/sparse.py", "BELL"), ("ops/sparse.py", "STRETCH"),
                        ("ops/sparse.py", "STRETCHT"))
       for m in ("tree_flatten", "tree_unflatten")},
    ("parallel/slicing.py", "feast_sliced_parallel:hlo_sink"): _HLO,
    ("parallel/rowsharded.py", "feast_iterative_rows:hlo_sink"): _HLO,
    ("parallel/rowsharded.py", "largest_allgather_elems"): _HLO,
    ("parallel/rowsharded.py", "assert_no_large_allgather"): _HLO,
}
# whole modules: the Pallas TPU kernels, ported as hand-written CUDA kernels
# (ops/panel_lu.py, ops/schur_kernel.py, ops/cmatmul_kernel.py,
# ops/dia_kernel.py; ROADMAP.md section 2)
KEPT_MODULES = ("ops/pallas_",)


def _args(fn: ast.FunctionDef):
    a = fn.args
    return {x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
            + [v for v in (a.vararg, a.kwarg) if v is not None]}


def surface(path: pathlib.Path):
    """{name: argument names} of a module's public functions and classes,
    and of each public class's public methods (plus __init__ and
    __call__) as "Class.method"."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if getattr(node, "name", "_").startswith("_"):
            continue
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = _args(node)
        elif isinstance(node, ast.ClassDef):
            out[node.name] = set()
            for sub in node.body:
                if (isinstance(sub, ast.FunctionDef)
                        and (not sub.name.startswith("_")
                             or sub.name in ("__init__", "__call__"))):
                    out[f"{node.name}.{sub.name}"] = _args(sub)
    return out


def _jax_modules():
    return sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


def differences(rel: str):
    """The JAX names and arguments of module `rel` with no counterpart in
    the port, exemptions aside."""
    port = PORT_PKG / rel
    if not port.exists():
        return [f"module {rel}"]
    jax_side, port_side = surface(JAX_PKG / rel), surface(port)
    missing = []
    for name, args in sorted(jax_side.items()):
        owner = name.split(".")[0]
        if (rel, name) in KEPT or (rel, owner) in KEPT:
            continue
        if name not in port_side:
            missing.append(name)
            continue
        missing += [f"{name}:{a}" for a in sorted(args - port_side[name])
                    if (rel, f"{name}:{a}") not in KEPT]
    return missing


@pytest.mark.parametrize("rel", [m for m in _jax_modules()
                                 if not m.startswith(KEPT_MODULES)])
def test_every_jax_name_has_a_counterpart(rel):
    assert differences(rel) == []


def test_every_exemption_is_still_needed():
    """An entry of KEPT names a JAX name or argument that exists and that
    the port lacks: a stale entry would hide a later gap."""
    for (rel, key), _ in KEPT.items():
        name, _, arg = key.partition(":")
        jax_side, port_side = surface(JAX_PKG / rel), surface(PORT_PKG / rel)
        assert name in jax_side, (rel, key)
        if arg:
            assert arg in jax_side[name] and arg not in port_side.get(name, ()), (rel, key)
        else:
            assert name not in port_side, (rel, key)
    assert any(m.startswith(KEPT_MODULES) for m in _jax_modules())


def test_ops_binds_the_jax_submodules_and_no_jax():
    """`import feast_tpu_torch.ops` binds the submodules the JAX package's
    ops binds, in a fresh interpreter that never loads jax or feast_tpu."""
    code = ("import sys, feast_tpu_torch, feast_tpu_torch.ops as o\n"
            "names = 'amg eig eigh krylov lu qr qz sparse svd'.split()\n"
            "assert all(getattr(o, n).__name__ == 'feast_tpu_torch.ops.' + n "
            "for n in names)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'feast_tpu')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, check=True,
                   timeout=120)


@pytest.mark.parametrize("precision", [None, "highest", "high", "default", "HIGH",
                                       "jax_highest", "jax_high", "jax_default"])
@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64])
def test_cmatmul_precision_is_accepted_and_computed_at_highest(precision, dtype):
    """Every JAX precision gives the bits of the plain call (the port always
    computes at full accuracy, JAX's default HIGHEST)."""
    import jax

    if precision is not None and precision.startswith("jax_"):
        precision = getattr(jax.lax.Precision, precision[4:].upper())
    rng = np.random.default_rng(0)
    a, b = (torch.as_tensor(rng.standard_normal((2, 9, 7)) + 1j * rng.standard_normal(
        (2, 9, 7))).to(dtype) for _ in range(2))
    b = b.mT
    assert torch.equal(tcx.cmatmul(a, b, precision), tcx.cmatmul(a, b))
    assert torch.equal(tcx.cmatmul(a, b, precision=precision), a @ b)


@pytest.mark.parametrize("precision", ["fastest", 3, ("highest", "highest")])
def test_cmatmul_precision_unknown_raises(precision):
    a = torch.eye(3, dtype=torch.complex128)
    with pytest.raises(ValueError, match="unknown precision"):
        tcx.cmatmul(a, a, precision)


@pytest.mark.parametrize("platform,device", [("cpu", "cpu"), ("gpu", "cuda"),
                                             (None, "cpu")])
def test_checkpointed_platform_sets_the_device(tmp_path, platform, device):
    """platform=, the JAX spelling, sets the workers' device by the rule a
    worker applies to a JAX-written config; None keeps device=.  With
    max_sweeps=0 no worker starts, and the config is read back."""
    import json

    from feast_tpu_torch import orchestrate

    with pytest.raises(RuntimeError, match="no checkpoint"):
        orchestrate.feast_iterative_checkpointed(
            np.diag(np.arange(1.0, 9.0)), None, np.ones((8, 2)),
            checkpoint_dir=str(tmp_path), max_sweeps=0, platform=platform,
            device="cpu", verbose=False)
    with open(tmp_path / "config.json") as f:
        assert json.load(f)["device"] == device
