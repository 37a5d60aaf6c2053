"""Nothing the harness loads is JAX or the JAX package, compared by whole
top-level names (`feast_tpu_torch` starts with `feast_tpu`), and the plain
references load nothing of the port.  Each check runs in a fresh process."""

import json
import os
import subprocess
import sys

from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "feast_tpu"}


def _loaded(code: str) -> set:
    script = (f"import sys, json\nsys.path.insert(0, {harness.ROOT!r})\n{code}\n"
              "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         check=True, cwd=harness.ROOT, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _files(kind):
    return sorted(f[:-3] for f in os.listdir(os.path.join(harness.HERE, kind))
                  if f.endswith(".py"))


def test_harness_and_everything_it_finds_load_no_jax():
    loads = "\n".join(f"harness.load({kind!r}, {name!r})"
                      for kind in ("problems", "entries", "reference", "metrics", "roofline")
                      for name in _files(kind))
    top = _loaded("import feast_tpu_torch\nfrom portbench import harness, devtrace, spans, "
                  "control\nimport portbench.run\n" + loads)
    assert "feast_tpu_torch" in top and "portbench" in top
    assert not top & FORBIDDEN, top & FORBIDDEN


def test_references_load_nothing_of_the_port():
    for name in _files("reference"):
        top = _loaded("import importlib.util\n"
                      f"p = {os.path.join(harness.HERE, 'reference', name + '.py')!r}\n"
                      "s = importlib.util.spec_from_file_location('ref', p)\n"
                      "m = importlib.util.module_from_spec(s); s.loader.exec_module(m)")
        assert not top & (FORBIDDEN | {"feast_tpu_torch", "portbench"}), (name, top)


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "feast_tpu_torch_fake", object())
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.delitem(sys.modules, "feast_tpu", raising=False)
    assert "feast_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in harness.forbidden_modules()
