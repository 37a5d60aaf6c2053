"""Build the port's CUDA sources and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and is compiled on first use
with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC [per-source flags] -o _build/lib<name>-<hash>.so

into `feast_tpu_torch/_build/` (git-ignored).  The file name carries a hash
of the source and the flags, so an edited source is rebuilt and a stale
library is never loaded.  Nothing outside the package's own `csrc/` is
compiled; the toolkit is found through `CUDA_HOME` (default
/usr/local/cuda) or `nvcc` on PATH.

`build()` starts one nvcc per missing library, all at once, and waits for
all of them; `function()` returns a ctypes function with its argument
types set.  Every C entry point returns `cudaGetLastError()` (an int) and
`check()` raises when it is not 0.

Each wrapper counts its launches in its module's `launches` through
`count_launch`.  A wrapper called while a CUDA graph is captured launches
nothing: inside `tally_launches` its launch goes into the graph's tally,
and the graph adds the tally to the counters on every replay
(`add_launches`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import contextlib
import subprocess
import sys
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

COMMON_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# panel_lu: no fused multiply-add, so the kernel rounds every product and
# sum as the plain PyTorch version does and the two pick the same pivots.
SOURCE_FLAGS = {"panel_lu": ("--fmad=false",), "schur": (), "cmatmul": (),
                "dia_spmm": (), "row_swap": (), "diag_inv": ()}

_libs: dict[str, ctypes.CDLL] = {}
_funcs: dict[tuple[str, str], ctypes._CFuncPtr] = {}
# launch tallies of the CUDA graphs being captured, innermost last
_tallies: list[dict[str, int]] = []


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path(name: str) -> Path:
    src = SRC_DIR / f"{name}.cu"
    flags = COMMON_FLAGS + SOURCE_FLAGS[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=None) -> dict:
    """Compile every missing library among `names` (default: all sources)
    in parallel.  Returns {name: seconds} for the ones built now."""
    names = list(SOURCE_FLAGS) if names is None else list(names)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *COMMON_FLAGS, *SOURCE_FLAGS[name], "-o", str(tmp),
               str(SRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    seconds, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    """nvcc's output (register and shared-memory use) of the last build."""
    path = BUILD_DIR / f"{name}.log"
    return path.read_text() if path.exists() else ""


def function(name: str, symbol: str, argtypes):
    """ctypes entry point `symbol` of library `name` (built on first use)."""
    key = (name, symbol)
    if key not in _funcs:
        if name not in _libs:
            build([name])
            _libs[name] = ctypes.CDLL(str(library_path(name)))
        fn = getattr(_libs[name], symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _funcs[key] = fn
    return _funcs[key]


def check(err: int, what: str):
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def count_launch(module: str, counter: str = "launches"):
    """One launch of the kernel of wrapper module `module` (its __name__):
    into the tally of the graph being captured, else into the module's
    `counter` (`launches`, or another count the module keeps)."""
    key = module if counter == "launches" else f"{module}:{counter}"
    if _tallies:
        _tallies[-1][key] = _tallies[-1].get(key, 0) + 1
    else:
        _add(key, 1)


def _add(key: str, count: int):
    module, _, counter = key.partition(":")
    mod, counter = sys.modules[module], counter or "launches"
    setattr(mod, counter, getattr(mod, counter) + count)


@contextlib.contextmanager
def tally_launches():
    """Around the capture of a CUDA graph: yields the dict {module: launches}
    of the kernels the graph holds ("module:counter" for a count other than
    a module's `launches`)."""
    tally: dict[str, int] = {}
    _tallies.append(tally)
    try:
        yield tally
    finally:
        _tallies.pop()


def add_launches(tally: dict[str, int]):
    """Count one replay of a graph whose capture gave `tally`."""
    for key, count in tally.items():
        _add(key, count)
