#!/usr/bin/env python3
"""Time the JAX package's native MatrixMarket reader against scipy's.

    python3 tools/mmio_timing.py [--points 100000] [--reps 3]

Writes the stiffness matrix K of the unstructured FEM pencil
(`feast_tpu_torch.problems.fem2d_unstructured(points, seed=1)`, the
`unstructured` configuration of chip_smoke.py: n = 99,975 at 100,000
points) as a real symmetric coordinate .mtx into a temporary directory,
compiles `feast_tpu/native/mmio.cpp` with g++ into that directory (the
JAX package itself is not imported: it needs JAX), and reads the file in
turns with
  * the native parse plus the COO -> CSR assembly of
    `feast_tpu/io.py::read_matrix_market` (its fast path, copied here), and
  * `scipy.io.mmread` plus CSR, as `feast_tpu_torch/io.py` reads it.
Both results are held equal.  Prints one JSON line with every wall, the
host's CPU count, and the file's size and entries.  Host work only: no
card is used.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import sysconfig
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_native(tmp):
    """Compile mmio.cpp as the JAX package does (g++ -O3) into tmp."""
    src = os.path.join(ROOT, "feast_tpu", "native", "mmio.cpp")
    so = os.path.join(tmp, "feast_tpu_mmio" + sysconfig.get_config_var("EXT_SUFFIX"))
    cmd = ["g++", "-O3", "-shared", "-fPIC",
           f"-I{sysconfig.get_paths()['include']}", src, "-o", so]
    t0 = time.perf_counter()
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    build_s = time.perf_counter() - t0
    spec = importlib.util.spec_from_file_location("feast_tpu_mmio", so)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module, build_s


def read_native(native, path):
    """feast_tpu/io.py's fast path: the native parse, the symmetric
    expansion and the COO -> CSR assembly; returns (CSR, parse seconds)."""
    import scipy.sparse as sp

    t0 = time.perf_counter()
    (nrows, ncols, _, field, symmetry, _,
     rows_b, cols_b, re_b, im_b) = native.read(path)
    parse_s = time.perf_counter() - t0
    rows = np.frombuffer(rows_b, dtype=np.int64)
    cols = np.frombuffer(cols_b, dtype=np.int64)
    re = np.frombuffer(re_b, dtype=np.float64)
    im = (np.frombuffer(im_b, dtype=np.float64) if field == "complex"
          else np.zeros_like(re))
    if symmetry != "general":
        if symmetry != "symmetric":
            raise ValueError(f"this timing writes symmetric files, got {symmetry}")
        off = rows != cols
        rows, cols = np.concatenate([rows, cols[off]]), np.concatenate([cols, rows[off]])
        re, im = np.concatenate([re, re[off]]), np.concatenate([im, im[off]])
    A = sp.coo_matrix((re + 1j * im, (rows, cols)), shape=(nrows, ncols)).tocsr()
    return A, parse_s


def read_scipy(path):
    import scipy.io
    import scipy.sparse as sp

    return sp.csr_matrix(scipy.io.mmread(path)).astype(np.complex128)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--points", type=int, default=100_000)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)

    import scipy.io

    sys.path.insert(0, ROOT)
    from feast_tpu_torch import problems

    K, _, _ = problems.fem2d_unstructured(args.points, seed=1)
    tmp = tempfile.mkdtemp(prefix="mmio_timing_")
    try:
        path = os.path.join(tmp, "K.mtx")
        scipy.io.mmwrite(path, K.real.tocoo(), symmetry="symmetric")
        native, build_s = build_native(tmp)
        walls = {"native_s": [], "native_parse_s": [], "scipy_s": []}
        for _ in range(args.reps):                     # in turns
            t0 = time.perf_counter()
            An, parse_s = read_native(native, path)
            walls["native_s"].append(time.perf_counter() - t0)
            walls["native_parse_s"].append(parse_s)
            t0 = time.perf_counter()
            As = read_scipy(path)
            walls["scipy_s"].append(time.perf_counter() - t0)
            if (An != As).nnz or An.shape != As.shape:
                raise AssertionError("the two readers disagree")
        out = {"n": K.shape[0], "file_mb": os.path.getsize(path) / 1e6,
               "entries_expanded": int(As.nnz), "g++_build_s": build_s,
               "cpus": os.cpu_count(), "scipy": scipy.__version__, **walls}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
