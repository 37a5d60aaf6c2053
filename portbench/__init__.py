"""portbench: the benchmark of the PyTorch / CUDA port (`feast_tpu_torch`).

One command runs one cell of `BENCHMARK.json` once and prints one JSON
line:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The harness is driven by data.  A cell names a configuration
(`configs/<config>.json`: sizes, tolerance, limits, and the names of its
problem generator, port entry and plain reference) and a traffic mix
(`traffic/<mix>.json`: how solve follows solve).  Each metric is a reader
of its own (`metrics/<metric>.py`), each kernel's operations and bytes a
file of its own (`roofline/<kernel>.py`).  The harness finds all of them
by the names in `BENCHMARK.json`, so a later change adds a configuration,
a mix or a metric by adding files.  A metric `<base>.<cells>` with no file
of its own is read by `metrics/<base>.py`: one quantity split by the
end-to-end metric its cells move.

What lives here is the yardstick: the generators (the gun's a frozen
numpy copy, the dense one LAPACK's planted-spectrum construction),
the plain references (`reference/`, numpy and torch only, nothing of the
port), the comparison that decides `correct` (`judge.py`), the reduction
of the profiler's events to metrics (`devtrace.py`) and the table of
peaks.  From the port the harness takes only its public entry points, the
spans it wraps around three of its private functions (`spans.py`), and
the build of its kernels (`kernels/_build.build`), timed apart as
`build_s`.
Nothing here imports `jax` or the JAX package `feast_tpu`.
"""
