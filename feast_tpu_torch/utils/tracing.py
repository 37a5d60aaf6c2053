"""Profiler integration: a torch.profiler trace around solver phases.

Counterpart of `feast_tpu/utils/tracing.py` (jax.profiler).  `trace`
records the host and, on a CUDA machine, the device timeline of a block
and writes it to `logdir`/trace.json as a Chrome trace (loadable in
Perfetto or chrome://tracing); `annotate` names a region inside it.
"""

from __future__ import annotations

import contextlib
import os
import tempfile


@contextlib.contextmanager
def trace(logdir: str = None, create_perfetto: bool = False):
    """Capture a torch.profiler trace around a block:

        with tracing.trace("tr"):
            ft.feast(A, X0, ...)

    Yields `logdir` (default: a directory under the system temporary
    directory).  `create_perfetto` is accepted for the JAX package's API;
    the Chrome trace torch writes loads in Perfetto as it is."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or os.path.join(tempfile.gettempdir(), "feast_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named region inside a trace (host and device timeline)."""
    import torch

    return torch.profiler.record_function(name)
