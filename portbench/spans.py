"""Synchronised spans from outside the program, around calls into its layers.

A configuration's `spans` map a span's name to [module, function] of the
port: `{"factor": ["feast_tpu_torch.solvers.feast", "_factor_scan"]}`.
While a `Spans` is entered, each such function is replaced by a wrapper
that synchronises the card before and after the call, adds the seconds to
the span of the solve in progress, and marks the call in the profiler's
trace (`record_function`).  The pattern is `chip_smoke.py`'s
`timed_factor` / `timer` / `Patched` (`phase_main`, `phase_nonlinear`).

The functions wrapped are private names of the port.  A name that is gone
is not wrapped, and the metric that reads its span finds nothing.  Only the
traced run installs spans: the timed window runs the program untouched.
"""

from __future__ import annotations

import importlib
import time


class Spans:
    def __init__(self, spec: dict, sync):
        self.sync = sync
        self.targets = []
        for name, (module, attr) in spec.items():
            try:
                mod = importlib.import_module(module)
            except ImportError:
                continue
            if callable(getattr(mod, attr, None)):
                self.targets.append((name, mod, attr))
        self.current: dict = {}

    def _wrap(self, name, fn):
        from torch.profiler import record_function

        def timed(*a, **k):
            self.sync()
            t0 = time.perf_counter()
            with record_function("span." + name):
                out = fn(*a, **k)
                self.sync()
            self.current[name] = self.current.get(name, 0.0) + time.perf_counter() - t0
            return out
        return timed

    def __enter__(self):
        self.saved = [(mod, attr, getattr(mod, attr)) for _, mod, attr in self.targets]
        for (name, mod, attr), (_, _, fn) in zip(self.targets, self.saved):
            setattr(mod, attr, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)

    def begin(self):
        self.current = {}

    def end(self) -> dict:
        out, self.current = self.current, {}
        return out
