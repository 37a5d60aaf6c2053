"""Profiler integration and the solvers' spans.

Counterpart of `feast_tpu/utils/tracing.py` (jax.profiler).  `trace`
records the host and, on a CUDA machine, the device timeline of a block
and writes it to `logdir`/trace.json as a Chrome trace (loadable in
Perfetto or chrome://tracing); `annotate` names a region inside it.

`span` marks a layer of a solve (the factor, a sweep's Rayleigh-Ritz, the
NEP's extraction, ...).  Spans are off by default, and then cost one flag
check and one call into the profiler's state: no event, no allocation, no
synchronisation.  They are on inside `recording()` and while a torch
profiler records (so inside `trace`).  An active span records its name,
its parent, the root span of the solve it belongs to, its host start and
end on the clock of the profiler's events, and on a CUDA device a pair of
CUDA events on the current stream; it also opens a `record_function`
range "span.<name>", which the profiler's trace shows beside the kernels
the span launched.  `spans()` resolves the events (one synchronisation)
and returns the records; `clear()` drops them.  `spanned` makes a whole
function's calls spans.

The records are those of one session: a stretch in which spans stay on.
`recording()` and `trace()` each start one, and so does a span opened in
a profiler session after spans were seen off (a solve run outside it).
The first root span of a new session drops the records before it.

This module imports nothing else of the package, so every layer may
import it.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import itertools
import os
import tempfile
import time

import torch


@contextlib.contextmanager
def trace(logdir: str = None, create_perfetto: bool = False):
    """Capture a torch.profiler trace around a block:

        with tracing.trace("tr"):
            ft.feast(A, X0, ...)

    Yields `logdir` (default: a directory under the system temporary
    directory).  `create_perfetto` is accepted for the JAX package's API;
    the Chrome trace torch writes loads in Perfetto as it is.  The solvers'
    spans record while it runs (`spans()`), and show in the trace as
    "span.<name>" ranges."""
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or os.path.join(tempfile.gettempdir(), "feast_tpu_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    _new_session()
    with profile(activities=acts) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named region inside a trace (host and device timeline)."""
    return torch.profiler.record_function(name)


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------

_recording = 0            # depth of the `recording()` blocks entered
_records: list = []       # finished spans, in the order they ended
_stack: list = []         # open spans, outermost first
_ids = itertools.count(1)
_fresh = True             # the next root span starts a new session


def _on() -> bool:
    """Whether spans record now.  Seen off, the session has ended."""
    global _fresh
    if _recording or torch._C._autograd._profiler_enabled():
        return True
    _fresh = True
    return False


def _new_session():
    """Let the next root span start a new session, unless spans are on
    already (a block inside a session stays in it)."""
    global _fresh
    if not (_recording or torch._C._autograd._profiler_enabled()):
        _fresh = True


class _Off:
    """The handle of a span that records nothing."""

    __slots__ = ()
    active = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, key, value):
        pass


_OFF = _Off()


class _Span:
    """An active span: its record, and its CUDA events until `spans()`."""

    __slots__ = ("rec", "device", "events", "offset", "t0", "rf")
    active = True

    def __init__(self, name: str, device, attrs: dict):
        self.rec = {"name": name, "id": next(_ids), "parent": None, "solve": None,
                    "t0_ns": 0, "t1_ns": 0, "host_s": 0.0, "device_s": None,
                    "attrs": attrs}
        self.device = None
        if device is not None:
            dev = torch.device(device)
            if dev.type == "cuda" and torch.cuda.is_available():
                self.device = dev
        self.events = None

    def set(self, key, value):
        """Attach an attribute to the record.  A tensor (a count the device
        keeps) is read by `spans()`, after its synchronisation."""
        self.rec["attrs"][key] = value

    def _event(self):
        """A timing event recorded on the current stream, or None while that
        stream is being captured into a graph."""
        if torch.cuda.is_current_stream_capturing():
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def __enter__(self):
        global _fresh
        rec = self.rec
        if _stack:
            rec["parent"] = _stack[-1].rec["id"]
            rec["solve"] = _stack[0].rec["id"]
            self.offset = _stack[0].offset
        else:
            if _fresh:
                _records.clear()
                _fresh = False
            rec["solve"] = rec["id"]
            # one offset from perf_counter to the wall clock per root span:
            # the profiler stamps its events on the wall clock's epoch
            self.offset = time.time_ns() - time.perf_counter_ns()
        _stack.append(self)
        self.rf = torch.profiler.record_function("span." + rec["name"])
        # stamped as the range opens: the profiler stamps the range's start
        # there, and a process's first range takes a millisecond to open
        self.t0 = time.perf_counter_ns()
        self.rf.__enter__()
        if self.device is not None:
            self.events = (self._event(), None)
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events = (self.events[0], self._event())
        t1 = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        rec = self.rec
        rec["t0_ns"], rec["t1_ns"] = self.t0 + self.offset, t1 + self.offset
        rec["host_s"] = (t1 - self.t0) / 1e9
        if _stack and _stack[-1] is self:
            _stack.pop()
        _records.append(self)
        return False


def span(name: str, device=None, **attrs):
    """A span named `name` around a block; yields a handle whose
    `set(key, value)` attaches an attribute and whose `active` says whether
    it records:

        with tracing.span("feast.factor", A.device):
            ...

    `device`: where the block's work runs; on a CUDA device the span
    records a CUDA event on the current stream at each end (none while the
    stream is captured into a graph).  Records nothing unless spans are on
    (`recording()`, or a torch profiler recording)."""
    return _Span(name, device, attrs) if _on() else _OFF


def spanned(name: str, device=None, attrs=None):
    """Decorator: each call of the function is a span named `name`.

        @tracing.spanned("nlfeast.extract", "Q0")
        def _extract(T, Q0, Q1, contour, scale): ...

    `device`: where the call's work runs, as the name of a parameter (its
    value a device, or a tensor on it) or as a function of the call's
    arguments; `attrs`: a function of the call's arguments that gives the
    span's attributes as a dict.  Both are read only while spans are on."""
    def wrap(fn):
        sig = inspect.signature(fn) if isinstance(device, str) else None

        def where(args, kwargs):
            if sig is not None:
                bound = sig.bind(*args, **kwargs)
                bound.apply_defaults()
                at = bound.arguments[device]
            else:
                at = None if device is None else device(*args, **kwargs)
            return getattr(at, "device", at)

        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not _on():
                return fn(*args, **kwargs)
            with _Span(name, where(args, kwargs),
                       {} if attrs is None else attrs(*args, **kwargs)):
                return fn(*args, **kwargs)
        return run
    return wrap


@contextlib.contextmanager
def recording():
    """Spans on inside the block, without the profiler:

        with tracing.recording():
            ft.feast_compiled(A, X0, ...)
        recs = tracing.spans()

    A block entered with spans off starts a new session: its first root
    span drops the records of earlier ones."""
    global _recording
    _new_session()
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def spans() -> list:
    """The finished spans' records, oldest end first, each a dict:

      name, id, parent, solve   the span's name, its id, its parent's id
                                (None for a root) and its root's id
      t0_ns, t1_ns              host start and end, ns on the clock of the
                                profiler's events
      host_s                    host seconds from start to end
      device_s                  on a CUDA device, the stream's seconds from
                                the span's start marker to its end marker
                                (the card's waits on the host included);
                                None on the CPU or where an end fell inside
                                a graph capture
      attrs                     the attributes given or set, a tensor
                                set as one read as its Python number

    Synchronises once where CUDA events or tensors on a card are pending,
    resolves them and drops them.  The records stay until `clear()`, or
    until the first root span of the next session."""
    pending = [s for s in _records if s.events is not None]
    counts = [(s.rec["attrs"], k, v) for s in _records
              for k, v in s.rec["attrs"].items() if isinstance(v, torch.Tensor)]
    devices = {s.device for s in pending} | {v.device for _, _, v in counts if v.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)
    for s in pending:
        e0, e1 = s.events
        if e0 is not None and e1 is not None:
            s.rec["device_s"] = e0.elapsed_time(e1) / 1e3
        s.events = None
    for attrs, k, v in counts:
        attrs[k] = v.item()
    return [dict(s.rec, attrs=dict(s.rec["attrs"])) for s in _records]


def clear():
    """Drop every finished span's record."""
    _records.clear()
