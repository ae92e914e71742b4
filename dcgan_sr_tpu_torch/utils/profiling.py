"""Profiling: a torch.profiler trace around a measured region (port of
dcgan_sr_tpu/utils/profiling.py profile_trace), and the port's spans.

The reference's only instrumentation is torch.Timer wall clocks; here the
same timers exist (utils/timers.py) plus a trace of the host's operators
and, on a card, its kernels, written as a Chrome trace (chrome://tracing,
Perfetto).  The JAX module's `device_cost_analysis` is XLA's own cost model
of a compiled program; PyTorch runs eagerly and has no compiled program to
ask, so it has no counterpart here.

Spans.  `span(name)` marks one stage or layer of the program: the SR
pipeline's stages (`sr.*`, infer/tiled.py), the generator's layers (`cast`,
`conv`, `bn`, `act`, models/network.py; `bulge`, ops/bulge.py) and the train
step's stages (`train.*`, train/step.py and train/multi_step.py).  A span
is on exactly while a torch.profiler session is active (the benchmark's
traced stretch, `cli --profile-dir`, an operator's own profiler).  Off, it
costs one check of the profiler's flag and returns a shared null context.
On, it enters `torch.profiler.record_function(name)`, so it shows in the
trace as a `user_annotation` on the same clock as the kernels, and keeps a
record in this module's store: its name, its parent span and call id, its
host start and end and, once CUDA is initialised, a pair of timing events
on the current stream for its device start and end.  Without CUDA the
device time is the host time (eager CPU operators are synchronous).  The
events are read only when `span_totals()` or `span_records()` is called;
`reset_spans()` empties the store.

Counters.  `counters` counts the layers of the port-only models that have
no kernel counter of their own, as they run in this process: residual sums
("residual", a block's or the long skip's), PixelShuffles ("shuffle") and
PReLUs ("prelu") (models/network.py), whether or not a profiler runs.  Their
spans are `residual` (around each sum), `shuffle` (around each PixelShuffle)
and `act` (around each PReLU).

A CUDA graph runs no host code when it is replayed, so the train step's
stages (`stage(name)`) also mark their boundaries inside
`capture_stages()`, which the K-step runner wraps around its capture
whether or not a profiler runs: each boundary is one timing event recorded
with `external=True`, an event-record node of the graph that the card
records at every replay.  A stage runs from the boundary before it to its
own end, so the captured stages tile the work between the first and the
last.  The store keeps the graph's events (they outlive the runner), and
`span_totals()` counts each captured stage once more, with its device time
in the graph's last replay.  Other spans record nothing inside a capture.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time

import torch

_profiler_enabled = torch.autograd._profiler_enabled
_NULL = contextlib.nullcontext()

counters = {"residual": 0, "shuffle": 0, "prelu": 0}


@contextlib.contextmanager
def profile_trace(log_dir, enabled=True):
    """Context manager: capture a torch.profiler trace of the enclosed
    region into `log_dir`/trace_<pid>.json (CPU activity, and CUDA activity
    where a card is visible); yields the profiler (None when disabled)."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}.json"))


# ---- spans ------------------------------------------------------------------

class _Record:
    """One span as it ran: `events` (device start, end) until resolved into
    `device_s`."""

    __slots__ = ("name", "id", "parent", "t0", "t1", "events", "device_s")

    def __init__(self, name, parent):
        self.name, self.parent = name, parent
        self.id = next(_store.ids)
        self.t1 = self.events = self.device_s = None

    def resolve(self):
        if self.device_s is None:
            if self.events is None:
                self.device_s = self.t1 - self.t0
            else:
                start, end = self.events
                end.synchronize()
                self.device_s = start.elapsed_time(end) / 1e3
                self.events = None
        return self.device_s


class _Capture:
    """The boundary events of one captured graph and its stages as
    (name, index of the boundary before, index of its end)."""

    def __init__(self):
        self.events = []
        self.stages = []

    def mark(self):
        ev = torch.cuda.Event(enable_timing=True, external=True)
        ev.record()
        self.events.append(ev)
        return len(self.events) - 1

    def stage_seconds(self):
        """[(name, device s in the last replay)]; [] before any replay."""
        if not self.events:
            return []
        try:
            self.events[-1].synchronize()
            return [(n, self.events[a].elapsed_time(self.events[b]) / 1e3)
                    for n, a, b in self.stages]
        except RuntimeError:        # never replayed: no event recorded yet
            return []


class _Store:
    def __init__(self):
        self.records = []           # _Record, in the order the spans began
        self.graphs = []            # _Capture of every captured graph
        self.ids = itertools.count(1)
        self.local = threading.local()
        self.capture = None         # the _Capture being recorded

    def stack(self):
        s = getattr(self.local, "stack", None)
        if s is None:
            s = self.local.stack = []
        return s


_store = _Store()


def _capturing():
    return _store.capture is not None or (
        torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing())


class _Span:
    __slots__ = ("name", "rf", "rec")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        self.rec = None
        if not _capturing():
            stack = _store.stack()
            rec = self.rec = _Record(self.name,
                                     stack[-1].id if stack else None)
            stack.append(rec)
            _store.records.append(rec)
            if torch.cuda.is_initialized():
                rec.events = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                rec.events[0].record()
            rec.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec is not None:
            if rec.events is not None:
                rec.events[1].record()
            rec.t1 = time.perf_counter()
            _store.stack().pop()
        self.rf.__exit__(*exc)
        return False


class _GraphStage:
    """A stage span inside `capture_stages()`."""

    __slots__ = ("name", "rf", "start")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        cap = _store.capture
        self.start = len(cap.events) - 1 if cap.events else cap.mark()
        self.rf = None
        if _profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        cap = _store.capture
        cap.stages.append((self.name, self.start, cap.mark()))
        return False


def span(name):
    """Context manager: one span named `name` while a profiler runs, else a
    shared null context (module docstring)."""
    if not _profiler_enabled():
        return _NULL
    return _Span(name)


def stage(name):
    """`span(name)` for a stage of the train step, which inside
    `capture_stages()` also marks its end as an event node of the graph."""
    if _store.capture is not None:
        return _GraphStage(name)
    return span(name)


@contextlib.contextmanager
def capture_stages():
    """Around a CUDA graph's capture: the stages inside mark their
    boundaries as event nodes of the graph, which the store keeps once the
    capture has succeeded."""
    cap = _store.capture = _Capture()
    try:
        yield
    finally:
        _store.capture = None
    _store.graphs.append(cap)


def span_records():
    """The finished spans in the order they began, each a dict of name, id,
    parent (the enclosing span's id or None), host_s and device_s.  Captured
    stages are not among them (see `span_totals`)."""
    return [{"name": r.name, "id": r.id, "parent": r.parent,
             "host_s": r.t1 - r.t0, "device_s": r.resolve()}
            for r in list(_store.records) if r.t1 is not None]


def span_totals():
    """{name: {"count", "host_s", "device_s", "self_device_s"}} over the
    finished spans; self_device_s is device_s less the part its child spans
    cover.  Each stage of a captured graph adds once to its name's count
    and device time, with its time in that graph's last replay (no host
    time: a replay runs no host code)."""
    recs = span_records()
    covered = {}
    for r in recs:
        if r["parent"] is not None:
            covered[r["parent"]] = covered.get(r["parent"], 0.0) + r["device_s"]
    out = {}

    def add(name, host_s, device_s, self_s):
        t = out.setdefault(name, {"count": 0, "host_s": 0.0, "device_s": 0.0,
                                  "self_device_s": 0.0})
        t["count"] += 1
        t["host_s"] += host_s
        t["device_s"] += device_s
        t["self_device_s"] += self_s

    for r in recs:
        add(r["name"], r["host_s"], r["device_s"],
            max(0.0, r["device_s"] - covered.get(r["id"], 0.0)))
    for cap in list(_store.graphs):
        for name, secs in cap.stage_seconds():
            add(name, 0.0, secs, secs)
    return out


def reset_spans():
    """Forget every recorded span and every captured graph's events."""
    _store.records.clear()
    _store.graphs.clear()
