"""The traced stretch of a run: torch.profiler over CPU and CUDA activity,
exported as a Chrome trace under TMPDIR, read back, deleted.

A driver wraps a steady part of its window in `Tracer.stretch()`.  The
reading gives the device's busy seconds (the union of kernels, copies and
sets), the stretch's length on the host clock, each kernel with its name,
start and duration, and the host operators, for the idle gaps' labels.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time

from .stats import busy_time, idle_gaps

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Reading:
    """What one traced stretch showed."""

    def __init__(self, events, window_s):
        self.window_s = window_s
        self.kernels = []           # (name, start_us, dur_us)
        self.device = []            # (start_us, end_us) of every device op
        self.host = []              # (name, start_us, end_us) host operators
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            ts, dur = float(e["ts"]), float(e["dur"])
            cat = e.get("cat")
            if cat in DEVICE_CATS:
                self.device.append((ts, ts + dur))
                if cat == "kernel":
                    self.kernels.append((e.get("name", "?"), ts, dur))
            elif cat in ("cpu_op", "user_annotation", "cuda_runtime",
                         "python_function"):
                self.host.append((f"{cat}:{e.get('name', '?')}", ts, ts + dur))
        stamps = [s for s, _ in self.device] + [h[1] for h in self.host]
        ends = [e for _, e in self.device] + [h[2] for h in self.host]
        self.start_us = min(stamps) if stamps else 0.0
        self.end_us = max(ends) if ends else 0.0

    @property
    def busy_s(self):
        return busy_time(self.device, self.start_us, self.end_us) / 1e6

    def kernel_seconds(self, match):
        """Seconds of the kernels whose name `match(name)` accepts, and
        their count."""
        hits = [d for n, _, d in self.kernels if match(n)]
        return sum(hits) / 1e6, len(hits)

    def device_ops(self, top=10):
        """[[kernel name, seconds]] of the kernels that took most time."""
        by = {}
        for n, _, d in self.kernels:
            by[n] = by.get(n, 0.0) + d
        rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[n, d / 1e6] for n, d in rows]

    def idle(self, top=10):
        """[[what the host was doing, seconds]] of the longest idle gaps
        of the device: each gap named by the host operator that overlaps it
        most."""
        gaps = sorted(idle_gaps(self.device, self.start_us, self.end_us),
                      key=lambda g: g[0] - g[1])[:top]
        out = []
        for s, e in gaps:
            best, name = 0.0, "host: no operator recorded"
            for n, hs, he in self.host:
                ov = min(e, he) - max(s, hs)
                if ov > best:
                    best, name = ov, n
            out.append([name, (e - s) / 1e6])
        return out


class Tracer:
    """`stretch()` profiles the enclosed calls when enabled; `reading` holds
    the result."""

    def __init__(self, enabled, sync):
        self.enabled = enabled
        self.sync = sync
        self.reading = None

    def warm_up(self):
        """Start and stop the profiler once, in set-up: its first start
        initialises the tracing library, which would otherwise hold up the
        window (an open loop's schedule above all)."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts):
            torch.ones(1).add_(1)

    @contextlib.contextmanager
    def stretch(self, sync=True):
        """Profile the enclosed calls; with `sync` the device's queue is
        drained at both ends (whole calls), without it the stretch is a
        slice of time of a system that keeps running."""
        if not self.enabled or self.reading is not None:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        if sync:
            self.sync()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            yield
            if sync:
                self.sync()
            window_s = time.perf_counter() - t0
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.remove(path)
        events = data["traceEvents"] if isinstance(data, dict) else data
        self.reading = Reading(events, window_s)
