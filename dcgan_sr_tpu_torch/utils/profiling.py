"""Profiling hooks: a torch.profiler trace around a measured region (port
of dcgan_sr_tpu/utils/profiling.py profile_trace).

The reference's only instrumentation is torch.Timer wall clocks; here the
same timers exist (utils/timers.py) plus a trace of the host's operators
and, on a card, its kernels, written as a Chrome trace (chrome://tracing,
Perfetto).  The JAX module's `device_cost_analysis` is XLA's own cost model
of a compiled program; PyTorch runs eagerly and has no compiled program to
ask, so it has no counterpart here: a kernel's operations and bytes are
counted from its shapes where it is measured (chip_smoke.py).
"""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def profile_trace(log_dir, enabled=True):
    """Context manager: capture a torch.profiler trace of the enclosed
    region into `log_dir`/trace_<pid>.json (CPU activity, and CUDA activity
    where a card is visible); yields the profiler (None when disabled)."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}.json"))
