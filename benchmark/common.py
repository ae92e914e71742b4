"""What the drivers share: the cell, the program's configuration, the
device's events and the loop of queued calls."""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any

import torch

from . import spec as S

# configuration-file keys that are not fields of the program's Config
NOT_PORT_KEYS = ("name", "source", "reduced", "generator", "assumed")


@dataclasses.dataclass
class Cell:
    """One run of one cell: its workload and configuration files (with any
    overrides applied), the seed, the window and the device."""
    name: str
    workload: dict
    config: dict
    seed: int
    seconds: float
    device: torch.device
    tracer: Any

    @property
    def traffic(self):
        return self.workload["traffic_params"]

    @property
    def compute_dtype(self):
        return {"bf16": torch.bfloat16, "fp32": None}[self.workload["dtype"]]

    @property
    def g_spec(self):
        return S.generator(self.config)

    @property
    def d_spec(self):
        return S.discriminator(self.config)

    def port_config(self, **extra):
        """The program's Config of this cell: the configuration file's keys
        (`extra`, the traffic's, over them) and the cell's dtype,
        environment overrides off."""
        from dcgan_sr_tpu_torch.core import get_config

        keys = {k: v for k, v in self.config.items()
                if k not in NOT_PORT_KEYS}
        variant = keys.pop("variant")
        keys.update(extra)
        dtype = {"bf16": "bfloat16", "fp32": "float32"}[
            self.workload["dtype"]]
        cfg = get_config(variant, env_override=False, compute_dtype=dtype,
                         **keys)
        for k, v in keys.items():
            if getattr(cfg, k) != v:
                raise ValueError(f"the program's config has {k}="
                                 f"{getattr(cfg, k)!r}, the file {v!r}")
        return cfg

    def check_port_specs(self, cfg):
        """Raise unless the program's networks for `cfg` are the
        benchmark's copies of the configuration file's."""
        from dcgan_sr_tpu_torch.models import discriminator_spec, \
            generator_spec

        if (list(generator_spec(cfg)) != list(self.g_spec)
                or list(discriminator_spec(cfg)) != list(self.d_spec)):
            raise ValueError("the program's networks are not the "
                             "configuration file's")

    def port_network(self, cfg, params, **kw):
        """The program's generator built from the benchmark's weights."""
        from dcgan_sr_tpu_torch.models import Network, generator_spec

        from .weights import port_trees

        self.check_port_specs(cfg)
        return Network(generator_spec(cfg), *port_trees(params),
                       device=self.device, **kw)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _event(device):
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


def queued_calls(call, seconds, device, tracer=None, trace_start=0,
                 trace_calls=0, depth=2):
    """Calls call(i) for i = 0, 1, ... while the window is open, with at
    most `depth` calls queued on the device, so the device never waits for
    the host to queue the next.  Calls trace_start .. trace_start +
    trace_calls - 1 run inside the tracer's stretch (when it is on), which
    starts and ends with an empty queue.  Returns (calls, seconds), the
    time taken from the first call to the end of the last."""
    pending = collections.deque()
    n = 0

    def enqueue():
        nonlocal n
        call(n)
        n += 1
        pending.append(_event(device))
        while len(pending) >= depth:
            ev = pending.popleft()
            if ev is not None:
                ev.synchronize()

    def drain():
        while pending:
            ev = pending.popleft()
            if ev is not None:
                ev.synchronize()

    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        if tracer is not None and tracer.enabled and n == trace_start \
                and tracer.reading is None:
            drain()
            with tracer.stretch():
                for _ in range(trace_calls):
                    enqueue()
                drain()
            continue
        enqueue()
    drain()
    sync(device)
    return n, time.perf_counter() - t0


def leaf_gaps(prog, ref, skip=None):
    """Each leaf's gap of norms: |norm(p) - norm(r)| over the larger of
    norm(r) and the median leaf's norm(r); None where `skip[i]` leaves
    leaf i out."""
    nr = [float(torch.linalg.vector_norm(r.float())) for r in ref]
    npg = [float(torch.linalg.vector_norm(p.float())) for p in prog]
    med = sorted(nr)[len(nr) // 2]
    return [None if skip and skip[i] else abs(a - b) / max(b, med, 1e-30)
            for i, (a, b) in enumerate(zip(npg, nr))]
