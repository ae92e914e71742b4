"""Requests to the server's coalescer (serve.py SRService.submit), in
process and without HTTP, arriving in an open loop.

traffic_params:
  rate            requests a second offered, fixed in the cell
  sizes           LR sides of the square requests, in equal shares
  max_batch, window_ms, max_size, u8_io
                  the service's settings (serve's defaults)
  clients         client threads; each blocks in submit, so that a slow
                  reply never holds back a request that is due
  check_per_size  requests of each size, drawn from the seed, whose
                  answers are compared with the reference

With --trace 1 the traced stretch runs from the first request due after a
third of the window to the last request's submission: the profiler's stop
and the trace's export then hold up no request that is due.

Every seed gives the same work in another order: the sizes in equal
shares and the gaps between arrivals the quantiles of an exponential
distribution of mean 1 / rate (a Poisson process's gaps), both shuffled by
the seed, scaled so that the requests fall due over the whole window.
Each request is its own image, uint8 levels drawn from the seed.  A
latency runs from the time the request was due to the time submit
returned; a failed request counts as missing (infinitely late).

The check: each sampled request's answer against the reference's, in
levels of 255 (request_gap: the worst request's mean absolute gap;
request_max_gap: the largest).
"""

from __future__ import annotations

import math
import queue
import threading
import time

import numpy as np

from ..reference import sr as R
from ..stats import percentile
from ..weights import calibrate_running, draw, generator_for


def schedule(n, rate, seconds, sizes, seed):
    """(due times in seconds, sides) of n requests."""
    rng = np.random.default_rng(seed)
    q = (np.arange(n) + 0.5) / n
    gaps = rng.permutation(-np.log1p(-q) / rate)
    ends = np.cumsum(gaps)
    due = (ends - gaps) * (seconds / ends[-1])
    sides = rng.permutation(np.resize(np.asarray(sizes), n))
    return due, sides


class Driver:
    def __init__(self, cell):
        self.cell = cell
        t = cell.traffic
        self.rate, self.sizes = float(t["rate"]), list(t["sizes"])
        self.n = int(round(self.rate * cell.seconds))

    def setup(self):
        import torch
        from dcgan_sr_tpu_torch.serve import SRService

        cell, dev, t = self.cell, self.cell.device, self.cell.traffic
        cfg = cell.port_config()
        params = draw(cell.g_spec, generator_for(cell.seed, dev, 0), dev)
        # running statistics from LR tiles of an image made from the seed
        gen = generator_for(cell.seed, dev, 2)
        p, ov = cell.config["patchSize"], cell.config["overlap"]
        img = torch.rand((1, 128, 128), generator=gen, device=dev)
        tiles = R.overlap_tiles(img, p // 2, ov // 2)[0][:, None]
        self.params = calibrate_running(cell.g_spec, params, tiles, gen)
        net = cell.port_network(cfg, self.params)
        self.service = SRService(
            cfg, net, max_size=t["max_size"], max_batch=t["max_batch"],
            window_ms=t["window_ms"], bn_eval=True,
            compute_dtype=cell.compute_dtype, u8_io=t["u8_io"])
        self.buckets = R.ladder(cell.config, t["max_size"])
        if self.buckets != list(self.service.buckets):
            raise ValueError(f"the server's ladder {self.service.buckets} "
                             f"is not the reference's {self.buckets}")
        # the cell's own shapes: its buckets at batch 1, 2, 4 and 8
        batches = sorted({min(1 << j, t["max_batch"])
                          for j in range(t["max_batch"].bit_length())})
        for s in self.sizes:
            warm = np.zeros((s, s), np.float32)
            for b in batches:
                self.service.submit_many([warm] * b, "2x")
        self.due, self.sides = schedule(self.n, self.rate, cell.seconds,
                                        self.sizes, cell.seed)
        rng = np.random.default_rng(cell.seed + 1)
        self.images = [(rng.integers(0, 256, (s, s), dtype=np.uint8)
                        .astype(np.float32) / 255.0) for s in self.sides]
        self.sample = set()
        for s in self.sizes:
            idx = np.flatnonzero(self.sides == s)
            k = min(t["check_per_size"], len(idx))
            self.sample.update(int(i) for i in rng.choice(idx, k,
                                                          replace=False))

    def window(self):
        cell, t = self.cell, self.cell.traffic
        n = self.n
        done = np.full(n, np.nan)
        self.kept = {}
        failed = []
        work = queue.SimpleQueue()

        def client():
            while True:
                i = work.get()
                if i is None:
                    return
                try:
                    out = self.service.submit(self.images[i], "2x")
                except Exception as e:      # a failed request is missing
                    failed.append((i, repr(e)))
                    continue
                done[i] = time.perf_counter()
                if i in self.sample:
                    self.kept[i] = out

        threads = [threading.Thread(target=client, daemon=True)
                   for _ in range(t["clients"])]
        for th in threads:
            th.start()
        stats0 = dict(self.service.stats)
        late = np.zeros(n)
        tracer = cell.tracer
        trace_from = cell.seconds / 3
        stretch = None
        t0 = time.perf_counter()
        for i in range(n):
            due = self.due[i]
            if tracer.enabled and stretch is None and due >= trace_from \
                    and tracer.reading is None:
                stretch = tracer.stretch(sync=False)
                stretch.__enter__()
            wait = t0 + due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            work.put(i)
            late[i] = time.perf_counter() - (t0 + due)
        if stretch:
            stretch.__exit__(None, None, None)
        for _ in threads:
            work.put(None)
        limit = time.perf_counter() + 60.0
        for th in threads:
            th.join(timeout=max(0.0, limit - time.perf_counter()))
        stats1 = dict(self.service.stats)
        lat = [(done[i] - (t0 + self.due[i])) * 1e3
               if np.isfinite(done[i]) else math.inf for i in range(n)]
        fifth = max(1, n // 5)
        d_req = stats1["requests"] - stats0["requests"]
        d_bat = stats1["batches"] - stats0["batches"]
        return {
            "metrics": {"serve_ms_p50": percentile(lat, 50),
                        "serve_ms_p95": percentile(lat, 95)},
            "attempted": n, "failed": n - int(np.isfinite(done).sum()),
            "counters": {"requests": d_req, "batches": d_bat},
            "work": {},
            "notes": {"requests": n, "offered_per_s": n / cell.seconds,
                      "generator_late_ms_max": float(late.max() * 1e3),
                      "generator_late_ms_p95": percentile(late * 1e3, 95),
                      "first_fifth_p50_ms": percentile(lat[:fifth], 50),
                      "last_fifth_p50_ms": percentile(lat[-fifth:], 50),
                      "p99_ms": percentile(lat, 99),
                      "errors": failed[:3],
                      "stats": stats1},
        }

    def release(self):
        self.service.close()
        del self.service

    def _reference(self, i, precision="fp32"):
        import torch
        img = torch.from_numpy(self.images[i]).to(self.cell.device)
        return R.serve_request(self.cell.g_spec, self.params, img,
                               self.cell.config, self.buckets, precision)

    def readings(self, kind="program"):
        import torch
        if not self.kept:
            raise RuntimeError("no sampled request was answered")
        keys = sorted(self.kept)
        worst_mean, worst_max = 0.0, 0.0
        for j, i in enumerate(keys):
            ref = self._reference(i).float()
            if kind == "program":
                got = torch.round(torch.from_numpy(np.asarray(
                    self.kept[i])).to(ref.device) * 255.0)
            elif kind == "control":
                got = self._reference(i, "fp8").float()
            elif kind == "fault_swap":
                # the answer of another request of the same size
                other = next((k for k in keys if k != i and
                              self.sides[k] == self.sides[i]), i)
                got = torch.round(torch.from_numpy(np.asarray(
                    self.kept[other])).to(ref.device) * 255.0)
            else:
                raise ValueError(f"unknown reading kind {kind!r}")
            d = (got - ref).abs()
            worst_mean = max(worst_mean, float(d.mean()))
            worst_max = max(worst_max, float(d.max()))
        return {"request_gap": worst_mean, "request_max_gap": worst_max}
