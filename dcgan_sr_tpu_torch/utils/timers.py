"""torch.Timer-compatible wall-clock timer (port of dcgan_sr_tpu/utils/timers.py).

The reference instruments its loop with three timers — per-batch `tm`,
data-wait `data_tm`, per-epoch `epoch_tm` (train.lua:159-161) plus a
total-runtime timer (train-gray-3.lua:6,628) — using reset/resume/stop and
`:time().real`.  Same surface here.
"""

from __future__ import annotations

import time


class Timer:
    def __init__(self):
        self.reset()

    def reset(self):
        self._accum = 0.0
        self._start = time.perf_counter()
        self._running = True
        return self

    def resume(self):
        if not self._running:
            self._start = time.perf_counter()
            self._running = True
        return self

    def stop(self):
        if self._running:
            self._accum += time.perf_counter() - self._start
            self._running = False
        return self

    def time(self):
        real = self._accum
        if self._running:
            real += time.perf_counter() - self._start
        return {"real": real}
