"""Structured metrics logging (port of dcgan_sr_tpu/utils/logging.py): the
reference's stdout log line, plus an optional JSONL file."""

from __future__ import annotations

import functools
import json
import time


class MetricsLogger:
    """Per-step metrics to stdout (reference log-line shape) and/or JSONL."""

    def __init__(self, jsonl_path=None, stdout=True, log_fn=None):
        if log_fn is None:
            # line-buffered even when stdout is a pipe
            log_fn = functools.partial(print, flush=True)
        self.stdout = stdout
        self.log_fn = log_fn
        self._jsonl = open(jsonl_path, "a") if jsonl_path else None
        self._t0 = time.time()

    def log_step(self, epoch, step, total_steps, step_time, data_time, metrics):
        fields = {k: float(v) for k, v in metrics.items()}
        if self.stdout:
            self.log_fn(
                "Epoch: [%d][%8d / %8d]\t Time: %.3f  DataTime: %.3f  "
                "  Err_G: %.16f  Err_D: %.4f"
                % (epoch, step, total_steps, step_time, data_time,
                   fields.get("errG", -1), fields.get("errD", -1)))
        if self._jsonl:
            rec = {"epoch": epoch, "step": step, "time": step_time,
                   "data_time": data_time, "wall": time.time() - self._t0,
                   **fields}
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()

    def log_epoch(self, epoch, niter, elapsed):
        if self.stdout:
            self.log_fn("End of epoch %d / %d \t Time Taken: %.3f"
                        % (epoch, niter, elapsed))

    def close(self):
        if self._jsonl:
            self._jsonl.close()
