"""Structured metrics logging (port of dcgan_sr_tpu/utils/logging.py): the
reference's stdout log line, plus optional JSONL and CSV files."""

from __future__ import annotations

import csv
import functools
import json
import os
import time


class MetricsLogger:
    """Per-step metrics to stdout (reference log-line shape) and/or JSONL/CSV."""

    def __init__(self, jsonl_path=None, csv_path=None, stdout=True,
                 log_fn=None):
        if log_fn is None:
            # line-buffered even when stdout is a pipe
            log_fn = functools.partial(print, flush=True)
        self.stdout = stdout
        self.log_fn = log_fn
        self._jsonl = open(jsonl_path, "a") if jsonl_path else None
        self._csv_path = csv_path
        self._csv = None
        self._csv_writer = None
        self._t0 = time.time()

    def log_step(self, epoch, step, total_steps, step_time, data_time, metrics):
        fields = {k: float(v) for k, v in metrics.items()}
        if self.stdout:
            self.log_fn(
                "Epoch: [%d][%8d / %8d]\t Time: %.3f  DataTime: %.3f  "
                "  Err_G: %.16f  Err_D: %.4f"
                % (epoch, step, total_steps, step_time, data_time,
                   fields.get("errG", -1), fields.get("errD", -1)))
        rec = {"epoch": epoch, "step": step, "time": step_time,
               "data_time": data_time, "wall": time.time() - self._t0,
               **fields}
        if self._jsonl:
            self._jsonl.write(json.dumps(rec) + "\n")
            self._jsonl.flush()
        if self._csv_path:
            if self._csv is None:
                # the header goes only into a new file
                exists = os.path.isfile(self._csv_path)
                self._csv = open(self._csv_path, "a", newline="")
                self._csv_writer = csv.DictWriter(self._csv,
                                                  fieldnames=list(rec))
                if not exists:
                    self._csv_writer.writeheader()
            self._csv_writer.writerow(rec)
            self._csv.flush()

    def log_epoch(self, epoch, niter, elapsed):
        if self.stdout:
            self.log_fn("End of epoch %d / %d \t Time Taken: %.3f"
                        % (epoch, niter, elapsed))

    def close(self):
        if self._jsonl:
            self._jsonl.close()
        if self._csv:
            self._csv.close()
