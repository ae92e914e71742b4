"""Async batch prefetcher — the donkey thread pool, natively (port of
dcgan_sr_tpu/data/prefetch.py: the same per-worker seed streams, so a seeded
run reads the same batches in the same order in both packages).

Reference (data/data.lua): N threads each seeded manualSeed+idx (:35-36),
n jobs pre-enqueued (:59-62), getBatch() enqueues one job and dequeues one
result (:82-93) — exactly n batches in flight at all times.  N=0 degrades to
a synchronous single-thread mode (:45-51), kept here as the deterministic
seam for tests.

Threaded, it keeps the reference discipline (the JAX package's strict
mode): n jobs pre-enqueued, one job enqueued per get_batch(), results
consumed in job order.  Jobs are dispatched round-robin to workers (a
deterministic refinement of the reference's whichever-donkey-is-free
scheduling), so a seeded run yields a reproducible batch sequence even with
n_threads > 1.

An exception raised by sample_fn in a worker (an unreadable image file)
is handed to the consumer and raised by get_batch(), instead of leaving it
waiting for a batch that never comes.
"""

from __future__ import annotations

import collections
import queue
import threading

import numpy as np


class _Failed:
    """A worker's exception, carried to the consumer in the batch's place."""

    def __init__(self, error):
        self.error = error


class PrefetchLoader:
    def __init__(self, sample_fn, n_threads=4, manual_seed=0):
        """sample_fn(rng) -> one batch (numpy array)."""
        self.sample_fn = sample_fn
        self.n_threads = n_threads
        self.manual_seed = manual_seed
        self._sync_rng = np.random.RandomState(manual_seed)
        if n_threads <= 0:
            return
        self._threads = []
        self._inboxes = [queue.Queue() for _ in range(n_threads)]
        self._pending = collections.deque()
        self._next_worker = 0
        for idx in range(1, n_threads + 1):
            t = threading.Thread(target=self._worker, args=(idx,),
                                 daemon=True)
            t.start()
            self._threads.append(t)
        for _ in range(n_threads):  # pre-enqueue n jobs (data.lua:59-62)
            self._enqueue_job()

    def _enqueue_job(self):
        slot = queue.Queue()  # unbounded: a result is never blocked on put
        self._inboxes[self._next_worker].put(slot)
        self._next_worker = (self._next_worker + 1) % self.n_threads
        self._pending.append(slot)

    def _worker(self, idx):
        rng = np.random.RandomState(self.manual_seed + idx)  # data.lua:35-36
        inbox = self._inboxes[idx - 1]
        while True:
            slot = inbox.get()
            if slot is None:  # close sentinel
                return
            slot.put(self._sample(rng))

    def _sample(self, rng):
        try:
            return self.sample_fn(rng)
        except Exception as e:      # raised again by get_batch, in order
            return _Failed(e)

    def get_batch(self):
        if self.n_threads == 0:
            return self.sample_fn(self._sync_rng)  # synchronous fallback
        self._enqueue_job()  # one in (data.lua:84)...
        out = self._pending.popleft().get()  # ...one out, job order
        if isinstance(out, _Failed):
            raise out.error
        return out

    def close(self):
        if self.n_threads <= 0:
            return
        for inbox in self._inboxes:
            inbox.put(None)
        for t in self._threads:
            t.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
