"""The thread budget of the port's test processes: one intra-op thread.

Every `tests/test_torch_*.py` and `tests/torch_dp_worker.py` imports this
module, and a new port test file does the same instead of pinning threads
itself.  On import it

  - sets torch's intra-op pool of this process to one thread, and
  - sets OMP_NUM_THREADS=1 in this process's environment (unless it is set
    already), so that a CLI, tool or gloo-rank subprocess a test starts
    after that inherits one thread too.

Why: tier-1 runs `pytest tests/ -n 6 --dist loadfile` on an 8-core host.
With torch's default of one intra-op thread a core, each of the 6 workers,
and each subprocess a test starts, runs 8 threads: 48 or more busy threads
on 8 cores, spinning against each other.  On such a host the whole of
tier-1 took 1067 s with the default and 327 s with one thread (1560 passed
either way); six mid-weight port files, 130 tests, took 165 s and 20 min of
user CPU with the default, and 42 s and 2.5 min with one thread.

The pin covers the whole process and is never restored: under
pytest-xdist every worker imports every test module while it collects,
before it runs any test, so the setting holds for every test the worker
runs, the JAX package's included, and there is no point at which a
restore could take effect for one file alone.

Inter-op threads are left alone: `torch.set_num_interop_threads` raises
once parallel work has started in the process.
"""

import os

import torch

torch.set_num_threads(1)
os.environ.setdefault("OMP_NUM_THREADS", "1")
