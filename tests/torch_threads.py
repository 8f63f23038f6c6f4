"""Caps torch's intra-op threads in a test process of the PyTorch port.

Every ``tests/test_torch_*.py`` imports this module first.  Under
``pytest-xdist`` each worker process would otherwise start one OpenMP
thread per core, so ``-n 6`` runs six times as many busy threads as the
machine has cores, and the port's tests then run several times slower
than alone.  Each worker gets its share of the cores:
``cpu_count // PYTEST_XDIST_WORKER_COUNT`` (at least 1), which is every
core when the file runs alone.
"""

import os

import torch

_WORKERS = max(1, int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
THREADS = max(1, (os.cpu_count() or 1) // _WORKERS)
torch.set_num_threads(THREADS)
