"""This test process's share of the CPU cores, set on import.

pytest-xdist runs several test processes side by side, and PyTorch
otherwise starts one intra-op thread a core in each of them: six workers
on eight cores run some 48 threads that contend for the eight cores, and
the port's tests run many times slower than alone. On import this module
sets PyTorch's intra-op threads to the cores this process may run on
divided by the number of workers (``PYTEST_XDIST_WORKER_COUNT``, 1
without xdist), at least one, and sets ``OMP_NUM_THREADS`` to the same
number unless it is set already, so that the command lines and scripts a
test starts as subprocesses inherit it. Every ``tests/test_torch_*.py``
imports it before anything else of its own.
"""

import os

import torch

THREADS = max(1, len(os.sched_getaffinity(0))
              // int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
torch.set_num_threads(THREADS)
os.environ.setdefault("OMP_NUM_THREADS", str(THREADS))
