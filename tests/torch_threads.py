"""Torch's CPU threads in the port's tests (`tests/test_torch_*.py` import this).

The suite runs in several pytest-xdist workers at once.  Each worker's torch
would start one intra-op thread per core, so the workers' parallel regions
oversubscribe the machine: on 8 cores among 6 workers, a hierarchical bank
build that takes 0.5 s on one thread took 80 to 190 s, and six of the
port's test files took 2,635 worker-seconds against 425 with one thread a
worker.  So under xdist each worker takes its share of the cores; a run in
one process keeps torch's default.
"""

import os

import torch


def share_cores() -> int:
    """Set torch's intra-op threads to the cores over the xdist workers (at
    least 1); no change outside xdist.  Returns the thread count."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    if workers > 1:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    return torch.get_num_threads()


share_cores()
