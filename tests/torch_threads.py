"""Bounds torch's intra-op threads to this pytest-xdist worker's share of
the cores; every tests/test_torch_*.py module imports it.

Under ``-n 6`` on 8 cores each worker's torch would start a thread per
core, and six workers' threads, which spin while they wait for work,
contend for the cores: a parity test then runs several times slower than
alone (six concurrent copies of one tree-AH build-parity case: 147 s at
8 threads, 30 s at 1).  One process, without xdist, keeps torch's
default."""

import os

import torch

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))
