"""Caps torch's intra-op threads for the port's tests (not a test module).

Every tests/test_torch_*.py imports it first.  The tier-1 run deals the test
files to several pytest-xdist workers on one host; torch's default of one
intra-op thread a core in each of them oversubscribes the cores, and the
port's small tensors gain nothing from more threads than this."""

import torch

TORCH_THREADS = 2

torch.set_num_threads(TORCH_THREADS)
