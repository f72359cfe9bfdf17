"""Torch's CPU threads in the port's test files: two a process.

The suite runs in several pytest-xdist workers at once (six on an 8-core
host in tier 1). By default each worker's torch takes one OpenMP thread per
core, and that many threads spinning at their barriers across the workers
made the port's files 3-4x slower than with two a worker (658 against 198
seconds of wall for six of the slowest files run together on an 8-core
host).
Each ``tests/test_torch_*.py`` imports the fixture below, which keeps torch
at two threads while the file's tests run and restores the count after. No
result depends on it: every comparison here has a bar, or compares runs made
in one process.
"""

from __future__ import annotations

import pytest
import torch

TORCH_THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, TORCH_THREADS))
    yield
    torch.set_num_threads(n)
