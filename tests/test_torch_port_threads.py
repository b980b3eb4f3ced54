"""One PyTorch intra-op thread budget per test worker.

Under ``pytest -n N`` every worker is a process with PyTorch's default of
one intra-op thread per core, so N workers run N times the cores' worth of
threads, which spin against each other in every parallel region: a port
test file that takes about a minute alone took ten in a six-worker run.
Every port test module imports this one, which gives the worker its share
of the cores (all of them in a run without workers)."""

import os

import torch


def worker_threads() -> int:
    """The cores divided by the run's workers (pytest-xdist's
    PYTEST_XDIST_WORKER_COUNT), at least one."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, (os.cpu_count() or 1) // workers)


torch.set_num_threads(worker_threads())


def test_worker_threads_capped():
    assert torch.get_num_threads() == worker_threads()
