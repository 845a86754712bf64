"""Size torch's intra-op threads to the test workers.

Every ``tests/test_torch_*.py`` imports this module first. Under
pytest-xdist each worker collects every file, so the setting holds in
each worker from collection on: ``os.cpu_count()`` divided by the
number of workers (``PYTEST_XDIST_WORKER_COUNT``), at least one. Without
it every worker's torch takes every core, and six workers run six times
as many spinning OpenMP threads as there are cores. A process started
with ``OMP_NUM_THREADS`` (a rank a test runs as a script) keeps at most
that many.

``subprocess_env`` is the environment for a subprocess a port test
starts: the caller's, with ``OMP_NUM_THREADS=1``.
"""

import os

import torch

WORKERS = max(1, int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
THREADS = max(1, (os.cpu_count() or 1) // WORKERS)
if os.environ.get("OMP_NUM_THREADS", "").isdigit():
    THREADS = max(1, min(THREADS, int(os.environ["OMP_NUM_THREADS"])))

torch.set_num_threads(THREADS)


def subprocess_env(**extra) -> dict:
    """``os.environ`` with ``OMP_NUM_THREADS=1`` and ``extra``."""
    return {**os.environ, "OMP_NUM_THREADS": "1", **extra}
