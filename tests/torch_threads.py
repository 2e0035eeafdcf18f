"""Cap torch's intra-op threads in the port's test files under pytest-xdist.

Each xdist worker is a process with torch's default thread pool, one
thread per core, so n workers on an m-core host run n * m threads and the
port's CPU tests starve each other. Imported first by every
`tests/test_torch_*.py`: when pytest-xdist has started workers
(PYTEST_XDIST_WORKER_COUNT is set), each worker keeps cores // workers
threads (at least one). A serial run keeps all cores. The inter-op pool is
left alone: `torch.set_num_interop_threads` raises once parallel work has
started.
"""

import os

import torch

WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if WORKERS:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(WORKERS)))
