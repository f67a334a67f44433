"""``torch`` for the port's tests, its intra-op pool sized to one xdist
worker's share of the host.

Each pytest-xdist worker is a process of its own, and torch's intra-op
pool takes every core by default: six workers on an eight-core host then
run 48 compute threads on eight cores, and the port's tests spend most of
their time waiting for one another.  Imported under xdist, this module
sets the pool once per process to ``cpu_count // workers`` threads (at
least one); without xdist it leaves torch's default alone.  Every
``tests/test_torch_*.py`` takes ``torch`` from here
(``test_port_threads.py`` checks that), and each worker collects every
file, so the setting holds in every worker, those that run the JAX tests
too.
"""

import os

import pytest

torch = pytest.importorskip("torch")

_WORKERS = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
if _WORKERS:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(_WORKERS)))
