"""Each test worker's share of the host's cores for the port's CPU tests.

PyTorch sizes its intra-op thread pool to every core of the host.  Under
``pytest -n N`` (xdist) N workers each run the port's tests with that many
threads, and their spinning threads contend: a DreamerV3 test that takes
3 s alone took 161 s with five others like it beside it on an 8-core host,
and 3.3–4.4 s when each had one thread.  Importing this module (pytest
collects it in every worker) gives PyTorch in the worker, and through
``OMP_NUM_THREADS`` every process the worker starts, its share: the cores
this process may run on divided by the number of workers, at least one.  A
run without xdist keeps PyTorch's default.
"""

import os

import torch


def worker_share() -> int:
    """The cores of this process's affinity mask divided by the xdist worker count."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1") or 1)
    cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else (os.cpu_count() or 1)
    return max(1, cores // max(1, workers))


SHARE = worker_share() if "PYTEST_XDIST_WORKER" in os.environ else None
if SHARE is not None:
    torch.set_num_threads(SHARE)
    os.environ.setdefault("OMP_NUM_THREADS", str(SHARE))


def test_torch_threads_are_the_workers_share():
    if SHARE is None:
        assert worker_share() >= 1
        return
    assert torch.get_num_threads() == SHARE
    assert os.environ["OMP_NUM_THREADS"].isdigit()
