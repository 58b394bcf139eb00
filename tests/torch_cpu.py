"""What every port test on the CPU shares: one intra-op thread, and a deadline
on every process a test starts.

A port test file takes the thread setting with one line,

    from torch_cpu import one_thread  # noqa: F401

and starts a subprocess with `env=child_env()` and a `timeout=`, or ranks
with `spawn_ranks`. The suite runs several pytest workers on the machine's
cores; at torch's default, each worker's intra-op pool is as wide as the
machine, and the pools fight over the cores: the small CPU calls of these
tests then run one to two orders of magnitude slower than on one thread.

A deadline is about three times what its case takes in the suite's
six-worker run on 8 CPUs, and 60 s at the least (a child's first imports
on a loaded host); none is above 300 s.
"""

from __future__ import annotations

import os
import time

import pytest
import torch

THREADS = 1


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's tests under `THREADS` intra-op threads; the old value after."""
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


def child_env() -> dict:
    """The environment of a subprocess a port test starts: without
    `PYTHONPATH` (the child finds the repo from its working directory) and
    with torch's pool at `THREADS` threads."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = str(THREADS)
    return env


def _rank(i: int, fn, *args) -> None:
    torch.set_num_threads(THREADS)
    fn(i, *args)


def spawn_ranks(fn, args: tuple, nprocs: int, seconds: float) -> None:
    """`fn(rank, *args)` in `nprocs` spawned processes on `THREADS` threads
    each, joined against a deadline of `seconds`: a rank that raises fails
    the caller as `torch.multiprocessing.spawn` does, and ranks still running
    at the deadline are ended and the calling test fails, by name."""
    ctx = torch.multiprocessing.start_processes(_rank, args=(fn, *args), nprocs=nprocs, join=False,
                                                start_method="spawn")
    deadline = time.monotonic() + seconds
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                alive = [i for i, p in enumerate(ctx.processes) if p.is_alive()]
                pytest.fail(f"{os.environ.get('PYTEST_CURRENT_TEST', fn.__qualname__)}: ranks {alive} of "
                            f"{nprocs} still running after the deadline of {seconds:g} s", pytrace=False)
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
