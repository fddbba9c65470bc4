"""N CPU ranks of one function on this host, joined in one gloo group: the
port's tests' counterpart of the JAX package's virtual CPU mesh.

A failing or hung rank cannot hang the run: every collective gives up
after COLLECTIVE_TIMEOUT, and `run_local_ranks` terminates every rank
still alive at its deadline."""

import datetime
import multiprocessing
import time
from typing import Callable, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing

COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=30)


def _rank_main(rank: int, fn: Callable, world_size: int, init_file: str,
               args: Sequence) -> None:
    torch.set_num_threads(1)  # the ranks share the host's cores
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=world_size, timeout=COLLECTIVE_TIMEOUT)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def run_local_ranks(fn: Callable, world_size: int, args: Sequence = (), *, init_file: str,
                    deadline_s: float = 60.0) -> None:
    """Run `fn(rank, *args)` in `world_size` fresh CPU processes joined in
    one gloo group, which rendezvous through `init_file` (a path that does
    not exist yet). `fn` and `args` must pickle (`fn` defined at a module's
    top level). Raises the first rank's exception, or TimeoutError when the
    ranks have not all ended `deadline_s` after the start; either way no
    rank is left running.

    The ranks fork from a forkserver, a single-threaded process that
    imports torch and the port once for the calling process, so that a run
    after the first starts in a fraction of a second where a spawn takes
    seconds to import them."""
    multiprocessing.get_context("forkserver").set_forkserver_preload(
        ["torch", "ray_tpu_torch.models"])
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(fn, world_size, init_file, tuple(args)),
        nprocs=world_size, join=False, start_method="forkserver",
    )
    deadline = time.monotonic() + deadline_s
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"{world_size} ranks did not end within {deadline_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        for p in ctx.processes:
            p.join(10)
