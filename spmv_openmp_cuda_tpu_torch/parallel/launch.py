"""The ranks of a torch.distributed group on one host, for the multi-device
paths across processes (parallel/mesh.py).

run_ranks(fn, world, backend, args, timeout) starts `world` processes by the
spawn start method (a forked child cannot use CUDA once the parent has), and
rank r calls fn(r, world, *args) inside a group started by
init_process_group(backend, "tcp://localhost:<a free port>"); an NCCL rank
takes cuda:r first. It waits at most `timeout` seconds: a rank that exits
with an error, or any rank still running at the deadline, ends every rank
and raises RuntimeError. Nothing is retried, and the backend is never
switched.

fn must be importable by name (a module's top-level function), as must the
module defining it. The same group by hand: `torchrun --nproc-per-node 2
script.py`, the script calling dist.init_process_group("gloo") and then
parallel.mesh.make_mesh(devices=[its own devices]).
"""
from __future__ import annotations

import datetime
import multiprocessing
import multiprocessing.connection
import socket
import time
from typing import Callable, Sequence

import torch


def _free_port() -> int:
    """A TCP port of localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn: Callable, rank: int, world: int, backend: str, init_method: str,
               timeout: float, args: tuple) -> None:
    import torch.distributed as dist

    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    fn(rank, world, *args)
    # after a failure the process exits without it: tearing down a group
    # whose peer waits in a collective can block
    dist.destroy_process_group()


#: seconds the other ranks get to exit after one has failed
_GRACE = 2.0


def _wait_some(procs, timeout: float) -> None:
    """Until a running process exits, or timeout seconds."""
    running = [p.sentinel for p in procs if p.exitcode is None]
    if running:
        multiprocessing.connection.wait(running, timeout=timeout)


def run_ranks(fn: Callable, world: int, backend: str = "gloo", args: Sequence = (),
              timeout: float = 120.0) -> None:
    """fn(rank, world, *args) in `world` spawned processes of one group;
    returns when every rank has exited 0, else kills them all and raises."""
    ctx = multiprocessing.get_context("spawn")
    init_method = f"tcp://localhost:{_free_port()}"
    procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                         args=(fn, r, world, backend, init_method, timeout, tuple(args)))
             for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while True:
            if any(p.exitcode not in (None, 0) for p in procs):
                # the others' failures follow within moments (a closed
                # connection): name them all
                _wait_some(procs, _GRACE)
                codes = [p.exitcode for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                raise RuntimeError(f"rank(s) {bad} of {world} exited with code(s) "
                                   f"{[codes[r] for r in bad]}")
            codes = [p.exitcode for p in procs]
            if all(c == 0 for c in codes):
                return
            left = deadline - time.monotonic()
            if left <= 0:
                running = [r for r, c in enumerate(codes) if c is None]
                raise RuntimeError(f"rank(s) {running} of {world} still running after {timeout} s")
            _wait_some(procs, min(left, 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(10)
