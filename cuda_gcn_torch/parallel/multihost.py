"""Process-group set-up and a local launcher for the sharded trainer.

The counterpart of cuda_gcn_tpu/parallel/multihost.py, where
``jax.distributed.initialize`` reads its coordinator from the environment.
Here ``initialize`` calls ``torch.distributed.init_process_group`` explicitly:
from the given ``init_method`` (``file://`` or ``tcp://``), world size and
rank, or from the environment that ``torchrun`` sets (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``). Nothing in the environment
names a cluster otherwise; without either it is a single process and does
nothing.

The backend is the caller's: NCCL by default on ``cuda``, one card per rank,
rank r on ``cuda:r`` of its host; gloo by default on the CPU, and on request
for ranks that share one card (NCCL refuses two ranks on one GPU). Fewer cards
than NCCL ranks raises.

``run_ranks`` starts N local ranks with the ``spawn`` start method, each in
a group initialised through a ``file://`` store in a fresh temporary
directory, and returns what each rank's function returns. A rank that raises
or dies ends the others, and ``run_ranks`` raises with its traceback.
"""

from __future__ import annotations

import multiprocessing
import os
import queue as queue_mod
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str | None = None,
               device: str | torch.device | None = None) -> bool:
    """Initialise the default process group; True if it was initialised here.
    ``backend`` defaults to NCCL on a ``cuda`` device (``device``, default
    cuda) and gloo on the CPU; an NCCL rank binds ``cuda:<local rank>``
    (``LOCAL_RANK`` under torchrun, else the rank)."""
    if init_method is None and not all(k in os.environ for k in _TORCHRUN_ENV):
        return False
    if init_method is None:
        init_method = "env://"
        world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
        rank = int(os.environ["RANK"]) if rank is None else rank
    dev = torch.device("cuda" if device is None else device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        have = torch.cuda.device_count()
        if local >= have:
            raise RuntimeError(f"NCCL rank {rank} needs cuda:{local}, have {have} CUDA "
                               f"devices: NCCL takes one card per rank")
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank)
    return True


def is_primary() -> bool:
    """True on the process that owns logging and checkpoint writes: rank 0,
    or a process outside any group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _rank_main(fn, rank: int, world_size: int, init_method: str, args, results) -> None:
    try:
        results.put((rank, True, fn(rank, world_size, init_method, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world_size: int, args: tuple = (), rank_args: list | None = None,
              timeout: float | None = None) -> list:
    """Run ``fn(rank, world_size, init_method, *args, *rank_args[rank])`` in
    ``world_size`` spawned processes and return their results by rank.
    ``fn`` (a module-level function) calls ``initialize(init_method,
    world_size, rank, ...)`` itself; a group it leaves open is destroyed.
    Raises RuntimeError when a rank fails or dies and, with a ``timeout``,
    TimeoutError after that many seconds, having ended every rank."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init_method = f"file://{os.path.join(tmp, 'store')}"
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            fn, r, world_size, init_method,
            tuple(args) + (tuple(rank_args[r]) if rank_args is not None else ()), results))
            for r in range(world_size)]
        for p in procs:
            p.start()
        got: dict = {}
        failure = None
        deadline = time.monotonic() + (float("inf") if timeout is None else timeout)
        try:
            while len(got) < world_size and failure is None:
                try:
                    rank, ok, value = results.get(timeout=0.5)
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode is not None and r not in got]
                    if dead:  # drain what a dead rank may still have sent
                        time.sleep(0.5)
                        if results.empty():
                            failure = (f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no result")
                    elif time.monotonic() > deadline:
                        raise TimeoutError(f"{world_size} ranks did not finish in "
                                           f"{timeout:.0f} s")
                    continue
                if ok:
                    got[rank] = value
                else:
                    failure = f"rank {rank} failed:\n{value}"
            for p in procs if failure is None else ():  # a failed run's peers are ended
                p.join(timeout=min(max(deadline - time.monotonic(), 5.0), 60.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
        if failure is not None:
            raise RuntimeError(failure)
        return [got[r] for r in range(world_size)]
