"""Start a ``torch.distributed`` world of N processes on one host, for the
tests and the smoke (on cards, ``torchrun --nproc-per-node N`` does this).

Each rank is a fresh ``spawn`` process: it gets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` and ``MASTER_ADDR`` / ``MASTER_PORT`` (a free localhost
port), runs torch's CPU ops on one thread, refuses ``jax``, and calls
``fn(*args)``, which reaches its world through
``parallel/mesh.py:make_mesh``.  ``fn`` is pickled by its import path, so it
lives in a module that imports no JAX (a rank would import it again).
"""
from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue
import sys
import time
import traceback
from typing import Any, Callable, List

from .mesh import free_port


def _rank_main(fn, args, rank, world_size, port, results):
    sys.modules["jax"] = None  # the port never imports it
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        # plain pickle: a queue would pass tensors as shared memory this process frees at exit
        out = pickle.dumps(fn(*args))
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, *args, timeout: float = 300.0) -> List[Any]:
    """Run ``fn(*args)`` on every rank of a new world of ``world_size``
    processes; returns the results in rank order.  A rank that raises, dies
    or outlasts ``timeout`` seconds fails the call (``RuntimeError``), and
    every process is stopped before it returns."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, args, r, world_size, port, results),
                         daemon=True) for r in range(world_size)]
    for p in procs:
        p.start()
    got, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
        while len(got) + len(errors) < world_size:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} of the {world_size}-rank world exited "
                                       f"(codes {[procs[r].exitcode for r in dead]}) without "
                                       "a result") from None
                if time.monotonic() > deadline:
                    raise RuntimeError(f"a rank of the {world_size}-rank world gave no result "
                                       f"within {timeout} s") from None
                continue
            if ok:
                got[rank] = pickle.loads(out)  # written by this world's ranks
            else:
                errors.append(f"rank {rank}:\n{out}")
                break  # the other ranks may wait on the failed one forever
        if errors:
            raise RuntimeError("\n".join(errors))
    finally:
        for p in procs:
            p.join(timeout=5 if not errors else 0.5)
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
    return [got[r] for r in range(world_size)]
