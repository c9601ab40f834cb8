"""Run one function on several local ranks of a process group.

``run_ranks(fn, world, args, backend=..., store_dir=...)`` spawns ``world``
processes (start method ``spawn``), each joins a process group of the given
backend through a ``file://`` store in ``store_dir`` and calls
``fn(rank, world, *args)``; the parent returns the results in rank order.
It is how the tests run the sharded simulators on the CPU (gloo) and how
``chip_smoke.py`` runs four ranks on one card (gloo: NCCL refuses two ranks
on one device). ``fn`` must be importable by name in a fresh interpreter
(a module-level function), and neither it nor its module may start work on
import.

A rank that raises reports its traceback and the parent raises at once,
killing every rank, since the others may be blocked in a collective; so
does a rank that dies without a report, and a run past ``timeout``
seconds. Every rank's group gets ``group_timeout`` seconds for a
collective.
"""

from __future__ import annotations

import datetime
import os
import queue
import time
import traceback
import uuid
from typing import Any, Callable, Sequence


def _rank_main(fn, rank, world, args, backend, store, group_timeout, results) -> None:
    import torch.distributed as dist

    try:
        dist.init_process_group(
            backend, init_method=f"file://{store}", rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=group_timeout),
        )
        out = fn(rank, world, *args)
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(
    fn: Callable,
    world: int,
    args: Sequence[Any] = (),
    *,
    backend: str,
    store_dir: str,
    timeout: float = 120.0,
    group_timeout: float = 60.0,
) -> list[Any]:
    """``fn(rank, world, *args)`` on ``world`` spawned ranks; their results
    (picklable) in rank order. Raises RuntimeError naming the first rank
    that failed, or TimeoutError past ``timeout`` seconds."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store = os.path.join(store_dir, f"store-{uuid.uuid4().hex}")
    procs = [
        ctx.Process(
            target=_rank_main,
            args=(fn, r, world, tuple(args), backend, store, group_timeout, results),
            daemon=True,
        )
        for r in range(world)
    ]
    for p in procs:
        p.start()
    out: dict[int, Any] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world:
            try:
                rank, ok, value = results.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} exited with code {procs[dead[0]].exitcode} "
                        "before reporting"
                    ) from None
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"ranks {sorted(set(range(world)) - set(out))} did not finish "
                        f"within {timeout:.0f} s"
                    ) from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5.0)
        results.close()
        if os.path.exists(store):
            os.remove(store)
    return [out[r] for r in range(world)]
