"""The process-group runtime: bring-up, the global mesh, per-rank feeding.

Port of ``paddle_lite_tpu/parallel/distributed.py``, where one process
drives every device of its host through ``jax.distributed``.  Here one
process drives one device (a rank of ``torch.distributed``), so:

- :func:`initialize` is an idempotent ``init_process_group``, driven by
  the environment (``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` /
  ``RANK``) or by explicit arguments, and a no-op without either: one
  process, no group, as the reference's is on a single host.  Every group
  is made with an explicit ``timeout``, so a rendezvous that hangs fails.
  The reference reads ``process_id or env`` (``distributed.py:46``), which
  takes rank 0 from the environment; here an explicit 0 is rank 0.
- :func:`global_mesh` builds the (data, model) mesh over every rank, with
  the model axis inside one host (``distributed.py:63-67``: it raises
  where ``tp`` exceeds the ranks on one host).
- :func:`host_local_batch` puts each rank's local rows on its device; the
  rows stay local, as each rank runs its own data shard.
- :func:`spawn` starts one process a rank on this host (gloo on the CPU,
  or one rank a card), runs a function in each after :func:`initialize`,
  and joins them with a deadline: a rank that fails or hangs fails the
  call, with the rank's traceback.

Fault model, as the reference's: fail fast.  A dead rank fails the
collective; nothing retries it.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core.device import to_tensor

DEFAULT_TIMEOUT_S = 120.0


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, *, backend: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Idempotent ``torch.distributed.init_process_group``.  Without
    `init_method`, ``tcp://$MASTER_ADDR:$MASTER_PORT`` with ``$WORLD_SIZE``
    and ``$RANK``; without ``MASTER_ADDR`` either it does nothing (one
    process).  `backend` defaults to NCCL where a card is present, else
    gloo.  Returns whether a process group is up."""
    if dist.is_initialized():
        return True
    if init_method is None:
        addr = os.environ.get("MASTER_ADDR")
        if addr is None:
            return False
        init_method = f"tcp://{addr}:{os.environ.get('MASTER_PORT', '29500')}"
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else int(world_size)
    rank = int(os.environ["RANK"]) if rank is None else int(rank)
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    # NCCL is told its rank's card (rank r of a host on cuda:r), not left to guess
    device_id = (torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank))
                              % torch.cuda.device_count()) if backend == "nccl" else None)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s),
                            device_id=device_id)
    return True


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_world_size() -> int:
    """Ranks on this host: ``$LOCAL_WORLD_SIZE`` where the launcher sets it,
    else every rank (one host)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", world_size()))


def is_primary() -> bool:
    return rank() == 0


def global_mesh(tp: int = 1, *, devices=None, backend: Optional[str] = None):
    """The (data, model) mesh over every rank: ``world / tp`` data rows of
    ``tp`` model ranks, the model axis inside one host so its gathers stay
    on the host's links (NVLink).  Raises where the ranks do not divide by
    `tp` or `tp` exceeds the ranks on one host."""
    from .sharding import MeshConfig

    n = world_size()
    if tp < 1 or n % tp:
        raise ValueError(f"{n} devices not divisible by tp={tp}")
    local = local_world_size()
    if tp > local:
        raise ValueError(f"tp={tp} exceeds local device count {local}: TP collectives "
                         f"must stay on one host's links")
    return MeshConfig(data=n // tp, model=tp).build(devices, backend=backend)


def host_local_batch(mesh, inputs: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Each rank's LOCAL rows of the global batch (global batch / data
    ranks of them), placed on the rank's device."""
    return {name: to_tensor(np.asarray(x), mesh.device) for name, x in inputs.items()}


# ---- one process a rank ------------------------------------------------------

def _entry(rank_: int, world: int, init_method: str, backend: str, timeout_s: float,
           threads: Optional[int], fn: Callable, args: tuple, results) -> None:
    try:
        if threads:
            torch.set_num_threads(threads)
        initialize(init_method, world, rank_, backend=backend, timeout_s=timeout_s)
        try:
            results.put((rank_, True, fn(*args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises
        results.put((rank_, False, traceback.format_exc()))
        raise


def spawn(fn: Callable, world: int, args: Sequence[Any] = (), *, backend: str = "gloo",
          timeout_s: float = DEFAULT_TIMEOUT_S, threads: Optional[int] = None) -> List[Any]:
    """Run ``fn(*args)`` in `world` new processes, one a rank of a
    `backend` group (rendezvous through a file in a new temporary
    directory; `threads` intra-op threads a rank where given), and return
    their results by rank.  `fn` is a module-level function (the
    processes start fresh and import it).  Every process is joined within
    `timeout_s` of the start: a rank that raises, dies or outlives the
    deadline stops the others and raises here, with the failing rank's
    traceback."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="plt_rdzv_")
    init_method = f"file://{os.path.join(tmp, 'rdzv')}"
    results = ctx.Queue()
    procs = [ctx.Process(target=_entry, args=(r, world, init_method, backend, timeout_s,
                                              threads, fn, tuple(args), results),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    got: Dict[int, Any] = {}
    error, grace = None, None
    try:
        while len(got) < world and error is None:
            try:
                r, ok, value = results.get(timeout=0.2)
            except queue_mod.Empty:
                dead = [i for i, p in enumerate(procs) if p.exitcode not in (None, 0)
                        and i not in got]
                if dead:  # its traceback may still be in the queue: a moment to read it
                    grace = grace or time.monotonic() + 2.0
                    if time.monotonic() > grace:
                        error = f"rank {dead[0]} exited with code {procs[dead[0]].exitcode}"
                elif time.monotonic() > deadline:
                    error = (f"ranks {sorted(set(range(world)) - set(got))} did not finish "
                             f"within {timeout_s:g} s")
                continue
            if ok:
                got[r] = value
            else:
                error = f"rank {r} failed:\n{value}"
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()) if error is None else 1.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    if error is not None:
        raise RuntimeError(f"spawn({getattr(fn, '__name__', fn)}, {world}): {error}")
    stuck = [i for i, p in enumerate(procs) if p.exitcode != 0]
    if stuck:
        raise RuntimeError(f"spawn: ranks {stuck} returned a result but exited with "
                           f"codes {[procs[i].exitcode for i in stuck]}")
    return [got[r] for r in range(world)]
