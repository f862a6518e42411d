"""Run one function on every rank of a mesh in freshly spawned processes.

``spawn(fn, n, ...)`` starts ``n`` processes (``multiprocessing``'s spawn
method), joins them in one process group through a file store in a temporary
directory (no TCP port to pick, so concurrent runs never clash), builds the
mesh and returns ``fn(mesh, *args)`` of every rank, in rank order. It is how
``entry.dryrun_multichip`` runs its ranks on one host, and how a single-card
check runs two ranks on one card (gloo, named by the caller). A rank that
raises, dies or outlasts ``timeout`` fails the whole call; every process is
stopped before it returns.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue as queue_module
import tempfile
import traceback
from typing import Callable, Optional

from eda_tpu_torch.parallel import mesh as mesh_module

JOIN_SECONDS = 10.0
THREADS = 1  # intra-op threads a rank: ranks share the host's cores


def _rank_main(rank, world_size, init_method, backend, device, model, timeout_s, fn, args,
               results):
    try:
        import torch
        import torch.distributed as dist

        from eda_tpu_torch.entry import resolve_device

        torch.set_num_threads(THREADS)
        dev = resolve_device(device)
        if dev.type == "cuda":
            if dev.index is None:  # one card a rank
                dev = torch.device("cuda", rank)
            torch.cuda.set_device(dev)
        timeout = datetime.timedelta(seconds=timeout_s)
        mesh_module.init_process_group(rank, world_size, init_method, backend, dev, timeout)
        try:
            mesh = mesh_module.make_mesh(model=model, device=dev, timeout=timeout)
            results.put((rank, True, fn(mesh, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn: Callable, world_size: int, *args, model: int = 1, device: str = "cpu",
          backend: Optional[str] = None, timeout: float = 300.0) -> list:
    """``[fn(mesh, *args) for each rank]``, run in ``world_size`` spawned processes.

    ``fn`` must be importable by name (a module-level function); its arguments
    and results are pickled. ``device`` is ``"cpu"``, ``"cuda"`` (rank r on
    card r) or one card that every rank shares, which only gloo allows;
    ``backend`` defaults to NCCL for CUDA and gloo for the CPU; ``model`` is
    the mesh's tensor-parallel size; each rank uses one intra-op thread.
    ``timeout`` bounds every collective and the whole call.
    """
    import torch

    dev = torch.device(device)
    backend = backend or mesh_module.default_backend(dev)
    if dev.type == "cuda" and dev.index is None and torch.cuda.device_count() < world_size:
        raise RuntimeError(f"{world_size} ranks take one card each, "
                           f"{torch.cuda.device_count()} present")
    if backend == "nccl" and dev.index is not None and world_size > 1:
        raise RuntimeError(f"NCCL takes one card a rank: {world_size} ranks cannot share {dev}; "
                           "pass device='cuda', or name backend='gloo'")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(rank, world_size, init, backend, device, model, timeout,
                                   fn, args, results))
                 for rank in range(world_size)]
        for p in procs:
            p.start()
        out, failures = {}, []
        try:
            while len(out) + len(failures) < world_size:
                try:
                    rank, ok, value = results.get(timeout=timeout)
                except queue_module.Empty:
                    raise TimeoutError(f"spawn: no result from {world_size - len(out)} rank(s) "
                                       f"within {timeout:.0f} s") from None
                if ok:
                    out[rank] = value
                else:
                    failures.append(f"rank {rank}:\n{value}")
                    break
        finally:
            for p in procs:
                p.join(JOIN_SECONDS if not failures else 0.5)
                if p.is_alive():
                    p.kill()
                    p.join()
    if failures:
        raise RuntimeError("spawn: a rank failed\n" + "\n".join(failures))
    dead = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if dead:
        raise RuntimeError(f"spawn: rank(s) {dead} exited with "
                           f"{[procs[r].exitcode for r in dead]}")
    return [out[r] for r in range(world_size)]
