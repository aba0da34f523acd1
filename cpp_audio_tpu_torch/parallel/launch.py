"""Run a function on several local ranks: the SPMD launcher for parallel/mesh.

    from cpp_audio_tpu_torch.parallel import launch, mesh
    out = launch.spawn(4, launch.run_calls,
                       [(mesh.render_schedule_sharded, (sch, n, cfg), {"device": "cpu"})],
                       device="cpu")

`spawn` starts `world_size` processes (the "spawn" start method: each one
imports the target afresh, so the target must be a module-level function of
an importable module), joins them in one process group through a file store
(no TCP port, so parallel runs cannot race for one), runs target(*args) on
every rank and returns rank 0's result. A rank that raises fails the call
with its traceback, at once; a call that outlives its deadline terminates
every rank and raises. On several cards, `torchrun --nproc-per-node N`
starts the same ranks and parallel/mesh.default_mesh joins them.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta

import torch

from . import mesh


def to_host(x):
    """Tensors -> numpy arrays, through tuples, lists and dicts."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    if isinstance(x, (tuple, list)):
        return type(x)(to_host(v) for v in x)
    if isinstance(x, dict):
        return {k: to_host(v) for k, v in x.items()}
    return x


def run_calls(calls):
    """Each (function, args, kwargs) of `calls` in order; the results as
    host values (to_host)."""
    return [to_host(fn(*args, **kwargs)) for fn, args, kwargs in calls]


def chain_outputs(n_samples: int, rconfig, vparams, bank, carrier, *,
                  block_size: int, shape=None, device="cuda"):
    """One step() of parallel/mesh.make_sharded_chain over every rank
    (shape None) or of make_sharded_chain_2d over a (nv, nf) shape: returns
    (stereo, vocoded, dropped, the step's collective counts)."""
    if shape is None:
        build = mesh.make_sharded_chain(mesh.default_mesh(device=device), n_samples,
                                        rconfig, vparams, block_size=block_size,
                                        device=device)
    else:
        build = mesh.make_sharded_chain_2d(mesh.default_mesh_2d(*shape, device=device),
                                           n_samples, rconfig, vparams,
                                           block_size=block_size, device=device)
    step = build(bank, carrier)
    stereo, voc, dropped = step()
    return stereo, voc, dropped, step.collective_counts()


def _rank_main(rank, world_size, store, backend, device, pg_timeout, target,
               args, results):
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                                world_size=world_size,
                                timeout=timedelta(seconds=pg_timeout))
        try:
            out = target(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out if rank == 0 else None))
    except Exception:  # noqa: BLE001 - the rank's boundary: report, exit non-zero
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def spawn(world_size: int, target, *args, backend: str | None = None,
          device="cuda", timeout: float = 300.0, pg_timeout: float = 60.0,
          store_dir=None):
    """Run target(*args) on `world_size` new local ranks and return rank 0's
    result (pickled back, so return host values: to_host).

    backend: the process group's, by default NCCL for "cuda" and gloo for
    the CPU; rank r works on CUDA device r mod the device count. pg_timeout
    bounds each collective; `timeout` the whole call, after which every rank
    is terminated and TimeoutError raised. The file store lives in a new
    directory under `store_dir` (default: the system's temporary
    directory), removed afterwards.
    """
    backend = backend or mesh._backend(torch.device(device))
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="pg_", dir=store_dir)
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, os.path.join(tmp, "store"), backend,
                               str(device), pg_timeout, target, args, results))
             for r in range(world_size)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        done, out = set(), None
        while len(done) < world_size:
            try:
                rank, ok, value = results.get(timeout=0.2)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in done and p.exitcode not in (None, 0)]
                if dead:  # a report may still be in flight: wait for it briefly
                    try:
                        rank, ok, value = results.get(timeout=5.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"rank {dead[0]} died with exit code "
                            f"{procs[dead[0]].exitcode} and no report") from None
                elif time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks did not finish in {timeout} s")
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            done.add(rank)
            if rank == 0:
                out = value
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
