"""The process group of the sharded search (the counterpart of the JAX
package's `make_mesh`, `parallel/sharded.py:148-165`).

The JAX engine is one controller over a mesh of devices; the port is SPMD:
one process per rank, one device per rank, over `torch.distributed`. A CUDA
rank talks NCCL and a CPU rank gloo (`backend_for`).

- `init_world()` joins the group that `torchrun` describes in the
  environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT):

      torchrun --nproc-per-node 4 my_check.py   # each rank: init_world(), then
                                                # ShardedSearch(model).run()

- `run_world(fn, world_size, *args)` spawns `world_size` ranks on this host,
  runs `fn(*args)` in each inside a fresh group, and returns each rank's
  return value. The ranks rendezvous through a `FileStore` in a temporary
  directory, never a TCP port, so that concurrent worlds (test workers) do
  not collide. `fn`, `args` and the results travel by pickle: `fn` must be a
  module-level function, and a model travels as a picklable factory, built
  inside the rank, whose module imports only this package.
"""

from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

#: The collective backend of each device type.
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def backend_for(device) -> str:
    """The collective backend a rank on `device` needs: NCCL for CUDA, gloo
    for the CPU."""
    dev = torch.device(device)
    if dev.type not in BACKENDS:
        raise ValueError(f"no collective backend for device type {dev.type!r}")
    return BACKENDS[dev.type]


def _need_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' but torch.cuda.is_available() is False; pass "
            "device='cpu' to run the ranks on the CPU over gloo"
        )


def init_world(device=None) -> torch.device:
    """Join the process group that `torchrun` set up in the environment, on
    `device` (default `cuda:{LOCAL_RANK}`, made the current CUDA device).
    Returns the rank's device. With no CUDA device the default raises; pass
    device="cpu" for a gloo group."""
    local = int(os.environ.get("LOCAL_RANK", 0))
    dev = torch.device(f"cuda:{local}" if device is None else device)
    backend = backend_for(dev)
    if dev.type == "cuda":
        _need_cuda()
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://")
    return dev


def _rank_main(rank, world_size, device_type, store_path, fn, args, results) -> None:
    """One rank of `run_world`: join the group, run fn, report."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world_size))
    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank)
        else:
            # Every rank of a CPU world shares the host's cores.
            torch.set_num_threads(1)
        dist.init_process_group(
            BACKENDS[device_type], store=dist.FileStore(store_path, world_size),
            rank=rank, world_size=world_size,
        )
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except Exception:
        results.put((rank, False, traceback.format_exc()))


def run_world(fn, world_size: int, *args, device="cuda", timeout: float = 600.0) -> list:
    """Run `fn(*args)` on `world_size` ranks of a fresh process group on this
    host (one spawned process per rank; rank r on `cuda:r`, or on the CPU
    with device="cpu", over gloo) and return the ranks' return values in
    rank order.

    A CUDA world needs CUDA and a card per rank: with none the call raises
    RuntimeError, with too few ValueError. If a rank raises, dies or the
    world outlives `timeout` seconds, every rank's process is killed and the
    call raises RuntimeError with the failing rank's traceback."""
    dev = torch.device(device)
    backend_for(dev)
    if dev.type == "cuda":
        _need_cuda()
        if world_size > torch.cuda.device_count():
            raise ValueError(
                f"requested {world_size} ranks but only "
                f"{torch.cuda.device_count()} CUDA devices are visible (a CUDA "
                "world takes one card per rank)"
            )
    if world_size < 1:
        raise ValueError("world_size must be at least 1")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    out: dict = {}
    with tempfile.TemporaryDirectory(prefix="srt-world-") as tmp:
        procs = [
            ctx.Process(
                target=_rank_main,
                args=(r, world_size, dev.type, os.path.join(tmp, "store"), fn, args, results),
                daemon=True,
            )
            for r in range(world_size)
        ]
        for p in procs:
            p.start()
        try:
            deadline = time.monotonic() + timeout
            while len(out) < world_size:
                try:
                    rank, ok, value = results.get(timeout=0.2)
                except queue.Empty:
                    dead = [(i, p.exitcode) for i, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and i not in out]
                    if dead:
                        raise RuntimeError(f"rank {dead[0][0]} died with exit code "
                                           f"{dead[0][1]} before it reported") from None
                    if time.monotonic() > deadline:
                        raise RuntimeError(
                            f"the world of {world_size} ranks did not finish in "
                            f"{timeout} s; its processes were killed") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                out[rank] = value
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
    return [out[r] for r in range(world_size)]
