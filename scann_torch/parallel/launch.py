"""Process groups and device meshes for the sharded index.

``init_mesh`` joins this process to a ``torch.distributed`` group through
a ``FileStore`` (several processes of one host, or one with a shared
filesystem) or a ``HashStore`` (one process), never through TCP, and
returns a ``DeviceMesh`` with dims ("data", "shard"): rank
``r = data * n_shards + shard``.  A "cuda" mesh, the default, runs NCCL
with rank ``r`` on ``cuda:{r % device_count}``; a "cpu" mesh runs gloo.
``spawn`` runs one function on every rank of a new mesh in fresh
processes and returns each rank's result; a rank that raises stops them
all.
"""

from __future__ import annotations

import os
import queue
import tempfile
import traceback

import torch
import torch.distributed as dist

MESH_DIMS = ("data", "shard")


def init_mesh(n_data: int, n_shards: int, *, rank: int = 0, store=None,
              device_type: str = "cuda"):
    """Join the group and return the (n_data, n_shards) DeviceMesh.

    ``store``: a ``torch.distributed`` store that every rank shares (a
    ``FileStore``); for one process it may be left out, and a
    ``HashStore`` serves.  The mesh is on the card unless
    ``device_type="cpu"``."""
    from torch.distributed.device_mesh import init_device_mesh
    world = n_data * n_shards
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a cuda mesh needs a CUDA device; pass "
                               "device_type='cpu' to run on the CPU")
        torch.cuda.set_device(rank % torch.cuda.device_count())
        backend = "nccl"
    elif device_type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unsupported mesh device type {device_type!r}")
    if store is None:
        if world != 1:
            raise ValueError("a mesh of several ranks needs a store")
        store = dist.HashStore()
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world)
    return init_device_mesh(device_type, (n_data, n_shards),
                            mesh_dim_names=MESH_DIMS)


def close():
    """Leave the group (a no-op when none is open)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(rank, n_data, n_shards, store_path, device_type, threads,
               fn, args, results):
    try:
        torch.set_num_threads(threads)
        store = dist.FileStore(store_path, n_data * n_shards)
        mesh = init_mesh(n_data, n_shards, rank=rank, store=store,
                         device_type=device_type)
        out = fn(mesh, *args)
        results.put(("ok", rank, out))
    except BaseException:  # noqa: BLE001 - reported to the parent
        results.put(("error", rank, traceback.format_exc()))
    finally:
        try:
            close()
        except Exception:  # noqa: BLE001 - the group may be broken
            pass


def spawn(fn, n_data: int, n_shards: int, *args, device_type: str = "cuda",
          threads: int = 1, timeout: float = 600.0):
    """Run ``fn(mesh, *args)`` on every rank of a new (n_data, n_shards)
    mesh (on the cards unless ``device_type="cpu"``), one spawned process
    a rank with ``threads`` torch threads, and
    return the ranks' results in rank order.  ``fn`` and its arguments
    must be picklable (a module-level function).  A rank that raises, or
    a job that outlasts ``timeout`` seconds, ends every process and
    raises RuntimeError with the failing rank's traceback."""
    import torch.multiprocessing as mp
    world = n_data * n_shards
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="scann_torch_mesh_") as tmp:
        store_path = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, n_data, n_shards, store_path,
                                   device_type, threads, fn, args, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        out, error = [None] * world, None
        try:
            for _ in range(world):
                try:
                    status, rank, value = results.get(timeout=timeout)
                except queue.Empty:
                    error = f"the job did not finish within {timeout} s"
                    break
                if status != "ok":
                    error = f"rank {rank} failed:\n{value}"
                    break
                out[rank] = value
        finally:
            for p in procs:
                if error is not None and p.is_alive():
                    p.terminate()
                p.join()
        if error is not None:
            raise RuntimeError(error)
    return out
