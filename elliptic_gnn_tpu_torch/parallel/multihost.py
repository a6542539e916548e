"""Multi-process training: initialization, primary-rank IO, barriers and
launching the ranks (port of elliptic_gnn_tpu/parallel/multihost.py).

One process per rank, coordinated through torch.distributed. Every rank
loads the same processed graph, builds the same tables and runs the same
loop in lockstep; epoch reports are replicated from rank 0, so every rank
takes the same early-stop decision. Artifact IO (run dir, metrics.json,
npy dumps, checkpoints, logs) belongs to the primary rank (`is_primary`).

Activation, as in the JAX package: EGNN_COORDINATOR (host:port),
EGNN_NUM_PROCESSES and EGNN_PROCESS_ID, or the config keys
`coordinator_address`, `num_processes`, `process_id`; then this process is
one rank. Without them, `train_gnn.main` with `mesh_devices: N > 1` starts
N ranks on this host itself (`spawn_ranks`), and `aggregation: shard_map`
at `mesh_devices: 1` runs in a world of one (`world_of_one`).
"""
from __future__ import annotations

import contextlib
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import backend_for, rank_device

def _init(backend: str, device_type: str, **kwargs) -> None:
    dist.init_process_group(backend, **kwargs)
    if device_type == "cuda":
        torch.cuda.set_device(rank_device(dist.get_rank(), device_type))


def maybe_initialize(cfg: Optional[dict] = None, device_type: str = "cuda") -> bool:
    """Join the process group named by the config keys or EGNN_* variables.

    Returns True when running multi-process (after initialization), False
    for the single-process setup. Idempotent: an initialized group is kept
    (and reported)."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    cfg = cfg or {}
    coord = cfg.get("coordinator_address") or os.environ.get("EGNN_COORDINATOR")
    if not coord:
        return False
    nproc = int(cfg.get("num_processes") or os.environ.get("EGNN_NUM_PROCESSES", "1"))
    pid = int(cfg.get("process_id") or os.environ.get("EGNN_PROCESS_ID", "0"))
    if nproc <= 1:
        return False
    init = coord if "://" in coord else f"tcp://{coord}"
    _init(backend_for(device_type), device_type, init_method=init,
          world_size=nproc, rank=pid)
    return True


@contextlib.contextmanager
def world_of_one(device_type: str):
    """A process group of one rank, this process, for the length of the
    block (an in-memory store: no socket); a group already initialized is
    used as it is and left standing."""
    if dist.is_initialized():
        yield
        return
    _init(backend_for(device_type), device_type, store=dist.HashStore(),
          world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


def is_primary() -> bool:
    """True on the rank that owns artifact IO (rank 0)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def replicate_to_all_hosts(t: torch.Tensor) -> torch.Tensor:
    """Rank 0's copy of `t` on every rank (a broadcast): the epoch report
    goes through this, so every rank reads the same values and takes the
    same early-stop decision."""
    if process_count() == 1:
        return t
    out = t.clone()
    dist.broadcast(out, src=0)
    return out


def barrier(name: str = "egnn") -> None:
    """Synchronization point of every rank (e.g. before rank 0 declares a
    run complete while others may still be writing)."""
    if process_count() == 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def free_port() -> int:
    s = socket.socket()
    try:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
    finally:
        s.close()


def _rank_entry(rank: int, n: int, port: int, threads: int, target, args) -> None:
    os.environ.update(EGNN_COORDINATOR=f"127.0.0.1:{port}",
                      EGNN_NUM_PROCESSES=str(n), EGNN_PROCESS_ID=str(rank))
    if threads:
        torch.set_num_threads(threads)
    try:
        target(*args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(n: int, target, args: tuple, device_type: str) -> None:
    """Run target(*args) in n spawned processes on this host, rank r with
    EGNN_COORDINATOR=127.0.0.1:<free port>, EGNN_NUM_PROCESSES=n and
    EGNN_PROCESS_ID=r; returns when all have ended and raises if one
    failed. CPU ranks share the host's cores evenly."""
    import torch.multiprocessing as mp

    threads = 0 if device_type == "cuda" else max(1, (os.cpu_count() or 1) // n)
    mp.start_processes(_rank_entry, args=(n, free_port(), threads, target, args),
                       nprocs=n, join=True, start_method="spawn")
