"""Process-pool worker for parallel sweeps (port of
elliptic_gnn_tpu/sweeps/_worker.py; sweeps/sweep_gnn.py --workers N).

Import-light: under the "spawn" start method the child unpickles
``init_worker``/``run_one`` by importing this module, which touches no
device. ``init_worker`` sets the worker's environment (e.g.
CUDA_VISIBLE_DEVICES) before ``run_one`` imports the trainer and the first
CUDA call makes the worker's context.

The JAX package's workers default to its CPU backend, to keep them off a
single-process TPU. These run on each combo's `device`, the card by
default: several workers share one card unless the environment pins each
to its own.
"""
from __future__ import annotations

import multiprocessing
import os
import time


def init_worker(env_fmt: dict) -> None:
    """Pool initializer: set this worker's environment. Values may contain
    ``{slot}``, replaced with the worker's 0-based index (stable for the
    pool's lifetime), e.g. ``CUDA_VISIBLE_DEVICES={slot}`` for one card per
    worker on a host with several."""
    ident = multiprocessing.current_process()._identity
    slot = (ident[0] - 1) if ident else 0
    for k, v in env_fmt.items():
        os.environ[k] = str(v).format(slot=slot)


def run_one(cfg: dict):
    """Train one combo in this worker; returns (error_or_None, dt_seconds).
    Metrics land on disk through the trainer's artifact contract, and the
    parent reads them as the sequential sweep does."""
    t0 = time.time()
    try:
        from ..train.train_gnn import main as train_main

        train_main(cfg)
        err = None
    except Exception as e:  # keep sweeping past failed combos
        err = f"{type(e).__name__}: {e}"
    return err, round(time.time() - t0, 2)
