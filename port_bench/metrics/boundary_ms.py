"""boundary_ms: the device milliseconds between two blocks' replays, the
mean over the window call's blocks of the `boundary_ms` attr of the
program's `loop.block` spans (train_gnn._k_loop: CUDA events from the
previous block's last replay to the block's first), from the recorder of
the run's process (elliptic_gnn_tpu_torch/utils/trace.py). The window call
is the last call of the loop (the largest `call`); the boundaries the
profiler was on for, those of blocks harness.TRACE_FROM_BLOCK to
TRACE_FROM_BLOCK + TRACE_BLOCKS (its start and its stop sit in the tails
before the first and after the last traced block), are left out. None
where the program has no recorder or no such block. Moves epoch_ms."""


def read(ctx):
    try:
        from elliptic_gnn_tpu_torch.utils import trace
    except ImportError:
        return None
    from port_bench.harness import TRACE_BLOCKS, TRACE_FROM_BLOCK

    blocks = trace.spans("loop.block")
    if not blocks:
        return None
    call = max(b.attrs.get("call", 0) for b in blocks)
    ms = [b.attrs["boundary_ms"] for b in blocks
          if b.attrs.get("call") == call and "boundary_ms" in b.attrs
          and not TRACE_FROM_BLOCK <= b.attrs["block"] <= TRACE_FROM_BLOCK + TRACE_BLOCKS]
    return sum(ms) / len(ms) if ms else None
