"""evolve_launches: the launches of the weight-evolution kernels in one
captured epoch, the sum of the `egcn_*` attrs of the program's last
`loop.capture` span (train_gnn._capture: the launches each counter saw
while the epoch was captured; every replay launches them again), from the
recorder of the run's process (elliptic_gnn_tpu_torch/utils/trace.py).
None where the program has no recorder, never captured, or captured no
such launch. Moves epoch_ms."""


def read(ctx):
    try:
        from elliptic_gnn_tpu_torch.utils import trace
    except ImportError:
        return None
    span = trace.last("loop.capture")
    if span is None:
        return None
    n = sum(v for k, v in span.attrs.items() if k.startswith("egcn_"))
    return n if n > 0 else None
