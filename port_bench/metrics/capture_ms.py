"""capture_ms: milliseconds of the program's last `loop.capture` span, the
window call's (train_gnn._first_epoch_and_capture: the K loop's eager first
epoch and the CUDA-graph capture, which every call of the loop pays once),
from the recorder of the run's process
(elliptic_gnn_tpu_torch/utils/trace.py); None where the program has no
recorder or never captured. Moves epoch_ms."""


def read(ctx):
    try:
        from elliptic_gnn_tpu_torch.utils import trace
    except ImportError:
        return None
    span = trace.last("loop.capture")
    return None if span is None else 1e3 * span.seconds
