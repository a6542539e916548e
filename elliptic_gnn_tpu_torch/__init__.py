"""elliptic_gnn_tpu_torch — the PyTorch/CUDA port of elliptic_gnn_tpu.

A second package beside the JAX one, with the same subpackage and module
names so each counterpart is easy to find:

    kernels/   BSDA block-sparse aggregation: numpy table builder, plain
               PyTorch SpMM, and the hand-written CUDA kernel (csrc/)
    graph/     graph container, temporal masks, transforms, synthetic build
    models/    SAGE-ResBN family as nn.Modules, losses, JAX weight import
    train/     full-batch trainer and temperature calibration
    utils/     metrics (numpy), logging, filesystem helpers

It imports torch and numpy only: never jax, optax or elliptic_gnn_tpu.
Entry points run on CUDA unless the config asks for `device: cpu`.
"""

__version__ = "0.1.0"
