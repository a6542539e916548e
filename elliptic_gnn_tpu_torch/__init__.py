"""elliptic_gnn_tpu_torch — the PyTorch/CUDA port of elliptic_gnn_tpu.

A second package beside the JAX one, with the same subpackage and module
names so each counterpart is easy to find:

    kernels/   BSDA block-sparse aggregation and GAT attention: the tables
               (built with numpy), plain PyTorch versions, the packed GAT
               pipeline, and the hand-written CUDA kernels (csrc/) with
               their bindings
    graph/     graph container, temporal masks, transforms, synthetic build
    models/    SAGE-ResBN family and GAT as nn.Modules, losses, JAX weight
               import
    train/     full-batch trainer, temperature calibration, best-model
               checkpoint, batch scoring (predict)
    analysis/  run-dir loading, the model-reload pattern, epoch times
    parallel/  multi-device training over torch.distributed: the mesh of
               ranks, process-group set-up and primary-rank IO, row
               sharding, and the explicit halo path (partitioned BSDA
               tables, the ring exchange, each shard's aggregation)
    utils/     metrics (numpy), logging, filesystem helpers

It imports torch and numpy only: never jax, optax or elliptic_gnn_tpu.
Entry points run on CUDA unless the config asks for `device: cpu`.
"""

__version__ = "0.1.0"
