"""Plain PyTorch and NumPy references of the benchmark's configurations.
They import nothing of the program (elliptic_gnn_tpu_torch) and nothing of
the JAX package."""
