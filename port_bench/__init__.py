"""The benchmark of the PyTorch and CUDA port (elliptic_gnn_tpu_torch): run
one cell with `python3 port_bench/run.py --workload <name> --seed <n>
--seconds <s> --trace <0|1>` from the repository's root."""
