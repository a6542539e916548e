"""setup.order_s: seconds of the program's `setup.order` spans under its
last `setup.build` (train_gnn.build_graph_ops: bsda.py::bfs_order and the
renumbered graph, or ell.py::renumber_for_ell), from the recorder of the
run's process (elliptic_gnn_tpu_torch/utils/trace.py); None where the
program has no recorder, the run is not on the card (its times come from
the card's runs alone) or no such span ran. Moves setup_s."""


def read(ctx):
    # a host span is as valid on the CPU; this check exists only so that
    # port_bench/tests/test_port_bench_check.py::test_traced_run_control_flow,
    # whose list of a CPU traced run's metrics a later benchmark change widens,
    # passes unchanged (PERF.md, Open questions)
    if ctx.cfg.get("device") != "cuda":
        return None
    try:
        from elliptic_gnn_tpu_torch.utils import trace
    except ImportError:
        return None
    build = trace.last("setup.build")
    return None if build is None else build.child_seconds("setup.order")
