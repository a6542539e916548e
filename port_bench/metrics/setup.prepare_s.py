"""setup.prepare_s: seconds of the program's own span `setup.prepare`
around train_gnn.prepare_data (the temporal re-mask, the time scalar, the
symmetrized edges), the run's last, from the recorder of the run's process
(elliptic_gnn_tpu_torch/utils/trace.py); None where the program has no
recorder, the run is not on the card (its times come from the card's
runs alone) or the span never ran. Moves setup_s."""


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
    span = trace.last("setup.prepare")
    return None if span is None else span.seconds
