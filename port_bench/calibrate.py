"""The readings that the check's limits are set from (limits/<cell>.json),
taken at the cell's own size, without a measured window:

    python3 port_bench/calibrate.py --workload rec_k8.full \
        --seeds 11,12,13 --control-seeds 21,22,23

For each of --seeds, the program's first steps against the reference (the
lower readings); for each of --control-seeds, each of the configuration's
controls (the reference one precision step below what the configuration
states: its file's "controls") and the fault of half the batch left out
(the reference over every other train row), each against the reference.
One JSON line per reading on standard output, with delta_gap_masked also
at other thresholds than the check's, for the record. A state left
unchanged reads 1 in delta_gap by construction and needs no run.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["USE_FLAX"] = "0"
# one process with few threads: the host's work here is launching graphs
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path.insert(0, ROOT)


FRACS = (0.001, 0.003, 0.03, 0.1)  # delta_gap_masked at other thresholds


def leaves(prog: dict, ref: dict) -> dict:
    """Each parameter's (program, reference) norms of its first gradient and
    of its change, and the steps' losses, for a look at what sets a gap."""
    norm = lambda t: float(t.norm())  # noqa: E731
    return {"grad": {k: [prog["grad"][k], v] for k, v in ref["grad"].items()},
            "delta": {k: [norm(prog["delta"][k]), norm(v)] for k, v in ref["delta"].items()},
            "loss": [prog["loss"], ref["loss"]]}


def readings(prog: dict, ref: dict) -> dict:
    from port_bench.reference.follow import compare

    gaps = compare(prog, ref)
    for f in FRACS:
        gaps[f"delta_gap_masked@{f}"] = compare(prog, ref, mask_frac=f)["delta_gap_masked"]
    return gaps


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nodes", type=int, default=0, help="a smaller graph (tests)")
    args = ap.parse_args()
    from port_bench import harness
    from port_bench.reference.follow import as_program

    over = {"num_nodes": args.nodes} if args.nodes else None
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    for seed in seeds:
        t0 = time.time()
        run = harness.Setup(args.workload, seed, args.device, graph_overrides=over)
        observed = run.first_steps()
        run.free_program()
        ref = run.reference()
        print(json.dumps({"reading": "program", "workload": args.workload, "seed": seed,
                          "gaps": readings(observed, ref), "seconds": time.time() - t0,
                          "leaves": leaves(observed, ref)}), flush=True)
    for seed in controls:
        run = harness.Setup(args.workload, seed, args.device, graph_overrides=over, program=False)
        ref = run.reference()
        variants = [("control:" + "+".join(sorted(c)), {"control": c})
                    for c in run.conf["controls"]]
        variants.append(("fault_half_batch", {"half_batch": True}))
        for reading, kw in variants:
            other = as_program(run.reference(**kw))
            print(json.dumps({"reading": reading, "workload": args.workload, "seed": seed,
                              "gaps": readings(other, ref), "leaves": leaves(other, ref)}),
                  flush=True)
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
