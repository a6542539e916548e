"""Run one cell of the port's benchmark once and print its result as the
last line of standard output:

    python3 port_bench/run.py --workload rec_k8.full --seed 7 --seconds 20 --trace 0

from the root of a checkout that holds the program (elliptic_gnn_tpu_torch).
--trace 0 reports the cell's end-to-end metrics, --trace 1 its per-layer
metrics from a torch.profiler trace of a stretch of the window. The run
needs as many CUDA devices as the cell asks for, and exits with a code
other than 0, printing no result, without them.
"""
import time

START = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# fixed cache directories inside the checkout: only a cell's first run in
# a checkout builds; no library loads JAX (transformers' switch)
os.environ["USE_FLAX"] = "0"
# one process with few threads: the host's work here is launching graphs
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(ROOT, "elliptic_gnn_tpu_torch")):
        print("the program (elliptic_gnn_tpu_torch) is not in this checkout", file=sys.stderr)
        return 2
    from port_bench import harness

    return harness.main(args, START)


if __name__ == "__main__":
    sys.exit(main())
