"""torch.exp's run-to-run spread in PyTorch's CPU build (seen with
2.13.0+cpu, MKL, AVX-512), in torch alone: a chunk-gather
einsum with its backward (the plain BSDA aggregation's pattern), then
torch.exp three times on one tensor of softmax arguments (the GAT
attention's pattern, [6, 3, 128, 128] at 2 intra-op threads).

In some processes the first exp after such work differs from the later
ones in the second thread's half of the tensor, by ~1e-4 on values in
(0, 1]; the later calls agree with the float64 exp to ~1e-7 relative. The
multi-rank GAT comparison (tests/torch_port_ranks.py::job_gat) sizes the
tolerance of its first call from this, and
tests/test_torch_port_multihost.py::test_torch_exp_spread_within_its_tolerance
holds every call to EXP_RTOL.

    python tests/torch_exp_spread.py [seed]

prints one JSON object: `calls`, the largest relative error of each of the
three calls against the float64 exp (over entries whose exp is at least
1e-6), and `first_differs`, whether the first call differs from the
third."""
import json
import sys

import torch

SHAPE = (6, 3, 128, 128)
# the relative error that every call is held to (the first calls that
# differ measured up to 1.49e-4 over 48 processes, 6 at a time on an
# 8-core AVX-512 host)
EXP_RTOL = 2e-4


def measure(seed: int) -> dict:
    torch.set_num_threads(2)
    g = torch.Generator().manual_seed(seed)
    a = ((torch.rand(SHAPE, generator=g) < 0.02)
         * torch.randint(1, 4, SHAPE, generator=g)).to(torch.int8)
    src = torch.randint(0, 10, SHAPE[:2], generator=g, dtype=torch.int32)
    rows = torch.randint(0, 768, (200,), generator=g)
    for _ in range(3):
        x = torch.randn(1280, 16, generator=g, requires_grad=True)
        y = torch.einsum("bdij,bdjf->bif", a.float(),
                         x.reshape(10, 128, 16)[src.long()])
        y = y.reshape(768, 16).index_add(0, rows, x[rows] * 0.5)
        y.sum().backward()
    valid = torch.rand(SHAPE, generator=g) < 0.02
    sc = torch.where(valid, torch.randn(SHAPE, generator=g), torch.tensor(-1e30))
    t = sc - sc.amax(dim=(1, 3))[:, None, :, None]
    calls = [torch.exp(t) for _ in range(3)]
    ref = torch.exp(t.double())
    keep = ref >= 1e-6
    rel = [float(((e.double() - ref).abs()[keep] / ref[keep]).max()) for e in calls]
    return {"calls": rel, "first_differs": bool((calls[0] != calls[2]).any())}


if __name__ == "__main__":
    print(json.dumps(measure(int(sys.argv[1]) if len(sys.argv) > 1 else 0)))
