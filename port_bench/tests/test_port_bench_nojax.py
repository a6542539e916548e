"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names; the reference loads nothing of the program."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _loaded(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True, env={**os.environ, "USE_FLAX": "0"})
    return out.stdout.split()


def test_top_level_names_taken_whole(monkeypatch):
    sys.path.insert(0, ROOT)
    from port_bench import harness

    for name, hit in (("elliptic_gnn_tpu_torch.train.train_gnn", False),
                      ("elliptic_gnn_tpu.train", True), ("jax.numpy", True),
                      ("jaxlib", True), ("flax.linen", True), ("optax", True),
                      ("jaxtyping", False)):
        monkeypatch.setitem(sys.modules, name, object())
        assert (name in harness.forbidden_modules()) is hit, name
        monkeypatch.delitem(sys.modules, name)


def test_harness_and_program_load_no_jax():
    loaded = _loaded(
        "import sys; sys.path.insert(0, '.');"
        "from port_bench import harness, calibrate;"
        "from elliptic_gnn_tpu_torch.train import train_gnn;"
        "from elliptic_gnn_tpu_torch.graph import GraphData;"
        "import elliptic_gnn_tpu_torch.kernels.packed_gat;"
        "print(' '.join(harness.forbidden_modules()))")
    assert loaded == []


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded(
        "import sys; sys.path.insert(0, '.');"
        "import port_bench.reference.follow, port_bench.reference.sage_resbn, port_bench.reference.gat;"
        "print(' '.join(m for m in sys.modules if m.split('.')[0] in "
        "('elliptic_gnn_tpu_torch', 'elliptic_gnn_tpu', 'jax')))")
    assert loaded == []
