"""Both packages' native libraries in one state, for the parity tests that
compare per-node outputs of the two trainers.

The Python BFS of `bfs_order` (kernels/bsda.py, either package) orders a
component's interior differently from the native one, and the ranks decide
the order of every `*_val.npy`/`*_test.npy` artifact. The JAX package's
loader caches a failed load for good: in a parallel run, a worker that
loads while another worker's `make` still writes native/libegnn_native.so
stays on the Python BFS, while the port's loader builds a whole copy of its
own and goes native. `same_native()` retries the JAX load once the library
is whole, and fails if the two still differ."""
from elliptic_gnn_tpu import native as jax_native
from elliptic_gnn_tpu_torch import native as port_native


def same_native() -> None:
    if port_native.is_available() and not jax_native.is_available():
        jax_native._lib, jax_native._tried = None, False
    assert jax_native.is_available() == port_native.is_available(), (
        "the JAX and the port native libraries are not both loaded")
