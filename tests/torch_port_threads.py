"""One thread for the CPU thread pools of a port test module: torch's
intra-op pool, and the BLAS and OpenMP pools that numpy, scipy and sklearn
run on (threadpoolctl). The test workers share the host's cores
(pytest-xdist, several workers); at a core's worth of threads each, the
port's many small torch ops and sklearn's fits oversubscribe the cores and
spin in their pools, and a module of them ran several times slower beside
the other workers than at one thread. Import `one_thread` into a test
module: an autouse fixture of the module's scope, which restores the
worker's settings after the module. JAX keeps its own pool."""
import pytest
import torch
from threadpoolctl import threadpool_limits


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield
    torch.set_num_threads(threads)
