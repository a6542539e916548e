"""Port parity of sampled mini-batch training (train/sampler.py) against the
JAX package's, on the CPU at a few hundred labelled nodes:

  - NeighborSampler: node_ids, nbr, w, scale, n_seed and seed_mask exactly
    equal over three successive batches from one seed, for each kind, at a
    budget that truncates and with seeds of in-degree 0;
  - train_gnn.main with `mini_batch: true` (fanout [5, 5], batch 256)
    against the JAX trainer, the JAX model's init injected, dropout 0, 3
    epochs, for sage_resbn with a time embedding and for gat: loss rtol
    1e-4, sampled val PR-AUC and test metrics atol 2e-3, test scores atol
    2e-3 (test_torch_port_train.py's tolerances);
  - predict on the mini-batch run dir scores the full graph through the ELL
    encoding as the trainer did, within 1e-6.
Both packages' native libraries are pinned to one state
(tests/port_native_pin.py): the sampler's CSR comes from build_csr."""
import os

import numpy as np
import pytest

from elliptic_gnn_tpu.train.sampler import NeighborSampler as JaxSampler
from elliptic_gnn_tpu_torch.train import predict
from elliptic_gnn_tpu_torch.train.sampler import NeighborSampler
from tests.port_native_pin import same_native
from tests.test_torch_port_ell_train import (  # noqa: F401  (fixture)
    ARCHS, assert_runs_match, processed, run_both,
)
from tests.torch_port_threads import one_thread  # noqa: F401  (autouse fixture)


@pytest.fixture(autouse=True, scope="module")
def _same_native():
    same_native()


@pytest.mark.parametrize("kind", ["sage", "gcn", "gat"])
@pytest.mark.parametrize("n,fanout,batch", [(300, [3, 2], 16), (40, [4, 4], 16)])
def test_sampler_batches_match_jax(kind, n, fanout, batch):
    """Three successive batches from one sampler: seeds of in-degree 0
    (nodes below n // 5 have no in-edges), a random batch, and a batch of
    repeated seeds. At (300, [3, 2], 16) the budget (160 nodes) is below the
    graph; at (40, [4, 4], 16) it is the whole graph, and the repeated seeds
    overflow it: the rows past the budget, and their edges, are dropped."""
    rng = np.random.default_rng(5)
    ei = np.stack([rng.integers(0, n, 10 * n), rng.integers(n // 5, n, 10 * n)])
    args = (ei, n, fanout, batch, kind, 11)
    s_j, s_p = JaxSampler(*args), NeighborSampler(*args)
    assert (s_p.n_sub, s_p.width) == (s_j.n_sub, s_j.width)
    perm = rng.permutation(n)
    batches = [np.arange(0, min(batch, n // 5)), perm[:batch],
               np.repeat(perm[: batch // 2], 2)]
    for seeds in batches:
        ids_j, ell_j, n_j, mask_j = s_j.sample_batch(seeds)
        ids_p, ell_p, n_p, mask_p = s_p.sample_batch(seeds)
        assert n_p == n_j == seeds.size
        np.testing.assert_array_equal(ids_p, ids_j)
        np.testing.assert_array_equal(mask_p, mask_j)
        for name in ("nbrs", "weights", "row_scale"):
            (a,), (b,) = getattr(ell_j, name), getattr(ell_p, name)
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
        assert ell_p.widths == ell_j.widths and ell_p.num_nodes == ell_j.num_nodes
    if s_p.n_sub == n:  # the overflowing batch filled every row
        assert ids_p[-1] != 0


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_minibatch_trainer_matches_jax(processed, tmp_path, arch):  # noqa: F811
    m_j, m_p, out_j, out_p = run_both(processed, tmp_path, mini_batch=True,
                                      fanout=[5, 5], batch_size=256, **ARCHS[arch])
    assert_runs_match(m_j, m_p, out_j, out_p)
    assert len(m_p["sample_ms"]) == len(m_p["step_ms"]) == m_p["epochs_run"]
    node_idx, probs, _, _, _ = predict.predict(out_p)
    idx = np.load(os.path.join(out_p, "node_idx_test.npy"))
    np.testing.assert_allclose(probs[idx],
                               np.load(os.path.join(out_p, "scores_test.npy")),
                               atol=1e-6)
