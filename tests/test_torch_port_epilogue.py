"""The SAGE-ResBN hidden-layer epilogue on CPU tensors: SageResBN.epilogue
takes the plain version (BatchNorm, relu, dropout, the residual add as
PyTorch ops), launches no kernel, and gives bit for bit what the model's
forward gave when it wrote that chain inline: logits, running statistics
and every parameter gradient, training with dropout and a row mask, then
eval. The kernels themselves are held against the plain version on the
card (tests/test_torch_port_cuda.py)."""
import copy

import numpy as np
import pytest
import torch

from elliptic_gnn_tpu_torch import kernels
from elliptic_gnn_tpu_torch.graph import synthetic
from elliptic_gnn_tpu_torch.kernels import resbn_epilogue
from elliptic_gnn_tpu_torch.models import build_model, prepare_graph_ops
from elliptic_gnn_tpu_torch.utils.common import dropout

from tests.torch_port_threads import one_thread  # noqa: F401  (autouse fixture)


def _inline_forward(model, x, g, t, generator=None, row_mask=None):
    """SageResBN.forward with the epilogue written out as it was."""
    h = model._inject_time(x, t)
    for li in range(len(model.layers) - 1):
        h_in = h
        h = model.layers[li](h, g, model.compute_dtype)
        if model.use_bn:
            h = model.bns[li](h, row_mask)
        h = torch.relu(h)
        h = dropout(h, model.dropout, model.training, generator)
        if model.residual:
            h = h + model.res_projs[li](h_in)
    return model.layers[-1](h, g, model.compute_dtype)


VARIANTS = {"sage_resbn": dict(use_bn=True, residual=True),
            "sage_bn": dict(use_bn=True, residual=False),
            "sage_res": dict(use_bn=False, residual=True)}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_cpu_epilogue_is_the_inline_chain(variant):
    data = synthetic.generate(num_nodes=400, num_features=6, num_timesteps=6, seed=3)
    g = prepare_graph_ops(data.edge_index, data.num_nodes, "sage")
    x = torch.from_numpy(data.x)
    t = torch.from_numpy(data.timestep.astype(np.int32))
    row_mask = (torch.arange(data.num_nodes) < 370).float()
    cfg = {"hidden_dim": 12, "layers": 3, "dropout": 0.3, "time_embed_dim": 2,
           "time_embed_type": "sin", **VARIANTS[variant]}
    model = build_model("sage_resbn", 6, cfg, generator=torch.Generator().manual_seed(1))
    inline = copy.deepcopy(model)
    kernels.launch_counts(reset=True)
    runs = []
    for m, fwd in ((model, model.forward),
                   (inline, lambda *a, **k: _inline_forward(inline, *a, **k))):
        m.train()
        gen = torch.Generator().manual_seed(7)
        logits = fwd(x, g, t, generator=gen, row_mask=row_mask)
        (logits * torch.linspace(-1, 1, logits.numel()).view_as(logits)).sum().backward()
        m.eval()
        with torch.no_grad():
            eval_logits = fwd(x, g, t)
        runs.append((logits.detach(), eval_logits, dict(m.named_buffers()),
                     {k: p.grad for k, p in m.named_parameters()}))
    (a_logits, a_eval, a_bufs, a_grads), (b_logits, b_eval, b_bufs, b_grads) = runs
    assert torch.equal(a_logits, b_logits) and torch.equal(a_eval, b_eval)
    assert a_bufs.keys() == b_bufs.keys() and all(torch.equal(a_bufs[k], b_bufs[k]) for k in a_bufs)
    assert a_grads.keys() == b_grads.keys()
    assert all(torch.equal(a_grads[k], b_grads[k]) for k in a_grads)
    assert not any(resbn_epilogue.launches.values()), resbn_epilogue.launches
