"""Port parity: the torch SAGE-ResBN with the JAX model's init parameters
carried across by params_from_jax, against the JAX model on the same
tables and inputs — eval logits, train-mode logits and BatchNorm running
stats, and parameter gradients of the masked weighted-CE loss (dropout 0).

The JAX side aggregates through the Pallas kernel (interpret mode) with
amp, through its XLA path without. Tolerances: f32 rtol 1e-4, atol 1e-5
(1e-4 on gradients: three layers of f32 sums in another order); amp
(bf16 aggregation operands and results) atol 5e-2, rtol 5e-2."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from elliptic_gnn_tpu.kernels import bsda as jax_bsda
from elliptic_gnn_tpu.models import build_model as jax_build_model
from elliptic_gnn_tpu.models.losses import make_loss_fn as jax_make_loss_fn
from elliptic_gnn_tpu_torch.kernels import bsda as port_bsda
from elliptic_gnn_tpu_torch.models import build_model
from elliptic_gnn_tpu_torch.models.convert import params_from_jax
from elliptic_gnn_tpu_torch.models.losses import make_loss_fn
from elliptic_gnn_tpu_torch.models.modules import sinusoid_time_embed
from tests.test_torch_port_tables import port_graph
from tests.torch_port_threads import one_thread  # noqa: F401  (autouse fixture)

N, F_IN, T_MAX = 600, 20, 16
F32 = dict(rtol=1e-4, atol=1e-5)
F32_GRAD = dict(rtol=1e-4, atol=1e-4)
AMP = dict(rtol=5e-2, atol=5e-2)


def _cfg(amp):
    return {"hidden_dim": 16, "layers": 3, "dropout": 0.0, "amp": amp,
            "time_embed_dim": 2, "time_embed_type": "sin",
            "max_timestep": T_MAX, "weight_decay": 0.0, "lr": 1e-3}


def _setup(amp):
    ei, block_ids = port_graph(N, 4, 1.5, seed=41, n_far=50)
    rng = np.random.default_rng(41)
    x = rng.standard_normal((N, F_IN)).astype(np.float32)
    t = (block_ids * 3 + 1).astype(np.int32)
    y = (rng.random(N) < 0.2).astype(np.int32)
    mask = (rng.random(N) < 0.5).astype(np.float32)
    gj = jax_bsda.build_bsda_for_kind(ei, N, "sage", depth=3, a_dtype="int8")
    gj = dataclasses.replace(gj, use_pallas_kernel=amp)
    if amp:
        gj = dataclasses.replace(gj, transpose=dataclasses.replace(
            gj.transpose, use_pallas_kernel=True))
    gp = port_bsda.build_bsda_for_kind(ei, N, "sage", depth=3, a_dtype="int8")
    cfg = _cfg(amp)
    mj = jax_build_model("sage_resbn", F_IN, cfg)
    params, state = mj.init(jax.random.key(3))
    mp = build_model("sage_resbn", F_IN, cfg)
    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    params_from_jax(to_np(params), to_np(state), mp)
    return dict(x=x, t=t, y=y, mask=mask, gj=gj, gp=gp, mj=mj, mp=mp,
                params=params, state=state, cfg=cfg)


def test_sinusoid_time_embed_matches():
    from elliptic_gnn_tpu.models.modules import sinusoid_time_embed as jax_sin

    t = np.arange(0, 52, dtype=np.int32)
    for dim in (2, 3, 8):
        np.testing.assert_allclose(
            sinusoid_time_embed(torch.from_numpy(t), dim, 49).numpy(),
            np.asarray(jax_sin(jnp.asarray(t), dim, 49)), **F32)


@pytest.mark.parametrize("amp", [False, True])
def test_eval_logits_match(amp):
    s = _setup(amp)
    lj, _ = s["mj"].apply(s["params"], s["state"], jnp.asarray(s["x"]), s["gj"],
                          jnp.asarray(s["t"]), training=False)
    s["mp"].eval()
    with torch.no_grad():
        lp = s["mp"](torch.from_numpy(s["x"]), s["gp"], torch.from_numpy(s["t"]))
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), **(AMP if amp else F32))


def test_train_logits_and_bn_state_match():
    s = _setup(False)
    lj, new_state = s["mj"].apply(
        s["params"], s["state"], jnp.asarray(s["x"]), s["gj"],
        jnp.asarray(s["t"]), training=True, rng=jax.random.key(0))
    s["mp"].train()
    with torch.no_grad():
        lp = s["mp"](torch.from_numpy(s["x"]), s["gp"], torch.from_numpy(s["t"]))
    np.testing.assert_allclose(lp.numpy(), np.asarray(lj), **F32)
    for bn, st in zip(s["mp"].bns, new_state["bns"]):
        np.testing.assert_allclose(bn.mean.numpy(), np.asarray(st["mean"]), **F32)
        np.testing.assert_allclose(bn.var.numpy(), np.asarray(st["var"]), **F32)
        assert float(bn.count) == float(st["count"]) == 1.0


@pytest.mark.parametrize("amp", [False, True])
def test_param_grads_match(amp):
    s = _setup(amp)
    cw = np.array([0.6, 2.5], np.float32)
    loss_j = jax_make_loss_fn(s["cfg"], cw, 1, 10)
    loss_p = make_loss_fn(s["cfg"], cw, 1, 10)
    x, t = jnp.asarray(s["x"]), jnp.asarray(s["t"])
    y, m = jnp.asarray(s["y"]), jnp.asarray(s["mask"])

    def lf(p):
        logits, _ = s["mj"].apply(p, s["state"], x, s["gj"], t, training=True,
                                  rng=jax.random.key(0))
        return loss_j(p, logits, y, None, m)

    lval_j, grads = jax.value_and_grad(lf)(s["params"])
    mp = s["mp"]
    mp.train()
    logits = mp(torch.from_numpy(s["x"]), s["gp"], torch.from_numpy(s["t"]))
    lval_p = loss_p(mp, logits, torch.from_numpy(s["y"]), None,
                    torch.from_numpy(s["mask"]))
    lval_p.backward()
    tol = AMP if amp else F32_GRAD
    np.testing.assert_allclose(float(lval_p.detach()), float(lval_j), **(AMP if amp else F32))
    for layer, gl in zip(mp.layers, grads["layers"]):
        np.testing.assert_allclose(layer.lin_l.weight.grad.numpy().T,
                                   np.asarray(gl["w_l"]), **tol)
        np.testing.assert_allclose(layer.lin_l.bias.grad.numpy(),
                                   np.asarray(gl["b_l"]), **tol)
        np.testing.assert_allclose(layer.lin_r.weight.grad.numpy().T,
                                   np.asarray(gl["w_r"]), **tol)
    for bn, gb in zip(mp.bns, grads["bns"]):
        np.testing.assert_allclose(bn.scale.grad.numpy(), np.asarray(gb["scale"]), **tol)
        np.testing.assert_allclose(bn.bias.grad.numpy(), np.asarray(gb["bias"]), **tol)
    np.testing.assert_allclose(mp.res_projs[0].weight.grad.numpy().T,
                               np.asarray(grads["res_projs"][0]["w"]), **tol)
