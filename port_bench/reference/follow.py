"""The reference's run of the first training steps, as the benchmark
drives the program through them: CALLS gives the epochs of each call of
the trainer's loop before the warm-up, and the dropout generator restarts
from the seed at every call. Returns what the check compares: each step's
loss and validation PR-AUC, the first step's logits of its training and of
its eval forward, the running statistics after the first step and after
all, the norm of each parameter's first gradient as the optimizer takes it,
and each parameter's change after the steps.
"""
from __future__ import annotations

import importlib
from typing import Optional

import numpy as np
import torch

from . import common
from .graph import Graph

CALLS = (1, 2)  # step 1, then steps 2 and 3
MASK_FRAC = 0.01  # delta_gap_masked: see _masked_change


def model_module(name: str):
    return importlib.import_module(f"{__package__}.{name}")


def dropout_seed(seed: int) -> int:
    """The seed of the program's dropout generator for a run seed."""
    return int(seed) + 1


def agg_precision(cfg: dict) -> str:
    """The mean aggregation's operand precision the configuration states:
    bf16 under `amp`, f32 on the ELL gather, which the system runs in f32
    whatever amp says."""
    amp = bool(cfg.get("amp", False)) and str(cfg.get("aggregation", "auto")) != "ell"
    return "bf16" if amp else "f32"


def follow(cfg: dict, arrays: dict, weights: dict, seed: int, device,
           t_train_end: int, t_val_end: int, reference: str,
           control: Optional[dict] = None, half_batch: bool = False) -> dict:
    """`weights` {name: tensor} are the initial parameters; `control` (one
    of the configuration file's "controls") computes one precision step
    below what the configuration states: {"tf32": true} the dense products in TF32,
    {"agg_step": true} the aggregation's operands one step below theirs
    (bf16 to fp8, f32 to bf16); `half_batch` leaves every other train row
    out of the loss (a fault)."""
    mod = model_module(reference)
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = Graph(cfg, arrays, t_train_end, t_val_end, device, half_batch=half_batch)
    control = control or {}
    agg = agg_precision(cfg)
    if control.get("agg_step", False):
        agg = {"f32": "bf16", "bf16": "fp8"}[agg]
    model = mod.Model(cfg, g, common.Precision(agg, bool(control.get("tf32", False))))
    names = [s[0] for s in mod.param_spec(cfg, input_width(cfg, arrays["x"].shape[1]))]
    params = [weights[k].detach().to(device, torch.float32).clone().requires_grad_() for k in names]
    P = dict(zip(names, params))
    opt = common.Adam(params, float(cfg["lr"]), float(cfg.get("weight_decay", 0.0)))
    rows, width, draws = mod.mask_layout(cfg, g.n, device.type)
    keep = 1.0 - float(cfg.get("dropout", 0.0))
    clip = float(cfg.get("grad_clip", 0) or 0)
    losses, praucs, first = [], [], {}
    for epochs in CALLS:
        gen = torch.Generator(device=device).manual_seed(dropout_seed(seed))
        for _ in range(epochs):
            masks = common.dropout_masks(rows, width, draws, gen, keep, device)
            logits = model.forward(P, True, masks)
            loss = common.weighted_ce(logits, g.y, g.cw, g.train_mask)
            grads = torch.autograd.grad(loss, params)
            opt.step(common.clip_grads(list(grads), clip))
            with torch.no_grad():
                eval_logits = model.forward(P, False)
                probs = torch.softmax(eval_logits, dim=1)[:, 1][g.val_idx]
            losses.append(float(loss.detach()))
            praucs.append(common.pr_auc(g.y_val, probs.cpu().numpy()))
            if not first:
                first = {"logits": logits.detach().cpu(), "eval_logits": eval_logits.cpu(),
                         "bn": model.buffers()}
    with torch.no_grad():
        grad = {k: float(torch.linalg.vector_norm(s)) for k, s in zip(names, opt.seen)}
        delta = {k: (p - weights[k].to(device)).cpu() for k, p in zip(names, params)}
        steps = {k: [(m.cpu(), gr.cpu()) for m, gr in (step[i] for step in opt.steps)]
                 for i, k in enumerate(names)}
    return {"loss": losses, "pr_auc": praucs, "grad": grad, "delta": delta,
            "logits": first["logits"], "eval_logits": first["eval_logits"],
            "bn_1": first["bn"], "bn_3": model.buffers(), "steps": steps, "rank": g.rank}


def as_program(ref: dict) -> dict:
    """A reference's record put in the program's place (a control, a fault):
    its logits in the program's row order, its running statistics alone."""
    rows = {}
    for key in ("logits", "eval_logits"):
        out = torch.empty_like(ref[key])
        out[torch.as_tensor(ref["rank"], dtype=torch.long)] = ref[key]
        rows[key] = out
    stats = {key: {k: v for k, (v, _) in ref[key].items()} for key in ("bn_1", "bn_3")}
    return {**ref, **rows, **stats}


def _row_gap(prog: torch.Tensor, ref: torch.Tensor, rank) -> float:
    """The median row's widest logit gap over the median row's widest
    reference logit; the program's rows are in its own order (row
    rank[node] holds node)."""
    mine = prog.float()[torch.as_tensor(rank, dtype=torch.long)]
    gap = (mine - ref.float()).abs().amax(dim=1)
    return float(gap.median() / ref.float().abs().amax(dim=1).median().clamp_min(1e-30))


def _bn_gap(prog: dict, ref: dict) -> float:
    """The widest gap of a running statistic: the norm of the program's
    minus the reference's, over the norm of what the steps put into the
    reference's (the statistic less what is left of its initial value)."""
    return max(float(torch.linalg.vector_norm(prog[k].float() - r)
                     / torch.linalg.vector_norm(r - left).clamp_min(1e-30))
               for k, (r, left) in ref.items())


def _masked_change(delta: torch.Tensor, steps: list, frac: float) -> torch.Tensor:
    """The elements of a change whose reference moment stood clear of zero at
    every step: |bias-corrected first moment| >= frac times the root mean
    square of that step's gradient over the parameter. An element whose
    moment is nought to rounding takes an Adam step of about +-lr whose sign
    the rounding decides."""
    keep = torch.ones_like(delta, dtype=torch.bool)
    for m_hat, g in steps:
        keep &= m_hat.abs() >= frac * g.pow(2).mean().sqrt()
    return delta[keep]


def compare(prog: dict, ref: dict, floor: float = 1e-3, mask_frac: float = MASK_FRAC) -> dict:
    """The numbers the check compares (limits/<cell>.json holds those a cell
    holds, each to its limit):
    loss_gap_<s>  |program loss - reference loss| / |reference loss| at step s
    prauc_gap     the widest |program - reference| validation PR-AUC
    logit_gap     the first step's training forward: the median row's widest
                  logit gap (_row_gap). Rounding that reaches a few rows
                  only (the BSDA spill's) leaves the median row alone; a
                  precision step below the configuration's moves every row
    eval_gap      the same of the first step's eval forward (after the
                  first update, on the running statistics)
    bn_gap_1, bn_gap_3  the running statistics after the first step and
                  after the last (_bn_gap); absent where the model has none
    grad_gap      over the parameters, the gap of the first gradient's
                  norms, against the reference's norm of that parameter or
                  of the median parameter, whichever is larger
    delta_gap     the same for the change after the steps, over the
                  parameters whose reference gradient is at least `floor`
                  times the median parameter's (a bias before a BatchNorm
                  has a gradient of rounding only, and moves by Adam's
                  rounding alone)
    delta_gap_masked  the widest of the same gap over those parameters with
                  the elements whose reference moment was nought to
                  rounding at some step left out (_masked_change)."""
    out = {}
    for s, (lp, lr) in enumerate(zip(prog["loss"], ref["loss"]), start=1):
        out[f"loss_gap_{s}"] = abs(lp - lr) / max(abs(lr), 1e-30)
    out["prauc_gap"] = max(abs(a - b) for a, b in zip(prog["pr_auc"], ref["pr_auc"]))
    out["logit_gap"] = _row_gap(prog["logits"], ref["logits"], ref["rank"])
    out["eval_gap"] = _row_gap(prog["eval_logits"], ref["eval_logits"], ref["rank"])
    if ref["bn_1"]:
        out["bn_gap_1"] = _bn_gap(prog["bn_1"], ref["bn_1"])
        out["bn_gap_3"] = _bn_gap(prog["bn_3"], ref["bn_3"])
    names = list(ref["grad"])
    gr = np.array([ref["grad"][k] for k in names])
    gp = np.array([prog["grad"][k] for k in names])
    med = float(np.median(gr))
    out["grad_gap"] = float(np.max(np.abs(gp - gr) / np.maximum(gr, med)))
    counted = [k for k, v in zip(names, gr) if v >= floor * med]

    def gaps(dp, dr):
        dp, dr = np.array(dp), np.array(dr)
        return np.abs(dp - dr) / np.maximum(dr, float(np.median(dr)))

    norm = torch.linalg.vector_norm
    per_leaf = gaps([float(norm(prog["delta"][k])) for k in counted],
                    [float(norm(ref["delta"][k])) for k in counted])
    out["delta_gap"] = float(np.max(per_leaf))
    kept = [(_masked_change(prog["delta"][k], ref["steps"][k], mask_frac),
             _masked_change(ref["delta"][k], ref["steps"][k], mask_frac)) for k in counted]
    out["delta_gap_masked"] = float(np.max(gaps([float(norm(a)) for a, _ in kept],
                                                [float(norm(b)) for _, b in kept])))
    return out


def input_width(cfg: dict, n_features: int) -> int:
    """The model's input features after the trainer's preprocessing: one
    more with the scalar time (use_time_scalar without a time embedding);
    a time embedding is appended inside the model."""
    scalar = cfg.get("use_time_scalar", False) and int(cfg.get("time_embed_dim", 0) or 0) == 0
    return int(n_features) + (1 if scalar else 0)
