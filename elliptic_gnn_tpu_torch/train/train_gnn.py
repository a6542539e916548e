"""Full-batch GNN trainer (port of elliptic_gnn_tpu/train/train_gnn.py).

    python -m elliptic_gnn_tpu_torch.train.train_gnn --config configs/rec_k8.yaml

Same YAML keys and the same `outputs/gnn/<run>` artifacts (metrics.json,
scores_*.npy, y_*.npy, node_idx_*.npy, timestep_*.npy, config_used.yaml,
training_log.csv) as the JAX trainer. Each epoch: forward over the full
graph through the BSDA aggregation (the CUDA kernel on the GPU), masked
loss on train nodes, backward (the kernel on the transpose tables), grad
clip, Adam with L2, then an eval forward whose val probabilities and the
loss come back to the host in one copy. The host processes epoch e while
epoch e+1 runs on the device, so early stopping lags one epoch, as in the
JAX serial loop.

Runs on CUDA (`device: auto` or `cuda`) and raises when there is no GPU,
unless the config says `device: cpu`.

Not ported yet (raise): mini-batch training, multi-device meshes, resume
and best checkpoints (train/checkpoint.py), hub ablation, profiling,
archs other than the SAGE-ResBN family. `epochs_per_sync > 1` runs the
serial loop.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np
import torch
import yaml

from ..graph import load_processed, make_temporal_masks
from ..graph.transform import append_scalar_time, symmetrize_edges
from ..kernels.bsda import bfs_order, build_bsda_for_kind
from ..models import MODEL_GRAPH_KIND, build_model
from ..models.convert import params_from_jax
from ..models.losses import class_weights, make_loss_fn
from ..utils import metrics as M
from ..utils.common import (
    ensure_dir, log_device_info, resolve_device, save_json, set_seed,
)
from ..utils.logger import RunLogger
from . import calibrate


def _reject_unported(cfg: dict) -> None:
    unported = {
        "mini_batch": bool(cfg.get("mini_batch", False)),
        "mesh_devices": (cfg.get("mesh_devices", 1) or 1) not in (1, "1"),
        "resume": bool(cfg.get("resume", False)),
        "checkpoint_every": int(cfg.get("checkpoint_every", 0) or 0) > 0,
        "ablate_hubs_frac": float(cfg.get("ablate_hubs_frac", 0.0) or 0.0) > 0,
        "profile_dir": bool(cfg.get("profile_dir")),
        "aggregation": str(cfg.get("aggregation", "auto")) not in (
            "auto", "bsda", "bsda_pallas"),
    }
    bad = [k for k, v in unported.items() if v]
    if bad:
        raise NotImplementedError(
            f"config option(s) {bad} are not ported to elliptic_gnn_tpu_torch "
            "yet; use the JAX trainer (elliptic_gnn_tpu.train.train_gnn)")


def make_optimizer(model: torch.nn.Module, cfg: dict) -> torch.optim.Adam:
    """torch.optim.Adam with L2 weight decay added to the gradient before
    the moments (not AdamW); the epoch step clips the grad norm first."""
    return torch.optim.Adam(
        model.parameters(), lr=float(cfg["lr"]), betas=(0.9, 0.999), eps=1e-8,
        weight_decay=float(cfg.get("weight_decay", 0.0)))


def prepare_data(cfg: dict):
    """Load the processed graph and apply the preprocessing pipeline:
    rolling window re-mask, scalar-time append, symmetrization."""
    data = load_processed(cfg["processed_dir"])
    if data.train_mask is None:
        raise RuntimeError(
            "Build graph first: python -m elliptic_gnn_tpu_torch.graph.build_graph "
            "--config configs/split.yaml"
        )

    window_k = cfg.get("train_window_k")
    if window_k is not None:
        train_ts = data.timestep[data.train_mask]
        if train_ts.size == 0:
            raise RuntimeError("Train mask is empty; cannot apply rolling window.")
        val_ts = data.timestep[data.val_mask]
        if val_ts.size == 0:
            raise RuntimeError("Validation mask is empty; cannot infer t_val_end.")
        data = make_temporal_masks(
            data, int(train_ts.max()), int(val_ts.max()), int(window_k)
        )

    if cfg.get("use_time_scalar", False) and int(cfg.get("time_embed_dim", 0) or 0) == 0:
        data = append_scalar_time(data)

    if cfg.get("symmetrize_edges", False):
        data = symmetrize_edges(data)
    return data


def build_train_state(cfg: dict, data, seed: int, device: torch.device,
                      init_params=None):
    """(data, model, gops, optimizer, loss_fn) on `device`.

    BFS-renumbers the graph (artifacts translate back via data.orig_index)
    and builds the factored int8 BSDA tables with transpose, as the JAX
    trainer does for its Pallas path. `init_params` = (params, state) of a
    JAX model as numpy pytrees replaces the port's own init."""
    arch = cfg["arch"]
    if arch not in MODEL_GRAPH_KIND:
        raise ValueError(
            f"Unknown arch {arch!r}; expected one of {sorted(MODEL_GRAPH_KIND)}"
        )
    kind = MODEL_GRAPH_KIND[arch]
    rank = bfs_order(data.edge_index, data.num_nodes, data.timestep)
    data = data.renumber(rank)
    gen = torch.Generator().manual_seed(int(seed))
    model = build_model(arch, data.num_features, cfg, generator=gen)
    gops = build_bsda_for_kind(
        data.edge_index, data.num_nodes, kind,
        depth=int(cfg.get("bsda_depth", 3)), a_dtype="int8", transpose=True,
    ).to(device)
    if init_params is not None:
        params_from_jax(init_params[0], init_params[1], model)
    model = model.to(device)
    opt = make_optimizer(model, cfg)

    if cfg.get("class_weight_pos", "auto") == "auto":
        cw = class_weights(data.y[data.train_mask])
    else:
        cw = np.array([1.0, float(cfg["class_weight_pos"])], dtype=np.float32)
    t_train = data.timestep[data.train_mask]
    loss_fn = make_loss_fn(cfg, cw, int(t_train.min()), int(t_train.max()))
    return data, model, gops, opt, loss_fn


def main(cfg: dict, init_params=None) -> dict:
    set_seed(cfg.get("seed", 42))
    device = resolve_device(cfg.get("device", "auto"))
    _reject_unported(cfg)
    outdir = os.path.join(cfg.get("output_root", "outputs"), "gnn", cfg["run_name"])
    ensure_dir(outdir)
    logger = RunLogger(outdir)
    log_device_info(device)

    data = prepare_data(cfg)
    data, model, gops, opt, loss_fn = build_train_state(
        cfg, data, cfg.get("seed", 42), device, init_params)

    t_start = time.time()
    best_state, best_val, epochs_run, epoch_seconds = _train_loop_fullbatch(
        cfg, data, model, gops, opt, loss_fn, logger, device)
    train_seconds = time.time() - t_start
    model.load_state_dict(best_state)

    return _finalize(cfg, outdir, data, model, gops, best_val, logger,
                     train_seconds, epochs_run, epoch_seconds, device)


def _snapshot(model: torch.nn.Module) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _train_loop_fullbatch(cfg, data, model, gops, opt, loss_fn, logger, device):
    k_cfg = cfg.get("epochs_per_sync", "auto")
    if k_cfg not in (None, "auto") and int(k_cfg) > 1:
        print(f"[TRAIN] epochs_per_sync={k_cfg}: the K-epoch device loop is "
              "not ported yet; running the serial loop (same decisions)")

    x = torch.as_tensor(data.x, dtype=torch.float32, device=device)
    y_all = torch.as_tensor(np.maximum(data.y, 0).astype(np.int64), device=device)
    t_all = torch.as_tensor(data.timestep.astype(np.int32), device=device)
    train_mask_f = torch.as_tensor(data.train_mask.astype(np.float32), device=device)
    val_idx = torch.as_tensor(np.where(data.val_mask)[0], device=device)
    t_idx_arg = t_all if model.uses_time_embed else None
    use_time_loss = str(cfg.get("time_loss_weighting", "none")) != "none"
    gen = torch.Generator(device=device).manual_seed(int(cfg.get("seed", 42)) + 1)

    grad_clip = float(cfg.get("grad_clip", 0) or 0)

    def epoch_step():
        model.train()
        opt.zero_grad(set_to_none=True)
        logits = model(x, gops, t_idx_arg, generator=gen)
        loss = loss_fn(model, logits, y_all, t_all if use_time_loss else None,
                       train_mask_f)
        loss.backward()
        if grad_clip > 0:
            torch.nn.utils.clip_grad_norm_(model.parameters(), grad_clip)
        opt.step()
        model.eval()
        with torch.no_grad():
            logits = model(x, gops, t_idx_arg)
            probs_val = torch.softmax(logits, dim=1)[:, 1][val_idx]
            fused = torch.cat([probs_val, loss.detach()[None]])
        return fused, _snapshot(model)

    y_val_bin = (data.y[data.val_mask] == 1).astype(int)
    best_val, bad = -1.0, 0
    best_state = _snapshot(model)
    patience = int(cfg.get("patience", 20))
    epochs_run = 0
    epoch_seconds = []  # host wall time of each loop iteration

    def process(ep, fused_dev, state_e) -> bool:
        """Host tail of one epoch: pull the fused vector (the one sync),
        val PR-AUC, best tracking, early-stop decision."""
        nonlocal best_val, bad, best_state, epochs_run
        fused_h = fused_dev.cpu().numpy()
        p_val, loss_f = fused_h[:-1], float(fused_h[-1])
        pr_val = 0.0 if p_val.size == 0 else M.pr_auc_illicit(y_val_bin, p_val)
        logger.log_epoch(ep, loss_f, pr_val)
        epochs_run += 1
        if pr_val > best_val:
            best_val, best_state, bad = pr_val, state_e, 0
        else:
            bad += 1
        if ep % 10 == 0 or ep == 1:
            print(f"Epoch {ep:4d} | loss {loss_f:.4f} | "
                  f"val PR-AUC(illicit) {pr_val:.4f} (best {best_val:.4f})")
        if bad >= patience:
            print("Early stopping.")
            return True
        return False

    # process the PREVIOUS epoch while this one runs on the device: the
    # early-stop check lags one epoch (one discarded in-flight epoch at stop)
    pending = None
    for epoch in range(1, int(cfg["max_epochs"]) + 1):
        t0 = time.time()
        fused, state_e = epoch_step()
        stop = pending is not None and process(*pending)
        epoch_seconds.append(time.time() - t0)
        if stop:
            pending = None
            break
        pending = (epoch, fused, state_e)
    if pending is not None:
        process(*pending)
    return best_state, best_val, epochs_run, epoch_seconds


def _finalize(cfg, outdir, data, model, gops, best_val, logger,
              train_seconds: float, epochs_run: int, epoch_seconds,
              device) -> dict:
    """Full-graph eval with the best parameters, temperature scaling,
    artifacts, threshold + metrics, config echo."""
    x = torch.as_tensor(data.x, dtype=torch.float32, device=device)
    t_all = torch.as_tensor(data.timestep.astype(np.int32), device=device)
    model.eval()
    with torch.no_grad():
        logits_full = model(x, gops, t_all if model.uses_time_embed else None)
    logits_full = logits_full.cpu().numpy()
    y_val_bin = (data.y[data.val_mask] == 1).astype(int)

    temp = 1.0
    if bool(cfg.get("calibrate_temperature", True)):
        temp = calibrate.fit_temperature(logits_full[data.val_mask], y_val_bin)
        print(f"[CALIB] temperature T={temp:.4f}")

    z = logits_full / temp
    z = z - z.max(axis=1, keepdims=True)
    e = np.exp(z)
    probs = (e / e.sum(axis=1, keepdims=True))[:, 1]
    metrics = finish_run(cfg, outdir, data, probs, best_val, extra={
        "train_seconds": float(train_seconds),
        "epochs_run": int(epochs_run),
        "epoch_seconds": [float(s) for s in epoch_seconds],
        "edges_per_s": float(data.num_edges) * epochs_run / max(train_seconds, 1e-9),
        "temperature": float(temp),
    })
    with open(os.path.join(outdir, "config_used.yaml"), "w") as f:
        yaml.safe_dump(cfg, f)
    print(json.dumps(metrics, indent=2))
    logger.close()
    return metrics


def test_metrics_at_threshold(cfg: dict, y_bin: np.ndarray, p_te: np.ndarray,
                              thr: float) -> dict:
    """The standard test-metric block at a fixed threshold."""
    return dict(
        pr_auc_illicit=M.pr_auc_illicit(y_bin, p_te),
        roc_auc=M.roc_auc_illicit(y_bin, p_te),
        f1_illicit_at_thr=M.f1_at_threshold(y_bin, p_te, thr),
        threshold=float(thr),
        precision_at_k=M.precision_at_k(y_bin, p_te, int(cfg.get("topk", 100))),
        recall_at_precision=M.recall_at_precision(
            y_bin, p_te, float(cfg.get("precision_target", 0.90) or 0.90)
        ),
        ece=M.expected_calibration_error(y_bin, p_te),
        n_test=int(len(y_bin)),
    )


def finish_run(cfg: dict, outdir: str, data, probs: np.ndarray, best_val: float,
               extra: Optional[dict] = None) -> dict:
    """Artifact + metrics emission: the run-directory contract. `probs` are
    calibrated P(illicit) for all nodes."""
    y_np = data.y
    val_mask, test_mask = data.val_mask, data.test_mask
    timestep_np = data.timestep

    y_val, p_val = y_np[val_mask], probs[val_mask]
    y_te, p_te = y_np[test_mask], probs[test_mask]

    # node indices in ON-DISK numbering even though training ran on the
    # BFS-renumbered graph
    orig = (
        data.orig_index
        if data.orig_index is not None
        else np.arange(len(y_np), dtype=np.int64)
    )
    np.save(os.path.join(outdir, "scores_val.npy"), p_val)
    np.save(os.path.join(outdir, "y_val.npy"), y_val)
    np.save(os.path.join(outdir, "node_idx_val.npy"), orig[val_mask])
    np.save(os.path.join(outdir, "timestep_val.npy"), timestep_np[val_mask])
    np.save(os.path.join(outdir, "scores_test.npy"), p_te)
    np.save(os.path.join(outdir, "y_test.npy"), y_te)
    np.save(os.path.join(outdir, "node_idx_test.npy"), orig[test_mask])
    np.save(os.path.join(outdir, "timestep_test.npy"), timestep_np[test_mask])

    if cfg.get("use_val_for_thresholds", True):
        pt = float(cfg.get("precision_target", 0.0) or 0.0)
        if pt > 0:
            thr = M.pick_threshold_for_precision((y_val == 1).astype(int), p_val, pt)
        else:
            thr, _ = M.pick_threshold_max_f1((y_val == 1).astype(int), p_val)
    else:
        thr, _ = M.pick_threshold_max_f1((y_te == 1).astype(int), p_te)

    y_bin = (y_te == 1).astype(int)
    metrics = test_metrics_at_threshold(cfg, y_bin, p_te, thr)
    metrics["best_val_pr_auc"] = best_val

    test_ts = timestep_np[test_mask]
    if test_ts.size > 0:
        _, pr_by_t = M.per_timestep_pr_auc(y_bin, p_te, test_ts)
        metrics["test_pr_auc_by_time"] = pr_by_t
        if pr_by_t:
            metrics["pr_auc_last1"] = float(pr_by_t[-1])
            metrics.update(M.tail_means(pr_by_t, ks=(3, 5)))
    if extra:
        metrics.update(extra)

    save_json(os.path.join(outdir, "metrics.json"), metrics)
    return metrics


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    args = parser.parse_args()
    with open(args.config) as f:
        cfg = yaml.safe_load(f)
    main(cfg)
