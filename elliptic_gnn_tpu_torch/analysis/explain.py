"""Explainability (port of elliptic_gnn_tpu/analysis/explain.py): feature
attributions for the baselines, GNNExplainer-style edge and feature masks
for GNN runs.

  - `xgb`: loads a baseline run's model.pkl and attributes features on at
    most 200 random test rows: exact TreeSHAP for the tree models
    (analysis/treeshap.py), permutation importance for the LR pipeline.
    Writes shap_summary.png + xgb_top_features.json. Host only.
  - `gnn`: rebuilds the model from config_used.yaml and best.ckpt on the
    run's device (the GPU unless its config says `device: cpu`), picks the
    node to explain (highest-scored true positive, else false positive,
    else top score, at the threshold of metrics.json), and learns sigmoid
    edge and feature masks on the node's k-hop subgraph with Adam: the
    GNNExplainer objective (fidelity to the predicted class + L1 +
    entropy), the edge masks multiplying the ELL weights of the subgraph
    (models.prepare_graph_ops, the ELL gather on either device). Writes
    gnn_explainer_node_<id>.png + gnn_explainer_importance.json.

As in the JAX package, a GAT run's ELL weights only mark validity (w > 0):
its edge masks reach the loss through the L1 and entropy terms alone,
never through the fidelity term.

CLI:
  python -m elliptic_gnn_tpu_torch.analysis.explain xgb --run_dir outputs/baselines/<run> \\
      --processed_dir data/processed
  python -m elliptic_gnn_tpu_torch.analysis.explain gnn --run_dir outputs/gnn/<run> \\
      [--node_idx N] [--steps 300] [--device cpu|cuda]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.common import save_json
from .common import load_model, load_run_arrays, load_run_data, load_run_metrics, pyplot


# ---------------------------------------------------------------- xgb ----

def run_xgb(run_dir: str, processed_dir: str, n_samples: int = 200,
            top_k: int = 20, seed: int = 42) -> None:
    from ..graph import load_processed
    from ..train.train_baselines import get_split_arrays

    with open(os.path.join(run_dir, "model.pkl"), "rb") as f:
        model = pickle.load(f)
    data = load_processed(processed_dir)
    _, _, test = get_split_arrays(data)
    x_te, y_te = data.x[test], data.y[test]

    rng = np.random.default_rng(seed)
    n = min(n_samples, len(y_te))
    sel = rng.choice(len(y_te), size=n, replace=False)

    from sklearn.ensemble import HistGradientBoostingClassifier

    extra = {}
    if type(model).__name__ == "XGBClassifier":
        from .treeshap import xgb_shap_values

        phi, expected = xgb_shap_values(model, x_te[sel])
        imp = np.abs(phi).mean(axis=0)
        method = "tree_shap_exact_xgboost"
        extra = {"expected_value": float(expected), "space": "log_odds"}
        xlabel = "mean |SHAP value| (log-odds)"
    elif isinstance(model, HistGradientBoostingClassifier):
        from .treeshap import hist_gb_shap_values

        phi, expected = hist_gb_shap_values(model, x_te[sel])
        imp = np.abs(phi).mean(axis=0)
        method = "tree_shap_exact"
        extra = {"expected_value": float(expected), "space": "log_odds"}
        xlabel = "mean |SHAP value| (log-odds)"
    else:
        from sklearn.inspection import permutation_importance

        result = permutation_importance(
            model, x_te[sel], (y_te[sel] == 1).astype(int),
            n_repeats=5, random_state=seed, scoring="average_precision",
        )
        imp = result.importances_mean
        method = "permutation_importance"
        xlabel = "permutation importance (AP drop)"
    order = np.argsort(-imp)[:top_k]
    top = [{"feature": f"f{int(i)}", "importance": float(imp[i])} for i in order]
    save_json(os.path.join(run_dir, "xgb_top_features.json"), {
        "method": method,
        "n_samples": n,
        "top_features": top,
        **extra,
    })

    png = os.path.join(run_dir, "shap_summary.png")
    plt = pyplot(png, "EXPLAIN/xgb")
    if plt is None:
        return
    plt.figure(figsize=(7, 6))
    plt.barh([t["feature"] for t in top][::-1], [t["importance"] for t in top][::-1])
    plt.xlabel(xlabel)
    plt.title(f"Top-{top_k} features ({n} test rows)")
    plt.tight_layout()
    plt.savefig(png, dpi=200)
    plt.close()
    print("[EXPLAIN/xgb] wrote xgb_top_features.json + shap_summary.png")


# ---------------------------------------------------------------- gnn ----

def _pick_node(run_dir: str) -> Tuple[int, str]:
    """Highest-scored TP, else FP, else top score."""
    thr = float(load_run_metrics(run_dir)["threshold"])
    arr = load_run_arrays(run_dir, "test")
    s, y, idx = arr["scores"], arr["y"], arr["node_idx"]
    order = np.argsort(-s)
    for kind, cond in (
        ("true_positive", (y == 1) & (s >= thr)),
        ("false_positive", (y == 0) & (s >= thr)),
    ):
        cand = order[cond[order]]
        if cand.size:
            return int(idx[cand[0]]), kind
    return int(idx[order[0]]), "top_score"


def _k_hop_in_edges(edge_index: np.ndarray, target: int, k: int):
    """Edges on incoming paths of length <= k into `target`, and the sorted
    nodes they touch."""
    src, dst = edge_index
    frontier = {int(target)}
    nodes = {int(target)}
    keep = np.zeros(edge_index.shape[1], dtype=bool)
    for _ in range(k):
        m = np.isin(dst, list(frontier))
        keep |= m
        new_nodes = set(src[m].tolist())
        frontier = new_nodes - nodes
        nodes |= new_nodes
        if not frontier:
            break
    return np.where(keep)[0], np.array(sorted(nodes), dtype=np.int64)


@dataclasses.dataclass
class Explanation:
    """explain_node's result. `edges` [E, 2] (src, dst) in on-disk node ids,
    one row per valid ELL slot of the subgraph (self-loops included) in the
    slot order of the JAX tool's report; `edge_mask` [E] and `feat_mask`
    [F] the sigmoid masks, on the run's device."""

    node_idx: int
    picked: str
    predicted_class: int
    loss: float
    edges: np.ndarray
    edge_mask: torch.Tensor
    feat_mask: torch.Tensor


def explain_node(run_dir: str, node_idx: Optional[int] = None, steps: int = 300,
                 lr: float = 0.05, l1_edge: float = 0.005, l1_feat: float = 0.1,
                 device: Optional[str] = None) -> Explanation:
    """Learn the GNNExplainer masks of one node: `steps` eager Adam steps on
    the node's k-hop subgraph (k = the model's layers), on the run's device
    (`device` overrides it)."""
    from ..models import MODEL_GRAPH_KIND, prepare_graph_ops
    from ..utils.common import resolve_device, upload

    cfg, data = load_run_data(run_dir)
    dev = resolve_device(device or cfg.get("device", "auto"))
    model = load_model(cfg, data.num_features, run_dir, dev)
    if node_idx is None:
        node_idx, picked = _pick_node(run_dir)
    else:
        picked = "user"

    edge_ids, sub_nodes = _k_hop_in_edges(data.edge_index, node_idx, int(cfg.get("layers", 3)))
    if edge_ids.size == 0:
        print("[EXPLAIN/gnn] isolated node; nothing to explain")
        sub_nodes = np.array([node_idx])
    sub_ei = np.searchsorted(sub_nodes, data.edge_index[:, edge_ids]).astype(np.int32)
    target = int(np.searchsorted(sub_nodes, node_idx))

    gops = prepare_graph_ops(sub_ei, len(sub_nodes), MODEL_GRAPH_KIND[cfg["arch"]]).to(dev)
    x = upload(data.x[sub_nodes], dev, torch.float32)
    t = (upload(data.timestep[sub_nodes].astype(np.int32), dev)
         if model.uses_time_embed else None)
    with torch.no_grad():
        cls = int(torch.argmax(model(x, gops, t)[target]))

    # one mask logit per ELL weight slot and one per feature
    m_edges = [torch.full(w.shape, 2.0, device=dev, requires_grad=True)
               for w in gops.weights]
    m_feat = torch.full((data.num_features,), 2.0, device=dev, requires_grad=True)
    valid = [(w > 0).to(torch.float32) for w in gops.weights]
    n_valid = max(sum(int(w.gt(0).sum()) for w in gops.weights), 1)
    opt = torch.optim.Adam(m_edges + [m_feat], lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def loss_fn():
        sig_e = [torch.sigmoid(m) for m in m_edges]
        gops_m = dataclasses.replace(
            gops, weights=tuple(w * s for w, s in zip(gops.weights, sig_e)))
        sig_f = torch.sigmoid(m_feat)
        logp = torch.log_softmax(model(x * sig_f[None, :], gops_m, t)[target], dim=-1)
        l1_e = sum((s * v).sum() for s, v in zip(sig_e, valid)) / n_valid
        ent_e = sum(
            (-(s * torch.log(s + 1e-9) + (1 - s) * torch.log(1 - s + 1e-9)) * v).sum()
            for s, v in zip(sig_e, valid)) / n_valid
        return -logp[cls] + l1_edge * l1_e + 0.1 * ent_e + l1_feat * sig_f.mean()

    loss = torch.zeros((), device=dev)
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn()
        loss.backward()
        opt.step()

    # valid slots, row-major within each bucket, buckets in order
    edges, mask = [], []
    for nbr, w, rows, m in zip(gops.nbrs, gops.weights, gops.rows, m_edges):
        r_idx, s_idx = torch.nonzero(w > 0, as_tuple=True)
        edges.append(torch.stack([nbr[r_idx, s_idx], rows[r_idx]], dim=1).cpu().numpy())
        mask.append(torch.sigmoid(m.detach())[r_idx, s_idx])
    return Explanation(
        node_idx=int(node_idx), picked=picked, predicted_class=cls,
        loss=float(loss.detach()),
        edges=sub_nodes[np.concatenate(edges)] if edges else np.zeros((0, 2), np.int64),
        edge_mask=torch.cat(mask) if mask else torch.zeros(0, device=dev),
        feat_mask=torch.sigmoid(m_feat.detach()))


def run_gnn(run_dir: str, node_idx: Optional[int] = None, steps: int = 300,
            lr: float = 0.05, l1_edge: float = 0.005, l1_feat: float = 0.1,
            top_k: int = 20, seed: int = 0, device: Optional[str] = None) -> Explanation:
    """explain_node, then the JAX tool's two artifacts in the run dir."""
    ex = explain_node(run_dir, node_idx, steps, lr, l1_edge, l1_feat, device)
    print(f"[EXPLAIN/gnn] node {ex.node_idx} ({ex.picked})")
    print(f"[EXPLAIN/gnn] mask optimization done (loss={ex.loss:.4f})")
    mask = ex.edge_mask.cpu().numpy()
    edge_imp = [(int(s), int(d), float(v)) for (s, d), v in zip(ex.edges, mask)
                if s != d]  # self-loops are not reported
    edge_imp.sort(key=lambda e: -e[2])
    feat_sig = ex.feat_mask.cpu().numpy()
    feat_order = np.argsort(-feat_sig)[:top_k]
    save_json(os.path.join(run_dir, "gnn_explainer_importance.json"), {
        "node_idx": ex.node_idx,
        "picked": ex.picked,
        "predicted_class": ex.predicted_class,
        "top_edges": [{"src": s, "dst": d, "importance": v} for s, d, v in edge_imp[:top_k]],
        "top_features": [{"feature": f"f{int(i)}", "importance": float(feat_sig[i])}
                         for i in feat_order],
    })

    out_png = os.path.join(run_dir, f"gnn_explainer_node_{ex.node_idx}.png")
    plt = pyplot(out_png, "EXPLAIN/gnn")
    if plt is None:
        return ex
    import networkx as nx

    g = nx.DiGraph()
    for s, d, v in edge_imp[:200]:
        g.add_edge(s, d, weight=v)
    g.add_node(ex.node_idx)
    pos = nx.spring_layout(g, seed=seed)
    widths = [2.5 * g[u][v]["weight"] + 0.2 for u, v in g.edges]
    colors = ["crimson" if n == ex.node_idx else "steelblue" for n in g.nodes]
    plt.figure(figsize=(8, 6))
    nx.draw_networkx(g, pos, node_size=120, node_color=colors, width=widths,
                     with_labels=len(g) <= 40, font_size=7, arrows=True)
    plt.title(f"GNNExplainer masks around node {ex.node_idx} (class {ex.predicted_class})")
    plt.axis("off")
    plt.tight_layout()
    plt.savefig(out_png, dpi=200)
    plt.close()
    print(f"[EXPLAIN/gnn] wrote gnn_explainer_importance.json + {out_png}")
    return ex


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_x = sub.add_parser("xgb")
    p_x.add_argument("--run_dir", type=str, required=True)
    p_x.add_argument("--processed_dir", type=str, default="data/processed")
    p_x.add_argument("--n_samples", type=int, default=200)

    p_g = sub.add_parser("gnn")
    p_g.add_argument("--run_dir", type=str, required=True)
    p_g.add_argument("--node_idx", type=int, default=None)
    p_g.add_argument("--steps", type=int, default=300)
    p_g.add_argument("--device", type=str, default=None, choices=["cpu", "cuda"])

    args = parser.parse_args(argv)
    if args.cmd == "xgb":
        run_xgb(args.run_dir, args.processed_dir, args.n_samples)
    else:
        run_gnn(args.run_dir, args.node_idx, args.steps, device=args.device)


if __name__ == "__main__":
    main()
