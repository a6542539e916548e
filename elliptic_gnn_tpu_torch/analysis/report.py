"""Static HTML run report (port of elliptic_gnn_tpu/analysis/report.py): an
overview table over every run found under the outputs root (a metrics.json
marks a run), then per run its drift, calibration, workload and explainer
images inlined and its bootstrap, hub-ablation and robustness JSON, in one
self-contained HTML file. Host only.

CLI: python -m elliptic_gnn_tpu_torch.analysis.report [--outputs outputs]
         [--out outputs/report.html]
"""
from __future__ import annotations

import argparse
import base64
import html
import json
from pathlib import Path

METRIC_COLS = [
    "pr_auc_illicit", "roc_auc", "f1_illicit_at_thr", "threshold",
    "precision_at_k", "recall_at_precision", "ece", "n_test",
    "pr_auc_last1", "pr_auc_last3", "pr_auc_last5", "best_val_pr_auc",
]

RUN_PNGS = [
    "by_time_pr_auc.png", "calibration_curve.png", "workload_curve.png",
]


def discover_runs(outputs: Path):
    runs = []
    for mpath in sorted(outputs.rglob("metrics.json")):
        rd = mpath.parent
        kind = "other"
        if "baselines" in rd.parts:
            kind = "baselines"
        elif "gnn" in rd.parts:
            kind = "gnn"
        try:
            with open(mpath) as f:
                metrics = json.load(f)
        except Exception:
            continue
        runs.append((rd, kind, metrics))
    return runs


def _img_tag(path: Path) -> str:
    with open(path, "rb") as f:
        b64 = base64.b64encode(f.read()).decode()
    return (f'<img src="data:image/png;base64,{b64}" '
            f'style="max-width:640px" alt="{html.escape(path.name)}">')


def _fmt(v):
    if isinstance(v, float):
        return f"{v:.4f}"
    return html.escape(str(v))


def render(outputs: Path, out_path: Path) -> None:
    runs = discover_runs(outputs)
    parts = [
        "<html><head><meta charset='utf-8'><title>elliptic-gnn-tpu report"
        "</title><style>body{font-family:sans-serif;margin:2em}"
        "table{border-collapse:collapse}td,th{border:1px solid #ccc;"
        "padding:4px 8px;font-size:13px}th{background:#eee}"
        "h2{margin-top:2em;border-bottom:1px solid #999}</style></head><body>",
        f"<h1>Run report — {html.escape(str(outputs))}</h1>",
        f"<p>{len(runs)} runs discovered.</p>",
    ]

    # overview table
    parts.append("<h2>Overview</h2><table><tr><th>run</th><th>kind</th>")
    parts.extend(f"<th>{c}</th>" for c in METRIC_COLS)
    parts.append("</tr>")
    for rd, kind, metrics in runs:
        rel = html.escape(str(rd.relative_to(outputs)))
        parts.append(f"<tr><td>{rel}</td><td>{kind}</td>")
        parts.extend(
            f"<td>{_fmt(metrics[c]) if c in metrics else ''}</td>"
            for c in METRIC_COLS
        )
        parts.append("</tr>")
    parts.append("</table>")

    # per-run sections
    for rd, kind, metrics in runs:
        rel = html.escape(str(rd.relative_to(outputs)))
        section = [f"<h2>{rel}</h2>"]
        have_content = False
        for png in RUN_PNGS:
            p = rd / png
            if p.exists():
                section.append(_img_tag(p))
                have_content = True
        for extra in sorted(rd.glob("gnn_explainer_node_*.png")):
            section.append(_img_tag(extra))
            have_content = True
        for jf in sorted(rd.glob("bootstrap_compare*.json")) + sorted(
            rd.glob("metrics_hub_removed*.json")
        ) + sorted(rd.glob("robustness_*.json")):
            with open(jf) as f:
                body = json.load(f)
            section.append(
                f"<details><summary>{html.escape(jf.name)}</summary>"
                f"<pre>{html.escape(json.dumps(body, indent=2))}</pre></details>"
            )
            have_content = True
        if have_content:
            parts.extend(section)

    parts.append("</body></html>")
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text("".join(parts))
    print(f"[REPORT] wrote {out_path} ({len(runs)} runs)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--outputs", type=str, default="outputs")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)
    outputs = Path(args.outputs)
    out = Path(args.out) if args.out else outputs / "report.html"
    render(outputs, out)


if __name__ == "__main__":
    main()
