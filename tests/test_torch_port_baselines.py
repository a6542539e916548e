"""Port parity of the baselines and their explainer: train_baselines (the
LR pipeline and the gradient-boosting engine, each calibration), exact
TreeSHAP and `explain xgb`, against the JAX package's tools on the same
processed graph. sklearn is deterministic for a fixed random_state, so the
artifacts are held equal: metrics.json, the score and index arrays, and
xgb_top_features.json; TreeSHAP values equal to the JAX module's and
additive to the model's decision function within 1e-9."""
import json
import os

import numpy as np
import pytest
from sklearn.ensemble import HistGradientBoostingClassifier

from elliptic_gnn_tpu.analysis import explain as jax_explain
from elliptic_gnn_tpu.analysis import treeshap as jax_treeshap
from elliptic_gnn_tpu.train import calibrate as jax_calibrate
from elliptic_gnn_tpu.train import train_baselines as jax_baselines
from elliptic_gnn_tpu_torch.analysis import explain, treeshap
from elliptic_gnn_tpu_torch.graph import build_graph
from elliptic_gnn_tpu_torch.train import calibrate, train_baselines

from tests.torch_port_threads import one_thread  # noqa: F401  (autouse fixture)

ARRAYS = [f"{n}_{s}.npy" for n in ("scores", "y", "node_idx", "timestep")
          for s in ("val", "test")]
CONFIGS = {
    "lr_isotonic": {"model": "logistic_regression", "calibration": "isotonic",
                    "C": 1.0, "max_iter": 500, "class_weight": "balanced"},
    "lr_none": {"model": "logistic_regression", "calibration": "none",
                "max_iter": 500},
    # the boosting runs train on a window of a few timesteps, which keeps
    # sklearn's binning of weighted samples (most of a fit on every train
    # row) short
    "gb_platt": {"model": "xgboost", "calibration": "platt", "n_estimators": 40,
                 "max_depth": 3, "early_stopping_rounds": 10, "train_window_k": 5},
    "gb_isotonic": {"model": "xgboost", "calibration": "isotonic", "n_estimators": 40,
                    "max_depth": 3, "early_stopping_rounds": 10, "train_window_k": 4},
}


@pytest.fixture(scope="module")
def processed(tmp_path_factory):
    root = tmp_path_factory.mktemp("baselines")
    out = str(root / "processed")
    build_graph.main({"seed": 3, "t_train_end": 10, "t_val_end": 13, "t_max": 16,
                      "synthetic": True, "synthetic_nodes": 2500,
                      "processed_dir": out, "data_dir": str(root / "raw")})
    return out


@pytest.fixture(scope="module")
def runs(processed, tmp_path_factory):
    """{config: {package: run dir}}, each package's train_baselines.main."""
    root = tmp_path_factory.mktemp("baseline_runs")
    out = {}
    for name, extra in CONFIGS.items():
        out[name] = {}
        for pkg, mod in (("jax", jax_baselines), ("port", train_baselines)):
            cfg = {"run_name": name, "seed": 0, "processed_dir": processed,
                   "output_root": str(root / pkg), "topk": 50, **extra}
            out[name][pkg] = (mod.main(dict(cfg)),
                              os.path.join(cfg["output_root"], "baselines", name))
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_train_baselines_matches_jax(runs, name):
    (m_j, d_j), (m_p, d_p) = runs[name]["jax"], runs[name]["port"]
    assert m_p == m_j
    want_engine = "sklearn_logreg" if name.startswith("lr") else m_j["engine"]
    assert m_p["engine"] == want_engine and m_p["calibration"] == CONFIGS[name]["calibration"]
    with open(os.path.join(d_p, "metrics.json")) as f:
        assert json.load(f) == json.loads(json.dumps(m_j))
    for a in ARRAYS:
        np.testing.assert_array_equal(np.load(os.path.join(d_p, a)),
                                      np.load(os.path.join(d_j, a)), err_msg=a)
    assert os.path.getsize(os.path.join(d_p, "model.pkl")) > 0


@pytest.mark.parametrize("name", ["lr_isotonic", "gb_platt"])
def test_explain_xgb_matches_jax(runs, processed, name):
    d_j, d_p = runs[name]["jax"][1], runs[name]["port"][1]
    jax_explain.run_xgb(d_j, processed, n_samples=60)
    explain.run_xgb(d_p, processed, n_samples=60)
    docs = []
    for d in (d_p, d_j):
        with open(os.path.join(d, "xgb_top_features.json")) as f:
            docs.append(json.load(f))
        assert os.path.getsize(os.path.join(d, "shap_summary.png")) > 0
    assert docs[0] == docs[1]
    assert docs[0]["method"] == ("permutation_importance" if name.startswith("lr")
                                 else "tree_shap_exact")
    explain.main(["xgb", "--run_dir", d_p, "--processed_dir", processed,
                  "--n_samples", "20"])


def _toy(seed=0, n=300, f=7):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, f))
    x[rng.random((n, f)) < 0.05] = np.nan
    y = ((np.nan_to_num(x[:, 0]) + 0.5 * np.nan_to_num(x[:, -1])
          + 0.3 * rng.standard_normal(n)) > 0).astype(int)
    return x, y


@pytest.mark.parametrize("kw", [{"max_iter": 20, "max_depth": 3}, {"max_iter": 8}])
def test_treeshap_histgb_matches_jax(kw):
    x, y = _toy()
    m = HistGradientBoostingClassifier(random_state=0, **kw).fit(x, y)
    phi, ev = treeshap.hist_gb_shap_values(m, x[:40])
    phi_j, ev_j = jax_treeshap.hist_gb_shap_values(m, x[:40])
    np.testing.assert_array_equal(phi, phi_j)
    assert ev == ev_j
    np.testing.assert_allclose(phi.sum(axis=1) + ev, m.decision_function(x[:40]),
                               rtol=0, atol=1e-9)


def test_treeshap_xgb_dump_matches_jax():
    """A hand-written two-tree XGBoost JSON dump (strict splits, a missing
    branch to the right, covers as weights)."""
    t1 = {"nodeid": 0, "split": "f0", "split_condition": 0.5, "yes": 1, "no": 2,
          "missing": 2, "cover": 10.0, "children": [
              {"nodeid": 1, "split": "f2", "split_condition": -1.0, "yes": 3, "no": 4,
               "missing": 3, "cover": 6.0, "children": [
                   {"nodeid": 3, "leaf": 0.4, "cover": 2.0},
                   {"nodeid": 4, "leaf": -0.1, "cover": 4.0}]},
              {"nodeid": 2, "leaf": -0.3, "cover": 4.0}]}
    t2 = {"nodeid": 0, "split": "f1", "split_condition": 0.0, "yes": 1, "no": 2,
          "missing": 1, "cover": 10.0, "children": [
              {"nodeid": 1, "leaf": 0.2, "cover": 7.0},
              {"nodeid": 2, "leaf": -0.25, "cover": 3.0}]}
    dumps = [json.dumps(t1), json.dumps(t2)]
    x, _ = _toy(seed=1, n=30, f=3)
    phi, ev = treeshap.xgb_json_shap_values(dumps, x, 0.1)
    phi_j, ev_j = jax_treeshap.xgb_json_shap_values(dumps, x, 0.1)
    np.testing.assert_array_equal(phi, phi_j)
    assert ev == ev_j

    def margin(row):
        a = row[0] < 0.5 if not np.isnan(row[0]) else False
        v1 = (0.4 if (row[2] < -1.0 or np.isnan(row[2])) else -0.1) if a else -0.3
        v2 = 0.2 if (np.isnan(row[1]) or row[1] < 0.0) else -0.25
        return 0.1 + v1 + v2

    np.testing.assert_allclose(phi.sum(axis=1) + ev, [margin(r) for r in x],
                               rtol=0, atol=1e-9)


def test_calibrators_match_jax():
    rng = np.random.default_rng(2)
    s = rng.random(200)
    y = (rng.random(200) < s).astype(int)
    for fit in ("calibrate_isotonic", "calibrate_platt"):
        c_p, c_j = getattr(calibrate, fit)(s, y), getattr(jax_calibrate, fit)(s, y)
        np.testing.assert_array_equal(calibrate.apply_sklearn_calibrator(c_p, s),
                                      jax_calibrate.apply_sklearn_calibrator(c_j, s))
    logits = rng.standard_normal((5, 2)).astype(np.float32)
    np.testing.assert_array_equal(calibrate.apply_temperature(logits, 1.7),
                                  jax_calibrate.apply_temperature(logits, 1.7))
