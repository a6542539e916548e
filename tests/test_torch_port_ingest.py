"""Port parity of the CSV ingest: every fixture of the ingest fuzz battery
(format variants, 64-bit txIds, missing labels, NaN features, unmapped
edge endpoints), written here into tmp_path, goes through the JAX
package's load_elliptic_as_graph and the port's, with the native CSV
parser (EGNN_NATIVE=1) and without it (=0). Graph arrays must be equal
exactly (NaNs in the same places) and meta equal; the build_graph CLIs
must write the same graph.npz and meta.json. The port reads the CSVs
without pandas.

One deliberate difference: above 2**53 the JAX loader maps edge txIds
through float64 and so merges neighbouring ids; the port keeps them exact.
On that fixture the port's edges are held to the exact expected edges and
everything else to the JAX loader's output."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from elliptic_gnn_tpu import native as jax_native
from elliptic_gnn_tpu.graph import build_graph as jax_build_graph
from elliptic_gnn_tpu.graph import synthetic as jax_synthetic
from elliptic_gnn_tpu.graph.ingest import load_elliptic_as_graph as jax_load
from elliptic_gnn_tpu_torch import native
from elliptic_gnn_tpu_torch.graph import build_graph, synthetic
from elliptic_gnn_tpu_torch.graph.ingest import load_elliptic_as_graph

from tests.torch_port_threads import one_thread  # noqa: F401  (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FEAT = 4
VARIANTS = ["plain", "crlf", "quoted", "spaces", "no_edge_header",
            "cls_extra_col", "cls_shuffled", "no_trailing_newline"]


@pytest.fixture(params=["1", "0"], ids=["native", "no_native"])
def native_mode(request, monkeypatch):
    """EGNN_NATIVE for both packages' loaders, their library caches reset."""
    monkeypatch.setenv("EGNN_NATIVE", request.param)
    for mod in (native, jax_native):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_tried", False)
    yield request.param
    for mod in (native, jax_native):
        mod._lib, mod._tried = None, False


def _write(d, name, text):
    with open(os.path.join(d, name), "w", newline="") as f:
        f.write(text)


def _base_rows(tx_base=10_000):
    """8 nodes over 2 timesteps, known labels and features; 5 edges, the
    last across timesteps."""
    rng = np.random.default_rng(0)
    tx = tx_base + np.arange(8)
    ts = np.array([1, 1, 1, 1, 2, 2, 2, 2])
    y = ["1", "2", "unknown", "1", "2", "unknown", "1", "2"]
    x = np.round(rng.standard_normal((8, N_FEAT)), 4)
    edges = [(tx[0], tx[1]), (tx[1], tx[2]), (tx[4], tx[5]), (tx[6], tx[7]),
             (tx[0], tx[4])]
    return tx, ts, y, x, edges


def _write_csvs(d, tx, ts, y, x, edges, *, eol="\n", quote=False, spaces=False,
                edge_header=True, cls_extra_col=False, cls_shuffled=False,
                trailing_newline=True):
    q = (lambda s: f'"{s}"') if quote else (lambda s: s)
    sep = ", " if spaces else ","
    feat = [sep.join([q(str(t)), q(str(s))] + [q(repr(float(v))) for v in row])
            for t, s, row in zip(tx, ts, x)]
    header = ["txId", "class"] + (["notes"] if cls_extra_col else [])
    if cls_shuffled:
        header = header[::-1]
    cls = [sep.join(q(h) for h in header)]
    for t, lab in zip(tx, y):
        row = {"txId": str(t), "class": lab, "notes": "n/a"}
        cls.append(sep.join(q(row[h]) for h in header))
    edge = [sep.join([q("txId1"), q("txId2")])] if edge_header else []
    edge += [sep.join([q(str(a)), q(str(b))]) for a, b in edges]
    tail = eol if trailing_newline else ""
    _write(d, "elliptic_txs_features.csv", eol.join(feat) + tail)
    _write(d, "elliptic_txs_classes.csv", eol.join(cls) + tail)
    _write(d, "elliptic_txs_edgelist.csv", eol.join(edge) + tail)


def _edit_lines(path, fn):
    lines = open(path).read().splitlines()
    fn(lines)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _fixture(d, name):
    """Writes fixture `name` into d; returns (tx, ts, y, x, edges)."""
    rows = _base_rows(9_007_199_254_740_993 + 10 if name == "64bit_txids" else 10_000)
    tx, ts, y, x, edges = rows
    kw = {"crlf": dict(eol="\r\n"), "quoted": dict(quote=True),
          "spaces": dict(spaces=True), "no_edge_header": dict(edge_header=False),
          "cls_extra_col": dict(cls_extra_col=True),
          "cls_shuffled": dict(cls_shuffled=True),
          "no_trailing_newline": dict(trailing_newline=False)}.get(name, {})
    if name == "unmapped_endpoints":
        edges = edges + [(999, tx[0]), (tx[1], 123456789)]
    _write_csvs(d, tx, ts, y, x, edges, **kw)
    if name == "missing_labels":
        def drop(lines):
            del lines[6], lines[3]  # classes rows of tx[5] and tx[2]
        _edit_lines(os.path.join(d, "elliptic_txs_classes.csv"), drop)
    if name == "nan_features":
        def nan(lines):
            cells = lines[3].split(",")
            cells[2], cells[3] = "NaN", ""
            lines[3] = ",".join(cells)
        _edit_lines(os.path.join(d, "elliptic_txs_features.csv"), nan)
    return tx, ts, y, x, edges


def _assert_same_graph(a, b, edges=True):
    for name in ("x", "y", "timestep") + (("edge_index",) if edges else ()):
        va, vb = getattr(a, name), getattr(b, name)
        assert va.dtype == vb.dtype and va.shape == vb.shape, name
        np.testing.assert_array_equal(va, vb, err_msg=name)  # NaN == NaN here


@pytest.mark.parametrize("name", VARIANTS + ["missing_labels", "nan_features",
                                             "unmapped_endpoints"])
def test_ingest_matches_jax(tmp_path, native_mode, name):
    d = str(tmp_path)
    _fixture(d, name)
    want, meta_want = jax_load(d)
    got, meta_got = load_elliptic_as_graph(d)
    _assert_same_graph(got, want)
    assert meta_got == meta_want
    assert got.edge_index.shape == (2, 4)
    if name == "nan_features":
        assert np.isnan(got.x[3, :2]).all() and np.isfinite(got.x[3, 2:]).all()
    if name == "missing_labels":
        assert got.y[2] == got.y[5] == -1


def test_ingest_64bit_txids_exact(tmp_path, native_mode):
    """Ids above 2**53 (the native parser refuses them): features, labels,
    timesteps and meta as the JAX loader gives them, edges exact."""
    d = str(tmp_path)
    _fixture(d, "64bit_txids")
    want, meta_want = jax_load(d)
    got, meta_got = load_elliptic_as_graph(d)
    _assert_same_graph(got, want, edges=False)
    assert meta_got == meta_want
    np.testing.assert_array_equal(got.edge_index, [[0, 1, 4, 6], [1, 2, 5, 7]])


@pytest.mark.parametrize("name", ["plain", "nan_features"])
def test_build_graph_cli_matches_jax(tmp_path, native_mode, name):
    raw = tmp_path / "raw"
    raw.mkdir()
    _fixture(str(raw), name)
    outs = []
    for main, sub in ((jax_build_graph.main, "jax"), (build_graph.main, "port")):
        cfg = {"seed": 0, "t_train_end": 1, "t_val_end": 2, "t_max": 2,
               "data_dir": str(raw), "processed_dir": str(tmp_path / sub)}
        main(cfg)
        outs.append(cfg["processed_dir"])
    a, b = (np.load(os.path.join(p, "graph.npz")) for p in outs)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    ma, mb = (json.load(open(os.path.join(p, "meta.json"))) for p in outs)
    assert ma == mb and mb["source"] == "elliptic_csv"


def test_write_raw_csvs_matches_jax(tmp_path, native_mode):
    """graph/synthetic.py::write_raw_csvs writes the JAX package's three
    files byte for byte for the same graph and seed, and the port's
    build_graph on them gives the JAX build_graph's graph.npz."""
    kw = dict(num_nodes=900, num_features=6, num_timesteps=6, seed=2)
    dirs = {"jax": str(tmp_path / "raw_jax"), "port": str(tmp_path / "raw_port")}
    jax_synthetic.write_raw_csvs(jax_synthetic.generate(**kw), dirs["jax"], seed=5)
    synthetic.write_raw_csvs(synthetic.generate(**kw), dirs["port"], seed=5)
    for name in ("elliptic_txs_features.csv", "elliptic_txs_classes.csv",
                 "elliptic_txs_edgelist.csv"):
        with open(os.path.join(dirs["jax"], name), "rb") as a, \
                open(os.path.join(dirs["port"], name), "rb") as b:
            assert a.read() == b.read(), name
    outs = []
    for main, sub in ((jax_build_graph.main, "jax"), (build_graph.main, "port")):
        cfg = {"seed": 0, "t_train_end": 3, "t_val_end": 4, "t_max": 6,
               "data_dir": dirs[sub], "processed_dir": str(tmp_path / sub)}
        main(cfg)
        outs.append(cfg["processed_dir"])
    a, b = (np.load(os.path.join(p, "graph.npz")) for p in outs)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_ingest_without_pandas(tmp_path):
    """The port's ingest, both readers, with pandas made unimportable."""
    d = str(tmp_path)
    _fixture(d, "quoted")
    code = (
        "import os, sys\n"
        "sys.modules['pandas'] = None\n"
        "from elliptic_gnn_tpu_torch.graph.ingest import load_elliptic_as_graph\n"
        "from elliptic_gnn_tpu_torch import native\n"
        f"data, meta = load_elliptic_as_graph({d!r})\n"
        "assert data.edge_index.shape == (2, 4), data.edge_index\n"
        "assert native.parse_numeric_csv("
        f"os.path.join({d!r}, 'elliptic_txs_edgelist.csv')) is None\n"
        "assert 'pandas' not in [m.split('.')[0] for m, v in sys.modules.items()"
        " if v is not None]\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
