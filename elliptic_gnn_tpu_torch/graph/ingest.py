"""Elliptic CSV ingestion -> GraphData (port of
elliptic_gnn_tpu/graph/ingest.py, without pandas).

Same behaviour as the JAX package's loader:
  - label mapping {class1/1/illicit -> 1, class2/2/licit -> 0, unknown -> -1}
  - timestep source: classes.csv `time_step`/`timestep` column if present,
    else autodetected from the features CSV's 2nd column via the 1..49
    integer heuristic
  - headerless features CSV: col0 = txId, (col1 = timestep), rest = features
  - edgelist header sniffing ('txId1,txId2' or headerless)
  - edges with unmapped endpoints dropped; intra-timestep edges enforced
The large features CSV goes through the native parser (native.py) when it
is built and accepts the file; every other file, and a features file the
native parser refuses (quoted, textual, NaN literals, ids wider than 15
digits), is read with Python's csv module and numpy: quoted fields, CRLF,
spaces after separators, a missing trailing newline, shuffled or extra
classes columns, and empty or NaN feature cells. txIds are parsed as
Python integers, so 64-bit ids stay exact (the JAX loader's edge list
passes them through float64, which merges ids above 2**53).
"""
from __future__ import annotations

import csv
import os
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np

from .data import GraphData

LABEL_STR_MAP = {
    "class1": 1,
    "1": 1,
    "illicit": 1,
    "class2": 0,
    "2": 0,
    "licit": 0,
    "unknown": -1,
    "-1": -1,
}


def map_labels(values) -> np.ndarray:
    """Label normalization to {-1, 0, 1}."""
    out = np.full(len(values), -1, dtype=np.int32)
    for i, v in enumerate(values):
        s = str(v).strip().lower()
        out[i] = LABEL_STR_MAP.get(s, -1)
    return out


def looks_like_timestep(col: np.ndarray, t_max: int = 49) -> bool:
    """Heuristic: integer-valued column within [1..t_max]."""
    try:
        vals = col.astype(np.float64)
    except (TypeError, ValueError):
        return False
    vals = vals[~np.isnan(vals)]
    if vals.size == 0:
        return False
    return bool(
        vals.min() >= 1
        and vals.max() <= t_max
        and np.mean(np.round(vals) == vals) > 0.95
    )


def _vectorized_tx_to_idx(tx_ids: np.ndarray, queries: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Map txIds -> row indices via binary search (native C++ when built).
    Returns (idx, found_mask)."""
    from ..native import map_ids

    return map_ids(tx_ids, queries)


def _read_rows(path: str) -> List[List[str]]:
    """Every non-empty row of a CSV, cells stripped of surrounding spaces
    (quotes removed, CRLF and a missing final newline accepted)."""
    with open(path, newline="") as fh:
        return [[c.strip() for c in row]
                for row in csv.reader(fh, skipinitialspace=True) if row]


def _int_or_none(s: str) -> Optional[int]:
    """An integer cell, exact at any width; an integral float such as
    '12.0' too; None for anything else (empty, text, NaN, 1.5)."""
    try:
        return int(s)
    except ValueError:
        pass
    try:
        v = float(s)
    except ValueError:
        return None
    return int(v) if np.isfinite(v) and v == int(v) else None


def _int_column(cells: List[str], what: str) -> np.ndarray:
    out = [_int_or_none(c) for c in cells]
    bad = [c for c, v in zip(cells, out) if v is None]
    if bad:
        raise ValueError(f"{what}: non-integer value {bad[0]!r}")
    return np.array(out, dtype=np.int64)


def _float_matrix(rows: List[List[str]]) -> np.ndarray:
    """float64 of string cells; empty cells are NaN."""
    arr = np.array(rows, dtype=str).reshape(len(rows), -1)
    arr[arr == ""] = "nan"
    return arr.astype(np.float64)


def _rectangular(rows: List[List[str]], path: str) -> List[List[str]]:
    """Rows padded with empty cells to the first row's width; a longer row
    raises (the header-less reading of the JAX package's CSV reader)."""
    width = len(rows[0]) if rows else 0
    for i, r in enumerate(rows):
        if len(r) > width:
            raise ValueError(f"{path}: row {i + 1} has {len(r)} fields, "
                             f"expected {width}")
    return [r + [""] * (width - len(r)) for r in rows]


def _read_classes(path: str):
    """(txIds, labels, timesteps or None) of classes.csv (with header)."""
    rows = _read_rows(path)
    if not rows:
        raise ValueError(f"{path} is empty")
    header = [str(c).strip() for c in rows[0]]
    body = _rectangular(rows[1:], path) if len(rows) > 1 else []
    cols = {}
    for i, name in enumerate(header):
        cols.setdefault(name, i)

    def find(exact: str, prefix: str) -> Optional[int]:
        if exact in cols:
            return cols[exact]
        for name in header:
            if name.lower().startswith(prefix):
                return cols[name]
        return None

    tx_col = find("txId", "tx")
    cls_col = find("class", "class")
    if tx_col is None or cls_col is None:
        raise KeyError(f"{path}: no txId or class column in header {header}")
    ts_col = cols.get("time_step", cols.get("timestep"))
    tx = _int_column([r[tx_col] for r in body], "classes txId")
    labels = map_labels([r[cls_col] for r in body])
    ts = None if ts_col is None else _int_column([r[ts_col] for r in body],
                                                 "classes timestep")
    return tx, labels, ts


def _read_features(path: str):
    """(txIds int64, every other column float64) of the header-less
    features CSV: the native parser where it accepts the file, else the
    csv module."""
    from ..native import parse_numeric_csv

    raw = parse_numeric_csv(path)
    # accept the native parse only when column 0 is a plausible id column
    # (finite integers); the native parser returns None on quoted, ragged or
    # textual content and on ids of more than 15 digits
    if (
        raw is not None and raw.shape[1] >= 2
        and np.isfinite(raw[:, 0]).all()
        and (np.mod(raw[:, 0], 1) == 0).all()
    ):
        return raw[:, 0].astype(np.int64), raw[:, 1:]
    rows = _rectangular(_read_rows(path), path)
    if not rows or len(rows[0]) < 2:
        raise ValueError("features CSV malformed (needs >= txId + 1 column)")
    return (_int_column([r[0] for r in rows], "features txId"),
            _float_matrix([r[1:] for r in rows]))


def _is_number(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def _edge_has_header(path: str) -> bool:
    """The first line is a header when one of its cells is not a number."""
    with open(path, "r") as fh:
        first = fh.readline()
    cells = [c.strip().strip('"').strip("'")
             for c in first.replace("\r", "").split(",")]
    return len(cells) >= 2 and not all(_is_number(c) for c in cells)


def _read_edges(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """(src txIds, dst txIds) int64 of the edgelist; rows whose ends are
    not integers are dropped."""
    rows = _read_rows(path)
    src_col, dst_col = 0, 1
    if rows and _edge_has_header(path):
        header = rows[0]
        if "txId1" in header and "txId2" in header:
            src_col, dst_col = header.index("txId1"), header.index("txId2")
        rows = rows[1:]
    src, dst = [], []
    for r in rows:
        a = _int_or_none(r[src_col]) if len(r) > src_col else None
        b = _int_or_none(r[dst_col]) if len(r) > dst_col else None
        if a is not None and b is not None:
            src.append(a)
            dst.append(b)
    return np.array(src, dtype=np.int64), np.array(dst, dtype=np.int64)


def load_elliptic_as_graph(
    data_dir: str,
    features_csv: str = "elliptic_txs_features.csv",
    classes_csv: str = "elliptic_txs_classes.csv",
    edgelist_csv: str = "elliptic_txs_edgelist.csv",
) -> Tuple[GraphData, Dict]:
    """Parse the three raw CSVs into a GraphData + meta dict."""
    f_path = os.path.join(data_dir, features_csv)
    c_path = os.path.join(data_dir, classes_csv)
    e_path = os.path.join(data_dir, edgelist_csv)

    cls_tx, cls_label, cls_ts = _read_classes(c_path)
    has_cls_ts = cls_ts is not None

    feat_tx, cols = _read_features(f_path)
    feat_has_ts = looks_like_timestep(cols[:, 0])
    if feat_has_ts:
        feat_ts = cols[:, 0].astype(np.int64)
        x = cols[:, 1:].astype(np.float32)
    else:
        feat_ts = None
        x = cols.astype(np.float32)

    n = feat_tx.size

    # ---- timestep source resolution (classes preferred, then features) ----
    if has_cls_ts:
        ts_source = "CLASSES"
        idx, found = _vectorized_tx_to_idx(feat_tx, cls_tx)
        timestep = np.zeros(n, dtype=np.int64)
        timestep[idx[found]] = cls_ts[found]
        if not found.all():
            warnings.warn("some classes.csv txIds not present in features.csv")
        if feat_has_ts:
            missing = timestep == 0
            timestep[missing] = feat_ts[missing]
        n_unresolved = int((timestep == 0).sum())
        if n_unresolved:
            warnings.warn(
                f"{n_unresolved} feature rows missing from classes.csv keep "
                "timestep=0 (outside 1..T); they are unlabeled but feed t=0 "
                "into time embeddings and message passing."
            )
    elif feat_has_ts:
        ts_source = "FEATURES"
        timestep = feat_ts.copy()
    else:
        raise ValueError(
            "No timestep column found in classes and features did not contain "
            "a valid timestep column (expected classes 'time_step'/'timestep' "
            "or features col 2 in 1..49)."
        )
    print(f"[TS] using timestep from: {ts_source}")

    # ---- labels joined onto feature rows (unlabeled -> -1) ----
    y = np.full(n, -1, dtype=np.int32)
    idx, found = _vectorized_tx_to_idx(feat_tx, cls_tx)
    y[idx[found]] = cls_label[found]

    # ---- edges: header sniff, id mapping, intra-timestep filter ----
    e_src, e_dst = _read_edges(e_path)
    edges_total = e_src.size

    src_idx, src_found = _vectorized_tx_to_idx(feat_tx, e_src)
    dst_idx, dst_found = _vectorized_tx_to_idx(feat_tx, e_dst)
    keep = src_found & dst_found
    src_idx, dst_idx = src_idx[keep], dst_idx[keep]
    n_mapped = int(keep.sum())
    if n_mapped == 0 and edges_total > 0:
        warnings.warn(
            "No edges mapped to known txIds. If testing with a partial "
            "features CSV this is expected."
        )

    same_t = timestep[src_idx] == timestep[dst_idx]
    src_idx, dst_idx = src_idx[same_t], dst_idx[same_t]
    edge_index = np.stack([src_idx, dst_idx]).astype(np.int32)

    print(
        f"[EDGES] total_in_csv={edges_total} mapped={n_mapped} "
        f"same_t={int(same_t.sum())} kept_in_graph={edge_index.shape[1]}"
    )

    data = GraphData(
        x=x.astype(np.float32),
        y=y,
        timestep=timestep.astype(np.int32),
        edge_index=edge_index,
    )
    meta = data.meta()
    meta["timestep_source"] = ts_source
    return data, meta
