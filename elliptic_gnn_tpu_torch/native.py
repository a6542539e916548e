"""ctypes bindings for the native host runtime (native/egnn_native.cpp).

The port's own copy of the loader in elliptic_gnn_tpu/native.py: the
numeric CSV parser and the txId mapping of the ingest, the counting-sort
CSR and the BFS renumbering. Builds the shared library on first use when
a toolchain is available (with the in-tree Makefile's flags, renamed into
place whole); every entry point has a numpy/Python fallback (the CSV
parser's is the caller's csv-module reader: it returns None).
`EGNN_NATIVE=0` forces the fallbacks.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LIB_PATH = os.path.join(_REPO_ROOT, "native", "libegnn_native.so")
_SRC_PATH = os.path.join(_REPO_ROOT, "native", "egnn_native.cpp")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    """Compile the library as native/Makefile does, into a file of this
    process's own that is then renamed into place: another process that
    loads the library meanwhile (a parallel test worker, or the JAX
    package's loader, whose `make` writes the library in place) never
    finds a half-written file of ours."""
    tmp = os.path.join(_REPO_ROOT, "build", f"libegnn_native.{os.getpid()}.so")
    cmd = [os.environ.get("CXX", "g++"), "-O3", "-march=native", "-fPIC",
           "-std=c++17", "-shared", "-o", tmp, _SRC_PATH]
    try:
        os.makedirs(os.path.dirname(tmp), exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB_PATH)
    except (OSError, subprocess.SubprocessError):
        return False
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("EGNN_NATIVE", "1") == "0":
        return None
    if not os.path.exists(_LIB_PATH) and not _build():
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        # half-written by another process's `make`: a failure cached here
        # would leave this process on the Python BFS, whose ranks differ
        # from the native ones, for good
        if not _build():
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None

    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f64p = ctypes.POINTER(ctypes.c_double)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.csv_dims.argtypes = [ctypes.c_char_p, i64p, i64p]
    lib.csv_dims.restype = ctypes.c_int
    lib.csv_parse_f64.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                  ctypes.c_int64, f64p]
    lib.csv_parse_f64.restype = ctypes.c_int
    lib.map_ids.argtypes = [i64p, i64p, ctypes.c_int64, i64p,
                            ctypes.c_int64, i64p, u8p]
    lib.map_ids.restype = None
    lib.build_csr.argtypes = [i64p, i64p, ctypes.c_int64, ctypes.c_int64,
                              i64p, i64p, i64p]
    lib.build_csr.restype = None
    lib.bfs_order.argtypes = [i64p, i64p, ctypes.c_int64, ctypes.c_int64, i32p]
    lib.bfs_order.restype = None
    _lib = lib
    return _lib


def is_available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def parse_numeric_csv(path: str) -> Optional[np.ndarray]:
    """Parse a header-less numeric CSV to float64 [rows, cols] (column 0
    may hold txIds of up to 15 digits, exact in f64); None if the native
    lib is unavailable or refuses the file (quoted, ragged or textual
    cells, NaN literals, wider ids): the caller then reads it with the
    csv module (graph/ingest.py)."""
    lib = _load()
    if lib is None:
        return None
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    if lib.csv_dims(path.encode(), ctypes.byref(rows), ctypes.byref(cols)) != 0:
        return None
    out = np.empty((rows.value, cols.value), dtype=np.float64)
    rc = lib.csv_parse_f64(path.encode(), rows.value, cols.value,
                           _ptr(out, ctypes.c_double))
    if rc != 0:
        return None
    return out


def map_ids(tx_ids: np.ndarray, queries: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """txId -> row-index mapping (idx, found); native binary search or
    numpy's searchsorted."""
    lib = _load()
    tx_ids = np.ascontiguousarray(tx_ids, dtype=np.int64)
    queries = np.ascontiguousarray(queries, dtype=np.int64)
    order = np.argsort(tx_ids, kind="stable")
    sorted_ids = np.ascontiguousarray(tx_ids[order])
    if lib is None:
        pos = np.searchsorted(sorted_ids, queries)
        pos = np.clip(pos, 0, sorted_ids.size - 1)
        found = sorted_ids[pos] == queries
        return order[pos], found
    order = order.astype(np.int64)
    out = np.empty(queries.size, dtype=np.int64)
    found = np.empty(queries.size, dtype=np.uint8)
    lib.map_ids(
        _ptr(sorted_ids, ctypes.c_int64), _ptr(order, ctypes.c_int64),
        sorted_ids.size, _ptr(queries, ctypes.c_int64), queries.size,
        _ptr(out, ctypes.c_int64), _ptr(found, ctypes.c_uint8),
    )
    return out, found.astype(bool)


def build_csr(src: np.ndarray, dst: np.ndarray, num_nodes: int):
    """Counting-sort CSR (indptr, col, edge order); native or numpy."""
    lib = _load()
    src = np.ascontiguousarray(src, dtype=np.int64)
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    e = src.size
    if lib is None:
        order = np.argsort(dst, kind="stable")
        col = src[order]
        indptr = np.zeros(num_nodes + 1, dtype=np.int64)
        np.cumsum(np.bincount(dst, minlength=num_nodes), out=indptr[1:])
        return indptr, col, order
    indptr = np.empty(num_nodes + 1, dtype=np.int64)
    col = np.empty(e, dtype=np.int64)
    order = np.empty(e, dtype=np.int64)
    lib.build_csr(
        _ptr(src, ctypes.c_int64), _ptr(dst, ctypes.c_int64), num_nodes, e,
        _ptr(indptr, ctypes.c_int64), _ptr(col, ctypes.c_int64),
        _ptr(order, ctypes.c_int64),
    )
    return indptr, col, order


def bfs_order(src: np.ndarray, dst: np.ndarray, num_nodes: int) -> Optional[np.ndarray]:
    """BFS renumbering rank[old]=new; None -> caller uses the Python BFS."""
    lib = _load()
    if lib is None:
        return None
    src = np.ascontiguousarray(src, dtype=np.int64)
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    rank = np.empty(num_nodes, dtype=np.int32)
    lib.bfs_order(
        _ptr(src, ctypes.c_int64), _ptr(dst, ctypes.c_int64), num_nodes,
        src.size, _ptr(rank, ctypes.c_int32),
    )
    return rank
