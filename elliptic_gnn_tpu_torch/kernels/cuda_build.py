"""Builds the package's CUDA sources (kernels/csrc/*.cu) with nvcc for
sm_90a into shared libraries with a plain C interface under
<repo>/build/torch_ext; each wrapper opens its library with ctypes.

One library per source, compiled at first use and again when the source
(or a header it includes) is newer than the library. Several sources build
in parallel: one nvcc process each, all started together. There is no
fallback: a missing compiler or a failed build raises.

Span `setup.kernels` around each build (utils/trace.py) and counter
`kernel_builds`, the nvcc processes started: where set-up is slow, a
nonzero count says that nvcc ran.
"""
from __future__ import annotations

import os
import shutil
import subprocess
from typing import Dict, Sequence

from ..utils import trace

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(_PKG_DIR)), "build", "torch_ext")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
# every kernel source of the package, and the headers each includes
SOURCES: Dict[str, Sequence[str]] = {
    "bsda_spmm": ("bsda_edges.cuh",),
    "gat_fwd": ("bsda_edges.cuh",),
    "gat_bwd": ("bsda_edges.cuh",),
    "gat_bwd_dst": ("bsda_edges.cuh",),
    "gat_bwd_src": ("bsda_edges.cuh",),
    "resbn_epilogue": (),
    "egcn_evolve": (),
    "ell_spmm": (),
}


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def _nvcc() -> str:
    path = shutil.which("nvcc")
    home_nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                             "bin", "nvcc")
    if path is None and os.path.exists(home_nvcc):
        path = home_nvcc
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source at first use and need the CUDA toolkit")
    return path


def _stale(name: str, lib_path: str) -> bool:
    if not os.path.exists(lib_path):
        return True
    built = os.path.getmtime(lib_path)
    deps = [source_path(name)] + [os.path.join(CSRC_DIR, h) for h in SOURCES[name]]
    return any(os.path.getmtime(d) > built for d in deps)


def build(names: Sequence[str], verbose: bool = False) -> Dict[str, str]:
    """Compile the named sources that are stale, in parallel, and return
    {name: library path}. With `verbose`, ptxas reports registers, shared
    memory and spills of every kernel, and the output is printed."""
    with trace.span("setup.kernels", names=list(names)):
        return _build(names, verbose)


def _build(names: Sequence[str], verbose: bool) -> Dict[str, str]:
    libs = {n: os.path.join(BUILD_DIR, f"lib{n}.so") for n in names}
    procs = []
    for name, lib_path in libs.items():
        if not _stale(name, lib_path):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS]
        if verbose:
            cmd.append("-Xptxas=-v")
        cmd += ["-o", tmp, source_path(name)]
        procs.append((name, tmp, lib_path, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        trace.count("kernel_builds")
    failed = []
    for name, tmp, lib_path, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) on {name}.cu:\n{out}\n{err}")
            continue
        if verbose:
            print(out + err)
        os.replace(tmp, lib_path)
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs
