#!/usr/bin/env python3
"""A/B of the port's edge-list kernels (bsda_spmm, gat_fwd, gat_bwd,
gat_bwd_src) and of the two-sweep GAT backward as one unit (gat_two_sweep:
the destination and the source sweep) on one NVIDIA GPU: the sources in
this checkout against those of another checkout, in one process, at the
launch shapes of the configs (chip_smoke.py's tables).

    python3 -m elliptic_gnn_tpu_torch.kernels.kernel_ab --parent DIR \
        [--only NAME,...] [--shares] [--set NAME:CONSTANT=VALUE,... ...]

DIR holds the other checkout's elliptic_gnn_tpu_torch/kernels/csrc (e.g.
`git archive <commit> | tar -x -C build/parent`, which .gitignore lists).
Every library is built by nvcc into build/torch_ab. Per shape it prints the
CUDA-event medians (L2 flushed) in the order parent, this, this, parent,
whether the two SpMM results are equal bit for bit, the largest difference
of the two GAT forwards on acc / s and m + log s, and the largest
difference of the two results of each GAT backward. --only limits the run
to the named kernels.

The GAT source sweep reads the transpose tables; a source that walks them
by columns (the design before csrc/bsda_edges.cuh) is given the planes
untransposed, as it was built for. A destination sweep that reads a G2
built beforehand (the design before it wrote G2 itself) is run as it was:
kernels/gat_bwd.py::grad_payload in plain torch, then that sweep, then the
source sweep; the unit compares the whole backward of one layer, and also
times each side's destination sweep alone (the two compute different
things: the older one without G2).

--shares also times copies of both checkouts' sources with parts taken out
(text substitutions, below, chosen by each source's design), to show where
the time goes.
--set NAME:CONSTANT=VALUE[,CONSTANT=VALUE...] also builds a copy of this
checkout's sources with those `constexpr int` constants of bsda_edges.cuh
changed (e.g. occ6:kBufBytes=8192,kMinBlocks=6) and times it beside the
default.

Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import os
import re
import shutil
import subprocess
import sys
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(HERE, "build", "torch_ab")
KERNELS = ("bsda_spmm", "gat_fwd", "gat_bwd", "gat_bwd_src")
UNITS = {"gat_two_sweep": ("gat_bwd_dst", "gat_bwd_src")}  # unit: the libraries it runs

# parts taken out of a kernel: (source, variant, [(old, new)]); STAGED_CUTS
# for the sources that stage the planes in shared memory and walk them by
# ballot (before csrc/bsda_edges.cuh), EDGE_LIST_CUTS for those on it: the
# kernel stops after a stage, or skips one
STAGED_CUTS = [
    ("bsda_spmm", "no_walk",  # planes and x tiles staged, no edge walked
     [("uint32_t nz = __ballot_sync(0xffffffffu, word != 0u);", "uint32_t nz = 0u;")]),
    ("bsda_spmm", "no_x_tile",  # planes staged and walked, no x tile staged
     [("stage_tile<T>(tile, x, ss, src_chunk[b * depth + d], f0, n_rows, f,\n"
       "                  vec16 != 0);", "")]),
    ("bsda_spmm", "planes_only",  # neither: the plane loads and the barriers
     [("uint32_t nz = __ballot_sync(0xffffffffu, word != 0u);", "uint32_t nz = 0u;"),
      ("stage_tile<T>(tile, x, ss, src_chunk[b * depth + d], f0, n_rows, f,\n"
       "                  vec16 != 0);", "")]),
    ("gat_fwd", "no_walk",  # planes staged, outputs written, no edge walked
     [("for_each_edge(planes_sm, src_sm, n_planes,", "for_each_edge(planes_sm, src_sm, 0,")]),
    ("gat_fwd", "no_payload_loads",  # edges walked, no source row fetched
     [("__ldg(p + head[k])", "1.f"), ("__ldg(p + hc + head[k])", "1.f"),
      ("__ldg(p + lane + 32 * k)", "1.f")]),
    ("gat_fwd", "no_pass_1",  # the max pass taken out
     [("if (live[k]) mx[k] = fmaxf(mx[k], __ldg(p + head[k]));",
       "if (live[k]) mx[k] = 0.f;")]),
    ("gat_bwd", "no_walk",  # planes staged, rows begun and ended, no edge walked
     [("for_each_edge(\n        planes_sm, src_sm, n_planes,",
       "for_each_edge(\n        planes_sm, src_sm, 0,")]),
    ("gat_bwd", "no_loads",  # edges walked, no source row read (atomics kept)
     [("__ldg(p + hc + head[k])", "1.f"), ("__ldg(p + lane + 32 * k)", "1.f")]),
    ("gat_bwd_src", "no_walk",  # planes staged, rows begun and stored, no edge walked
     [("for_each_edge_in_column(\n        planes_sm, dst_sm, n_planes,",
       "for_each_edge_in_column(\n        planes_sm, dst_sm, 0,")]),
    ("gat_bwd_src", "no_loads",  # edges walked, no G2 row read
     [("__ldg(d + hc + h + head[k])", "1.f"), ("__ldg(d + hc + 2 * h + head[k])", "1.f"),
      ("__ldg(d + lane + 32 * k)", "1.f"), ("__ldg(d + hc + head[k])", "1.f")]),
]
_GAT_LIST_ONLY = [("    fetch(0);\n    int row = r0 + gid;",
                   "    if (pl.h > 0) return;\n    fetch(0);\n    int row = r0 + gid;")]
_GAT_NO_WALK = [("      walk_rows(op, row,", "      if (pl.h < 0) walk_rows(op, row,")]
EDGE_LIST_CUTS = [
    ("bsda_spmm", "count_only",
     [("  if (!whole) __syncthreads();", "  if (pl.f > 0) return;\n  if (!whole) __syncthreads();")]),
    ("bsda_spmm", "list_only",
     [("    fetch(0);\n    int row = 0;", "    if (pl.f > 0) return;\n    fetch(0);\n    int row = 0;")]),
    ("bsda_spmm", "no_walk",
     [("      walk_rows(op, row,", "      if (pl.f < 0) walk_rows(op, row,")]),
] + [(name, cut, subs) for name in ("gat_fwd", "gat_bwd", "gat_bwd_src")
     for cut, subs in (("list_only", _GAT_LIST_ONLY), ("no_walk", _GAT_NO_WALK))] + [
    ("gat_bwd_src", "no_long_rows",  # the rows the block sums after the walk left out
     [("      if (len > kLongRow)", "      if (pl.h < 0 && len > kLongRow)")]),
    ("gat_bwd_src", "long_16", [("constexpr int kLongRow = 32;", "constexpr int kLongRow = 16;")]),
    ("gat_bwd_src", "long_64", [("constexpr int kLongRow = 32;", "constexpr int kLongRow = 64;")]),
    ("gat_bwd_dst", "list_only", _GAT_LIST_ONLY),
    ("gat_bwd_dst", "no_walk", _GAT_NO_WALK),
]


def on_edge_list(path: str) -> bool:
    """Whether the source at `path` walks bsda_edges.cuh's edge lists."""
    with open(path) as fh:
        return '#include "bsda_edges.cuh"' in fh.read()


def writes_g2(path: str) -> bool:
    """Whether the destination sweep at `path` builds G2 itself (it reads
    gbar) or reads one built beforehand."""
    with open(path) as fh:
        return "gbar" in fh.read()


def g2_reading_dst(lib_path: str):
    """The launch of a destination sweep that reads a prebuilt G2:
    (g, g2, payload, ct, h, ch) -> None, d a_dst written into ct."""
    import torch

    from .bsda_spmm_cuda import kernel_table

    lib = ctypes.CDLL(lib_path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gat_bwd_dst_launch.argtypes = [p] * 6 + [i] * 6 + [ctypes.c_float, p]
    lib.gat_bwd_dst_launch.restype = i

    def run(g, g2, payload, ct, h, ch):
        a, planes, pack = kernel_table(g)
        rc = lib.gat_bwd_dst_launch(
            a.data_ptr(), g.src_chunk.data_ptr(), g.slot_occ.data_ptr(), g2.data_ptr(),
            payload.data_ptr(), ct.data_ptr(), g.num_chunks, g.depth, planes, pack, h,
            ch, 0.2, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            sys.exit(f"gat_bwd_dst ({lib_path}) launch failed: {rc}")

    return run


def nvcc(src: str, lib: str, include: str, flags=()) -> subprocess.Popen:
    cmd = ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-I", include, *flags, "-o", lib, src]
    if not any(os.access(os.path.join(p, "nvcc"), os.X_OK)
               for p in os.environ.get("PATH", "").split(os.pathsep)):
        cmd[0] = "/usr/local/cuda/bin/nvcc"
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def retuned_copy(label: str, values: str, names) -> str:
    """A directory holding this checkout's sources beside a bsda_edges.cuh
    with constants changed."""
    with open(os.path.join(CSRC, "bsda_edges.cuh")) as fh:
        text = fh.read()
    for pair in values.split(","):
        name, value = pair.split("=")
        text, n = re.subn(rf"(constexpr int {name} = )\d+;", rf"\g<1>{int(value)};", text)
        if n != 1:
            sys.exit(f"bsda_edges.cuh has no constexpr int {name}")
    path = os.path.join(OUT, label)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "bsda_edges.cuh"), "w") as fh:
        fh.write(text)
    for name in names:
        shutil.copy(os.path.join(CSRC, f"{name}.cu"), path)
    return path


def build_all(parent: str, names, shares: bool, defines) -> tuple:
    """({(source, variant): library path}, {(source, variant): on the edge
    list}), all compiled in parallel. Variants: "parent", "this", the
    retuned copies "this_<label>", and with `shares` "<side>_<cut>"."""
    os.makedirs(OUT, exist_ok=True)
    jobs = {}
    for name in names:
        jobs[(name, "this")] = (os.path.join(CSRC, f"{name}.cu"), CSRC)
        jobs[(name, "parent")] = (os.path.join(parent, f"{name}.cu"), parent)
        for spec in defines:
            label, values = spec.split(":", 1)
            copy = retuned_copy(label, values, names)
            jobs[(name, f"this_{label}")] = (os.path.join(copy, f"{name}.cu"), copy)
    design = {key: on_edge_list(src) for key, (src, _) in jobs.items()}
    for side, base in (("parent", parent), ("this", CSRC)) if shares else ():
        for name in names:
            edge_list = design[(name, side)]
            for cut_name, cut, subs in EDGE_LIST_CUTS if edge_list else STAGED_CUTS:
                if cut_name != name:
                    continue
                with open(os.path.join(base, f"{name}.cu")) as fh:
                    text = fh.read()
                for old, new in subs:
                    if old not in text:
                        sys.exit(f"{base}/{name}.cu has no {old!r}")
                    text = text.replace(old, new)
                path = os.path.join(OUT, f"{name}_{side}_{cut}.cu")
                with open(path, "w") as fh:
                    fh.write(text)
                jobs[(name, f"{side}_{cut}")] = (path, base)
                design[(name, f"{side}_{cut}")] = edge_list
    procs, libs = {}, {}
    for key, (src, include) in jobs.items():
        libs[key] = os.path.join(OUT, f"lib{key[0]}_{key[1]}.so")
        procs[key] = nvcc(src, libs[key], include, ("-Xptxas=-v",))
    failed = []
    for key, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {key}:\n{out}")
        elif key[1] in ("this", "parent"):
            print(f"ptxas, {key[0]} ({key[1]}):\n{out}")
    if failed:
        sys.exit("\n".join(failed))
    return libs, design


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--only", default=",".join(KERNELS + tuple(UNITS)))
    ap.add_argument("--shares", action="store_true")
    ap.add_argument("--set", nargs="*", default=[], dest="retuned")
    args = ap.parse_args()
    only = args.only.split(",")
    units = [u for u in UNITS if u in only]
    names = [n for n in KERNELS + ("gat_bwd_dst",)
             if n in only or any(n in UNITS[u] for u in units)]

    import torch

    sys.path.insert(0, HERE)  # chip_smoke.py: the tables, the timer, the gauge
    import chip_smoke as cs
    from . import bsda_spmm_cuda, gat_cuda
    from .gat_bwd import grad_payload

    if not torch.cuda.is_available():
        sys.exit("this script needs a GPU")
    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.time()
    paths, design = build_all(args.parent, names, args.shares, args.retuned)
    print(f"built {len(paths)} libraries in {time.time() - t0:.1f} s")

    def use(name, variant):
        """Puts one library behind the package's wrapper."""
        if name == "bsda_spmm":
            bsda_spmm_cuda._lib = None
            saved = bsda_spmm_cuda.cuda_build.load
            bsda_spmm_cuda.cuda_build.load = lambda _n: ctypes.CDLL(paths[(name, variant)])
            bsda_spmm_cuda._load()
            bsda_spmm_cuda.cuda_build.load = saved
        else:
            gat_cuda._libs.pop(name, None)
            saved = gat_cuda.cuda_build.build
            gat_cuda.cuda_build.build = lambda names: {
                n: paths[(name, variant)] for n in names}
            gat_cuda._load(name)
            gat_cuda.cuda_build.build = saved

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    variants = {n: [v for (m, v) in paths if m == n and v not in ("this", "parent")]
                for n in names}

    def timed(label, setup, call, same, extra=()):
        """setup(variant) puts a side's libraries behind the wrappers, then
        call(variant) runs it; prints the CUDA-event medians in the order
        parent, this, this, parent, `same` of the two results, and the times
        of the `extra` (label, setup, fn) triples. No library is swapped
        inside a timed call."""
        outs, ms = {}, {}
        for v in ("parent", "this", "this", "parent"):
            setup(v)
            outs[v] = call(v)
            ms.setdefault(v, []).append(cs.cuda_ms(lambda: call(v), flush))
        times = []
        for k, set_k, fn in extra:
            set_k()
            times.append((k, cs.cuda_ms(fn, flush)))
        print(f"{label}: parent {ms['parent'][0]:.4f} {ms['parent'][1]:.4f} ms | this "
              f"{ms['this'][0]:.4f} {ms['this'][1]:.4f} ms | {same(outs['parent'], outs['this'])}"
              + "".join(f" | {k} {t:.4f}" for k, t in times), flush=True)

    def compare(name, label, call, same):
        """call(edge_list) runs the wrapper with the library in use, given
        whether its source is on the edge list."""
        timed(label, lambda v: use(name, v), lambda v: call(design[(name, v)]), same,
              [(v, lambda v=v: use(name, v), lambda v=v: call(design[(name, v)]))
               for v in variants[name]])
        use(name, "this")

    def max_diff(a, b):
        return f"max diff {float((a.float() - b.float()).abs().max()):.3e}"

    gen = torch.Generator(device=device).manual_seed(0)
    for kind, sym, widths in (("sage", True, (64, 168)), ("gcn", False, (128, 2)),
                              ("sage", False, (128, 167))):
        if "bsda_spmm" not in names:
            break
        g = cs.elliptic_tables(device, kind, symmetrize=sym)
        for f in widths:
            for dtype in (torch.bfloat16, torch.float32):
                x = torch.randn((g.num_nodes, f), generator=gen, device=device).to(dtype)
                for tname, t in (("forward", g), ("transpose", g.transpose)):
                    if tname == "transpose" and dtype == torch.float32:
                        continue
                    compare("bsda_spmm",
                            f"bsda_spmm {kind}{' symmetrized' if sym else ''} {tname} F={f} "
                            f"{str(dtype)[6:]}",
                            lambda _e: bsda_spmm_cuda.bsda_dense_cuda(t, x),
                            lambda a, b: "bit-equal" if torch.equal(a, b) else
                            f"DIFFER by {float((a.float() - b.float()).abs().max()):.3e}")
        del g
    if not any(n.startswith("gat") for n in names):
        return
    g = cs.elliptic_tables(device, "gat")
    n_pad = g.num_chunks * g.chunk
    t_rows = g.transpose  # planes row-oriented: rows = sources
    t_cols = dataclasses.replace(  # the same planes untransposed, for a column walk
        t_rows, a=t_rows.a.transpose(-1, -2).contiguous(),
        a_packed=None if t_rows.a_packed is None
        else t_rows.a_packed.transpose(-1, -2).contiguous())
    for h, ch in ((4, 8), (1, 2)):
        width = gat_cuda.payload_width(h, ch)
        pay = torch.randn((n_pad, width), generator=gen, device=device)
        gbar = torch.randn((n_pad, width), generator=gen, device=device)

        def diff(a, b):
            return "max diff val %.3e, m+log s %.3e" % tuple(
                float((p - q).abs().max()) for p, q in zip(
                    cs.gauge_free(a, h, ch, True), cs.gauge_free(b, h, ch, True)))

        if "gat_fwd" in names:
            compare("gat_fwd", f"gat_fwd h={h} ch={ch}",
                    lambda _e: gat_cuda.gat_fwd_cuda(g, pay, h, ch, 0.2, True), diff)
        out_k = gat_cuda.gat_fwd_cuda(g, pay, h, ch, 0.2, True)
        if "gat_bwd" in names:
            compare("gat_bwd", f"gat_bwd h={h} ch={ch} normalized",
                    lambda _e: gat_cuda.gat_bwd_cuda(g, gbar, pay, out_k, h, ch, 0.2, True),
                    max_diff)
        if "gat_bwd_src" in only:
            g2 = grad_payload(gbar, pay, out_k, h, ch, True)
            compare("gat_bwd_src", f"gat_bwd_src h={h} ch={ch}",
                    lambda edge_list: gat_cuda.gat_bwd_src_cuda(
                        t_rows if edge_list else t_cols, pay, g2, h, ch, 0.2),
                    max_diff)
        if "gat_two_sweep" in units:
            fused = {v: writes_g2(os.path.join(base, "gat_bwd_dst.cu"))
                     for v, base in (("parent", args.parent), ("this", CSRC))}
            old_dst = {v: g2_reading_dst(paths[("gat_bwd_dst", v)])
                       for v in fused if not fused[v]}

            def setup(v):
                use("gat_bwd_src", v)
                if fused[v]:
                    use("gat_bwd_dst", v)

            def dst_alone(v, g2_pre=None):
                """(ct, g2) of side v's destination sweep (its library in
                use); one that reads a prebuilt G2 gets g2_pre, or
                grad_payload's."""
                if fused[v]:
                    return gat_cuda.gat_bwd_dst_cuda(g, gbar, pay, out_k, h, ch, 0.2, True)
                g2 = grad_payload(gbar, pay, out_k, h, ch, True) if g2_pre is None else g2_pre
                ct = torch.empty_like(pay)
                old_dst[v](g, g2, pay, ct, h, ch)
                return ct, g2

            def two_sweep(v):
                ct, g2 = dst_alone(v)
                t = t_rows if design[("gat_bwd_src", v)] else t_cols
                return gat_cuda.gat_bwd_src_cuda(t, pay, g2, h, ch, 0.2, ct=ct)

            g2_pre = grad_payload(gbar, pay, out_k, h, ch, True)
            extra = [("grad_payload", lambda: None,
                      lambda: grad_payload(gbar, pay, out_k, h, ch, True))]
            extra += [(f"dst alone {v} ({'G2 built in' if fused[v] else 'G2 given'})",
                       lambda v=v: setup(v), lambda v=v: dst_alone(v, g2_pre))
                      for v in ("parent", "this")]
            extra += [(f"dst {v}", lambda v=v: use("gat_bwd_dst", v),
                       lambda: gat_cuda.gat_bwd_dst_cuda(g, gbar, pay, out_k, h, ch, 0.2, True))
                      for v in variants["gat_bwd_dst"]]
            timed(f"two-sweep backward of one layer h={h} ch={ch}", setup, two_sweep,
                  max_diff, extra)
            use("gat_bwd_dst", "this")
            use("gat_bwd_src", "this")


if __name__ == "__main__":
    main()
