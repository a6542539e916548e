#!/usr/bin/env python3
"""A/B of the port's bsda_spmm and gat_fwd kernels on one NVIDIA GPU: the
sources in this checkout against those of another checkout, in one
process, at the launch shapes of the configs (chip_smoke.py's tables).

    python3 -m elliptic_gnn_tpu_torch.kernels.kernel_ab --parent DIR \
        [--shares] [--set NAME:CONSTANT=VALUE,... ...]

DIR holds the other checkout's elliptic_gnn_tpu_torch/kernels/csrc (e.g.
`git archive <commit> | tar -x -C build/parent`, which .gitignore lists).
Every library is built by nvcc into build/torch_ab. Per shape it prints the
CUDA-event medians (L2 flushed) in the order parent, this, this, parent,
whether the two SpMM results are equal bit for bit, and the largest
difference of the two GAT forwards on acc / s and m + log s.

--shares also times copies of the parent's and of this checkout's sources
with parts taken out (text substitutions, below), to show where the time
goes.
--set NAME:CONSTANT=VALUE[,CONSTANT=VALUE...] also builds a copy of this
checkout's sources with those `constexpr int` constants of bsda_edges.cuh
changed (e.g. occ6:kBufBytes=8192,kMinBlocks=6) and times it beside the
default.

Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import shutil
import subprocess
import sys
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT = os.path.join(HERE, "build", "torch_ab")

# parts taken out of the parent's kernels: (source, variant, [(old, new)])
PARENT_SHARES = [
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
]
# and of this checkout's: the kernel stops after a stage, or skips one
THIS_SHARES = [
    ("bsda_spmm", "this_count_only",
     [("  if (!whole) __syncthreads();", "  if (pl.f > 0) return;\n  if (!whole) __syncthreads();")]),
    ("bsda_spmm", "this_list_only",
     [("    fetch(0);\n    int row = 0;", "    if (pl.f > 0) return;\n    fetch(0);\n    int row = 0;")]),
    ("bsda_spmm", "this_no_walk",
     [("      walk_rows(op, row,", "      if (pl.f < 0) walk_rows(op, row,")]),
    ("gat_fwd", "this_list_only",
     [("    fetch(0);\n    int row = r0 + gid;",
       "    if (pl.h > 0) return;\n    fetch(0);\n    int row = r0 + gid;")]),
    ("gat_fwd", "this_no_walk",
     [("      walk_rows(op, row,", "      if (pl.h < 0) walk_rows(op, row,")]),
]


def nvcc(src: str, lib: str, include: str, flags=()) -> subprocess.Popen:
    cmd = ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-shared", "-Xcompiler", "-fPIC", "-I", include, *flags, "-o", lib, src]
    if not any(os.access(os.path.join(p, "nvcc"), os.X_OK)
               for p in os.environ.get("PATH", "").split(os.pathsep)):
        cmd[0] = "/usr/local/cuda/bin/nvcc"
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def retuned_copy(label: str, values: str) -> str:
    """A directory holding this checkout's two sources beside a
    bsda_edges.cuh with constants changed."""
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
    for name in ("bsda_spmm", "gat_fwd"):
        shutil.copy(os.path.join(CSRC, f"{name}.cu"), path)
    return path


def build_all(parent: str, shares: bool, defines) -> dict:
    """{(source, variant): library path}, all compiled in parallel."""
    os.makedirs(OUT, exist_ok=True)
    jobs = {}
    for name in ("bsda_spmm", "gat_fwd"):
        jobs[(name, "this")] = (os.path.join(CSRC, f"{name}.cu"), CSRC, ())
        jobs[(name, "parent")] = (os.path.join(parent, f"{name}.cu"), parent, ())
        for spec in defines:
            label, values = spec.split(":", 1)
            copy = retuned_copy(label, values)
            jobs[(name, f"this_{label}")] = (os.path.join(copy, f"{name}.cu"), copy, ())
    cuts = [(parent, c) for c in PARENT_SHARES] + [(CSRC, c) for c in THIS_SHARES]
    for base, (name, variant, subs) in cuts if shares else []:
        with open(os.path.join(base, f"{name}.cu")) as fh:
            text = fh.read()
        for old, new in subs:
            if old not in text:
                sys.exit(f"{base}/{name}.cu has no {old!r}")
            text = text.replace(old, new)
        path = os.path.join(OUT, f"{name}_{variant}.cu")
        with open(path, "w") as fh:
            fh.write(text)
        jobs[(name, variant)] = (path, base, ())
    procs, libs = {}, {}
    for key, (src, include, flags) in jobs.items():
        libs[key] = os.path.join(OUT, f"lib{key[0]}_{key[1]}.so")
        procs[key] = nvcc(src, libs[key], include, ("-Xptxas=-v",) + tuple(flags))
    failed = []
    for key, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {key}:\n{out}")
        elif key[1] == "this":
            print(out)
    if failed:
        sys.exit("\n".join(failed))
    return libs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True)
    ap.add_argument("--shares", action="store_true")
    ap.add_argument("--set", nargs="*", default=[], dest="retuned")
    args = ap.parse_args()

    import torch

    sys.path.insert(0, HERE)  # chip_smoke.py: the tables, the timer, the gauge
    import chip_smoke as cs
    from . import bsda_spmm_cuda, gat_cuda

    if not torch.cuda.is_available():
        sys.exit("this script needs a GPU")
    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.time()
    paths = build_all(args.parent, args.shares, args.retuned)
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
                for n in ("bsda_spmm", "gat_fwd")}

    def compare(name, label, call, same):
        outs, ms = {}, {}
        for v in ("parent", "this", "this", "parent"):
            use(name, v)
            outs[v] = call()
            ms.setdefault(v, []).append(cs.cuda_ms(call, flush))
        extra = {}
        for v in variants[name]:
            use(name, v)
            extra[v] = cs.cuda_ms(call, flush)
        print(f"{label}: parent {ms['parent'][0]:.4f} {ms['parent'][1]:.4f} ms | this "
              f"{ms['this'][0]:.4f} {ms['this'][1]:.4f} ms | {same(outs['parent'], outs['this'])}"
              + "".join(f" | {v} {t:.4f}" for v, t in extra.items()), flush=True)

    gen = torch.Generator(device=device).manual_seed(0)
    for kind, sym, widths in (("sage", True, (64, 168)), ("gcn", False, (128, 2)),
                              ("sage", False, (128, 167))):
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
                            lambda: bsda_spmm_cuda.bsda_dense_cuda(t, x),
                            lambda a, b: "bit-equal" if torch.equal(a, b) else
                            f"DIFFER by {float((a.float() - b.float()).abs().max()):.3e}")
        del g
    g = cs.elliptic_tables(device, "gat")
    n_pad = g.num_chunks * g.chunk
    for h, ch in ((4, 8), (1, 2)):
        pay = torch.randn((n_pad, gat_cuda.payload_width(h, ch)), generator=gen,
                          device=device)

        def diff(a, b):
            return "max diff val %.3e, m+log s %.3e" % tuple(
                float((p - q).abs().max()) for p, q in zip(
                    cs.gauge_free(a, h, ch, True), cs.gauge_free(b, h, ch, True)))

        compare("gat_fwd", f"gat_fwd h={h} ch={ch}",
                lambda: gat_cuda.gat_fwd_cuda(g, pay, h, ch, 0.2, True), diff)


if __name__ == "__main__":
    main()
