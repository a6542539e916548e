#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (elliptic_gnn_tpu_torch) on one
NVIDIA GPU. Run from the repository root:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. device: the card's name and power limit;
  2. build: compiles the five kernel sources of kernels/csrc with nvcc, in
     parallel, and prints what ptxas says of each kernel;
  3. BSDA kernel vs plain: on the Elliptic-scale synthetic graph (203,769
     nodes, 234,355 edges before symmetrization, 166 features, 49 timesteps,
     seed 0), the kernel's dense output against its plain PyTorch version
     for the forward (dst scale) and transpose (src scale) tables, the
     bit-packed (pack 4) and int8 (pack 1) tables, at F=168 f32, F=168 bf16
     and F=64 bf16; CUDA-event medians of kernel, plain version and the
     torch.sparse yardstick; then on the same graph directed, the GCN
     tables (self-looped, dst and src scales together) at F=128 and F=2 and
     the SAGE tables at F=167 and F=128, bf16, kernel against plain version;
     every launch shape twice, the two results equal bit for bit; one line
     per shape with kernel, bound and library ms and their ratios;
  4. GAT kernels vs plain: on the same graph, directed and self-looped,
     depth 4: the forward at (h, ch) = (4, 8) with the slot cover and
     (1, 2) without, normalize on and off, compared on val = acc / s and
     m + log s; the backward in both gauges against the closed form; two
     runs of the same backward against each other (atomics); the two-sweep
     backward (destination sweep over the forward tables, source sweep over
     the transpose tables): each sweep against its plain version, their sum
     against the one-sweep kernel, two launches of each bit for bit equal;
     the BSDA and GAT forward kernels on a 700-node graph with a hub chunk
     of thousands of dense edges and an empty chunk, against their plain
     versions and twice, bit for bit;
     one training step of the gat.yaml model through the kernels, with the
     one-sweep and with the two-sweep backward, against its plain version,
     gradients and times; and on a 6,000-node graph with a spill,
     the backward through the packed attend against autograd through the
     plain formulation;
  5. small-graph references: SAGE-ResBN, GCN, SAGE and GAT logits on the
     card (kernels) against the same weights on the CPU (plain versions);
  6. slices: builds the same graph with the port's build_graph, then runs
     train_gnn.main on the values of configs/rec_k8.yaml, gat.yaml, gcn.yaml
     and sage.yaml at full width for a few epochs each, with the launch
     counts set to 0 just before and read just after: every epoch must have
     gone through the kernels, losses and scores must be finite, the
     artifacts and best.ckpt present; predict.predict on the GAT run dir
     must reproduce its scores_test.npy; gat.yaml again, twice, with the
     two-sweep backward chosen (EGNN_GAT_ONE_SWEEP=0): only the two sweeps
     may run the backward, the two runs' scores_test.npy must be equal bit
     for bit, and loss and val PR-AUC per epoch must agree with the
     one-sweep run (loss rtol 1e-4, PR-AUC atol 2e-3);
  7. profile: the runs for 3 epochs under torch.profiler, device time by
     kernel name;
  8. prints the table of TPU kernels, the kernel line, the card line, and
     the result line {"ok": true, "device": {...}}.

Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_NODES = 203769
N_EDGES = 234355
EPOCHS = 5
PROFILE_EPOCHS = 3
TIMING_ITERS = 20
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
PEAK_OPS = {"float32": 67e12,        # CUDA-core f32
            "bfloat16": 989e12}      # dense bf16 tensor cores
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=1 / 64, atol=1e-3)}
# GAT runs in f32: forward on the gauge-free val and m + log s (expf on the
# card against torch.exp, sums in another order); backward with atomics
GAT_FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GAT_BWD_TOL = dict(rtol=5e-4, atol=5e-5)
CSRC = "elliptic_gnn_tpu_torch/kernels/csrc/"
TPU_KERNELS = [
    ("elliptic_gnn_tpu/kernels/pallas_bsda.py:218", "_ring_call", CSRC + "bsda_spmm.cu"),
    ("elliptic_gnn_tpu/kernels/pallas_bsda.py:124", "_banded_call", CSRC + "bsda_spmm.cu"),
    ("elliptic_gnn_tpu/kernels/pallas_gat.py:103", "_flash_gat_call", CSRC + "gat_fwd.cu"),
    ("elliptic_gnn_tpu/kernels/pallas_gat.py:247", "_flash_gat_call_gated",
     CSRC + "gat_fwd.cu"),
    ("elliptic_gnn_tpu/kernels/pallas_gat_bwd.py:326", "_sweep_fused_call",
     CSRC + "gat_bwd.cu"),
    ("elliptic_gnn_tpu/kernels/pallas_gat_bwd.py:63", "_sweep_dst_call",
     CSRC + "gat_bwd_dst.cu"),
    ("elliptic_gnn_tpu/kernels/pallas_gat_bwd.py:181", "_sweep_src_call",
     CSRC + "gat_bwd_src.cu"),
]
# the two-sweep run against the one-sweep run of the same config, per epoch
TWO_SWEEP_LOSS_RTOL = 1e-4
TWO_SWEEP_PR_ATOL = 2e-3


def fail(msg: str) -> None:
    print(f"[SMOKE] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[SMOKE] {msg}", flush=True)


def cuda_ms(fn, flush_buf) -> float:
    """Median CUDA-event time of fn() in ms; L2 flushed before each launch."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMING_ITERS):
        flush_buf.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


@contextlib.contextmanager
def two_sweep_backward():
    """Chooses the bit-reproducible two-sweep GAT backward, as a user does."""
    os.environ["EGNN_GAT_ONE_SWEEP"] = "0"
    try:
        yield
    finally:
        del os.environ["EGNN_GAT_ONE_SWEEP"]


def elliptic_tables(device, kind, symmetrize=None):
    """The Elliptic-scale synthetic graph's main-path tables on `device`:
    depth 3 with transpose for 'sage' and 'gcn', symmetrized for rec_k8 and
    directed (`symmetrize` False) for gcn.yaml and sage.yaml; directed,
    self-looped, depth 4 for 'gat' (gat.yaml), with the transpose tables
    the two-sweep backward walks."""
    from elliptic_gnn_tpu_torch.graph import synthetic
    from elliptic_gnn_tpu_torch.graph.transform import symmetrize_edges
    from elliptic_gnn_tpu_torch.kernels.bsda import bfs_order, build_bsda_for_kind

    data = synthetic.generate(
        num_nodes=N_NODES, num_features=166, num_timesteps=49,
        avg_degree=N_EDGES / N_NODES, seed=0)
    if kind == "sage" if symmetrize is None else symmetrize:
        data = symmetrize_edges(data)
    data = data.renumber(bfs_order(data.edge_index, data.num_nodes, data.timestep))
    g = build_bsda_for_kind(data.edge_index, data.num_nodes, kind,
                            depth=4 if kind == "gat" else 3, a_dtype="int8",
                            transpose=True)
    return g.to(device)


def within(got, want, tol) -> bool:
    return bool(((got - want).abs() <= tol["atol"] + tol["rtol"] * want.abs()).all())


def sparse_yardstick(g, x):
    """torch.sparse CSR of the same dense-part weights: one library call
    computing the kernel's function (timed only, never used by the port)."""
    import torch

    a = g.a  # [B, D, C, C] int8 multiplicities
    b_idx, d_idx, i_idx, j_idx = torch.nonzero(a, as_tuple=True)
    rows = b_idx * g.chunk + i_idx
    cols = g.src_chunk.long()[b_idx, d_idx] * g.chunk + j_idx
    vals = a[b_idx, d_idx, i_idx, j_idx].float()
    if g.dst_scale is not None:
        vals = vals * g.dst_scale[rows]
    if g.src_scale is not None:
        vals = vals * g.src_scale[cols]
    n = x.shape[0]
    keep = (rows < n) & (cols < n)
    coo = torch.sparse_coo_tensor(
        torch.stack([rows[keep], cols[keep]]), vals[keep].to(x.dtype),
        (n, n)).coalesce()
    return coo.to_sparse_csr(), int(keep.sum())


def kernel_phase(device, flush_buf):
    import torch

    from elliptic_gnn_tpu_torch.kernels import bsda, bsda_spmm_cuda

    t0 = time.time()
    g = elliptic_tables(device, "sage")
    log(f"tables built in {time.time() - t0:.1f} s: chunks={g.num_chunks} "
        f"depth={g.depth} pack={g.a_pack} max_chunk_dist={g.max_chunk_dist}")
    gen = torch.Generator(device=device).manual_seed(0)
    results = {}
    failures = []
    for table_name, table in (("forward", g), ("transpose", g.transpose)):
        for pack in (4, 1):
            t = table if pack == 4 else dataclasses.replace(
                table, a_packed=None, a_pack=1)
            for f, dtype in ((168, torch.float32), (168, torch.bfloat16),
                             (64, torch.bfloat16)):
                dname = str(dtype).replace("torch.", "")
                x = torch.randn((g.num_nodes, f), generator=gen, device=device).to(dtype)
                got = bsda_spmm_cuda.bsda_dense_cuda(t, x)
                same = torch.equal(got, bsda_spmm_cuda.bsda_dense_cuda(t, x))
                torch.cuda.synchronize()
                want = bsda.bsda_dense_plain(t, x)
                diff = (got.float() - want.float()).abs()
                max_abs = float(diff.max())
                max_rel = float((diff / want.float().abs().clamp_min(1e-6)).max())
                tol = TOL[dname]
                ok = same and bool(
                    (diff <= tol["atol"] + tol["rtol"] * want.float().abs()).all())
                ms = cuda_ms(lambda: bsda_spmm_cuda.bsda_dense_cuda(t, x), flush_buf)
                plain_ms = cuda_ms(lambda: bsda.bsda_dense_plain(t, x), flush_buf)
                case = f"{table_name} pack={pack} F={f} {dname}"
                log(f"kernel vs plain [{case}]: max_abs={max_abs:.3e} "
                    f"max_rel={max_rel:.3e} (tol rtol={tol['rtol']:.3g} "
                    f"atol={tol['atol']:.3g}) {'ok' if ok else 'MISMATCH'}, two launches "
                    f"{'bit-equal' if same else 'DIFFER'} | "
                    f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
                if not ok:
                    failures.append(case)
                results[(table_name, pack, f, dname)] = dict(
                    max_abs=max_abs, ms=ms, plain_ms=plain_ms, x=x, table=t)
    if failures:
        fail(f"kernel disagrees with its plain version: {failures}")

    # per TPU variant, the main path's shape on the forward tables, pack 4:
    # layer 1 (F = 166 + 2 = 168) stands for _banded_call, layers 2-3
    # (F = 64) for _ring_call; bf16 under amp
    entries = {}
    for variant, f in (("banded", 168), ("ring", 64)):
        r = results[("forward", 4, f, "bfloat16")]
        entries[variant] = spmm_entry(f"{variant} (F={f} bf16, forward tables)",
                                      r["table"], r["x"], r, flush_buf)
    return entries


def spmm_entry(label, t, x, r, flush_buf):
    """Kernel-line numbers of one bf16 launch shape of the BSDA kernel on
    the bit-packed tables `t`: r's measured error and times, the bound from
    this call's bytes (planes, src_chunk, the scale vectors present, x read
    and the output written once) and nonzeros, and the torch.sparse.mm
    yardstick on the same weights."""
    import torch

    f = x.shape[1]
    csr, nnz = sparse_yardstick(t, x)
    try:
        library_ms = cuda_ms(lambda: torch.sparse.mm(csr, x), flush_buf)
    except RuntimeError as exc:  # no bf16 sparse product on this build
        log(f"torch.sparse.mm yardstick unavailable for bf16: {exc}")
        library_ms = None
    del csr
    scales = [v for v in (t.dst_scale, t.src_scale) if v is not None]
    bytes_moved = (t.a_packed.numel() + t.src_chunk.numel() * 4
                   + sum(v.numel() * 4 for v in scales)
                   + 2 * x.numel() * x.element_size())
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = 2.0 * nnz * f / PEAK_OPS["bfloat16"] * 1e3
    entry = dict(
        max_abs_err=r["max_abs"], ms=r["ms"], plain_ms=r["plain_ms"],
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=library_ms, bytes=bytes_moved, nnz=nnz, f=f)
    log(f"{label}: bytes={bytes_moved} nnz={nnz} bound={entry['bound_ms']:.4f} ms "
        f"({entry['bound_by']}) kernel={r['ms']:.4f} ms plain={r['plain_ms']:.4f} ms "
        f"library={library_ms if library_ms is None else f'{library_ms:.4f}'} ms | "
        f"kernel / bound {r['ms'] / entry['bound_ms']:.2f}, kernel / library "
        + ("n/a" if library_ms is None else f"{r['ms'] / library_ms:.2f}"))
    return entry


def arch_kernel_phase(device, flush_buf):
    """The BSDA kernel at the launch shapes of gcn.yaml (self-looped
    directed tables with dst and src scales together; F = 128 and the F = 2
    logits) and sage.yaml (directed tables; F = 167 and 128), bf16 under
    amp, forward and transpose tables against the plain version. Returns
    the kernel-line entries by (kind, F), timed on the forward tables."""
    import torch

    from elliptic_gnn_tpu_torch.kernels import bsda, bsda_spmm_cuda

    gen = torch.Generator(device=device).manual_seed(3)
    tol = TOL["bfloat16"]
    entries, failures = {}, []
    for kind, widths in (("gcn", (128, 2)), ("sage", (167, 128))):
        g = elliptic_tables(device, kind, symmetrize=False)
        scales = "+".join(n for n in ("dst_scale", "src_scale")
                          if getattr(g, n) is not None)
        log(f"{kind} tables (directed): chunks={g.num_chunks} depth={g.depth} "
            f"pack={g.a_pack} scales={scales}")
        for f in widths:
            x = torch.randn((g.num_nodes, f), generator=gen,
                            device=device).to(torch.bfloat16)
            errs = []
            for table in (g, g.transpose):
                got = bsda_spmm_cuda.bsda_dense_cuda(table, x)
                same = torch.equal(got, bsda_spmm_cuda.bsda_dense_cuda(table, x))
                torch.cuda.synchronize()
                want = bsda.bsda_dense_plain(table, x)
                diff = (got.float() - want.float()).abs()
                errs.append(float(diff.max()))
                if not same or not bool(
                        (diff <= tol["atol"] + tol["rtol"] * want.float().abs()).all()):
                    failures.append(f"{kind} F={f}{'' if same else ' (two launches differ)'}")
            r = dict(max_abs=max(errs),
                     ms=cuda_ms(lambda: bsda_spmm_cuda.bsda_dense_cuda(g, x), flush_buf),
                     plain_ms=cuda_ms(lambda: bsda.bsda_dense_plain(g, x), flush_buf))
            log(f"kernel vs plain [{kind} F={f} bf16, {scales}]: max_abs forward "
                f"{errs[0]:.3e}, transpose {errs[1]:.3e} (tol rtol={tol['rtol']:.3g} "
                f"atol={tol['atol']:.3g})")
            entries[(kind, f)] = spmm_entry(
                f"{kind}.yaml shape F={f} bf16, forward tables", g, x, r, flush_buf)
        del g
    if failures:
        fail(f"BSDA kernel disagrees with its plain version: {failures}")
    return entries


def gauge_free(out, h, ch, normalized):
    """(val = acc / s, m + log s) of packed [ acc | m | s ] rows: what does
    not depend on the softmax shift an implementation chose."""
    hc = h * ch
    acc = out[:, :hc].reshape(-1, h, ch)
    m, s = out[:, hc: hc + h], out[:, hc + h: hc + 2 * h]
    val = acc if normalized else acc / s.clamp_min(1e-16)[..., None]
    return val, m + s.clamp_min(1e-30).log()


def gat_kernel_phase(device, flush_buf):
    """The two GAT kernels against their plain versions at the main path's
    shapes; returns the kernel-line entries by name."""
    import torch

    from elliptic_gnn_tpu_torch.kernels import gat_cuda
    from elliptic_gnn_tpu_torch.kernels.bsda_spmm_cuda import kernel_table

    t0 = time.time()
    g = elliptic_tables(device, "gat")
    nnz = int(g.a.sum())
    n_pad = g.num_chunks * g.chunk
    plane_bytes = g.chunk * g.chunk
    _, planes, pack = kernel_table(g)  # the bytes the kernels read
    planes_all = g.num_chunks * planes
    planes_occ = int(((g.slot_occ + pack - 1) // pack).sum())
    log(f"GAT tables built in {time.time() - t0:.1f} s: chunks={g.num_chunks} "
        f"depth={g.depth} pack={pack} dense edges (with multiplicity)={nnz} "
        f"spill rows={0 if g.residual is None else g.residual.num_nodes} "
        f"planes read: {planes_occ} with the slot cover, {planes_all} without")
    gen = torch.Generator(device=device).manual_seed(0)
    failures, entries = [], {}

    def bound(n_planes, columns, flops, gated=True):
        """`columns`: f32 columns per node row over every input and output
        the kernel must touch; the slot cover only where it is passed."""
        bytes_moved = (n_planes * plane_bytes + g.src_chunk.numel() * 4
                       + (g.slot_occ.numel() * 4 if gated else 0)
                       + n_pad * columns * 4)
        bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / PEAK_OPS["float32"] * 1e3
        return dict(bound_ms=max(bytes_ms, ops_ms), bytes=bytes_moved,
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations")

    for h, ch in ((4, 8), (1, 2)):
        width = gat_cuda.payload_width(h, ch)
        gated = h >= 2  # the wrapper's dispatch, as the TPU package's
        pay = torch.randn((n_pad, width), generator=gen, device=device)
        gbar = torch.randn((n_pad, width), generator=gen, device=device)
        fwd_name = f"gat_fwd[h={h}{' gated' if gated else ''}]"
        for normalize in (True, False):
            got = gat_cuda.gat_fwd_cuda(g, pay, h, ch, 0.2, normalize)
            same = torch.equal(got, gat_cuda.gat_fwd_cuda(g, pay, h, ch, 0.2, normalize))
            torch.cuda.synchronize()
            want = gat_cuda.gat_fwd_plain(g, pay, h, ch, 0.2, normalize)
            errs = []
            ok = same and bool(torch.isfinite(got).all())
            for a, b in zip(gauge_free(got, h, ch, normalize),
                            gauge_free(want, h, ch, normalize)):
                errs.append(float((a - b).abs().max()))
                ok = ok and within(a, b, GAT_FWD_TOL)
            ms = cuda_ms(lambda: gat_cuda.gat_fwd_cuda(g, pay, h, ch, 0.2, normalize),
                         flush_buf)
            plain_ms = cuda_ms(
                lambda: gat_cuda.gat_fwd_plain(g, pay, h, ch, 0.2, normalize), flush_buf)
            case = f"{fwd_name} normalize={normalize}"
            log(f"kernel vs plain [{case}]: max_abs val={errs[0]:.3e} "
                f"m+log s={errs[1]:.3e} (tol rtol={GAT_FWD_TOL['rtol']:.3g} "
                f"atol={GAT_FWD_TOL['atol']:.3g}) {'ok' if ok else 'MISMATCH'}, two "
                f"launches {'bit-equal' if same else 'DIFFER'} | "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            if not ok:
                failures.append(case)
            if normalize:  # the main path normalizes in the kernel
                entries[fwd_name] = dict(
                    max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                    **bound(planes_occ if gated else planes_all, 2 * width,
                            2.0 * nnz * h * ch, gated))

            out_k = got
            ct = gat_cuda.gat_bwd_cuda(g, gbar, pay, out_k, h, ch, 0.2, normalize)
            torch.cuda.synchronize()
            want = gat_cuda.gat_bwd_plain(g, gbar, pay, out_k, h, ch, 0.2, normalize)
            err = float((ct - want).abs().max())
            ok = bool(torch.isfinite(ct).all()) and within(ct, want, GAT_BWD_TOL)
            again = gat_cuda.gat_bwd_cuda(g, gbar, pay, out_k, h, ch, 0.2, normalize)
            hc = h * ch
            rerun = float((ct - again)[:, : hc + h].abs().max())
            rerun_dst = float((ct - again)[:, hc + h:].abs().max())
            ms = cuda_ms(lambda: gat_cuda.gat_bwd_cuda(
                g, gbar, pay, out_k, h, ch, 0.2, normalize), flush_buf)
            plain_ms = cuda_ms(lambda: gat_cuda.gat_bwd_plain(
                g, gbar, pay, out_k, h, ch, 0.2, normalize), flush_buf)
            case = f"gat_bwd[h={h}] normalized={normalize}"
            log(f"kernel vs closed form [{case}]: max_abs={err:.3e} (tol rtol="
                f"{GAT_BWD_TOL['rtol']:.3g} atol={GAT_BWD_TOL['atol']:.3g}) "
                f"{'ok' if ok else 'MISMATCH'} | two runs differ by {rerun:.3e} in "
                f"d xp, d a_src (atomics) and {rerun_dst:.3e} in d a_dst | "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            if not ok or rerun_dst != 0.0:
                failures.append(case)
            if normalize:
                entries[f"gat_bwd[h={h}]"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, rerun_diff=rerun,
                    # gbar without its h m-columns, which the kernel never
                    # reads; payload, out_k and the output in full
                    **bound(planes_occ, 4 * width - h, 6.0 * nnz * h * ch))
        del pay, gbar, got, want, ct, again, out_k
    if failures:
        fail(f"GAT kernel disagrees with its plain version: {failures}")
    for name, e in entries.items():
        log(f"{name}: bytes={e['bytes']} bound={e['bound_ms']:.4f} ms "
            f"({e['bound_by']}) kernel={e['ms']:.4f} ms plain={e['plain_ms']:.4f} ms "
            "library=none (no single PyTorch call computes this function) | "
            f"kernel / bound {e['ms'] / e['bound_ms']:.2f}")
    return entries, g


def gat_two_sweep_phase(device, flush_buf, g):
    """The two-sweep backward at the main path's shapes: the destination
    sweep over the forward tables `g` and the source sweep over g.transpose,
    each against its plain version on the same G2, their sum against the
    one-sweep kernel, two launches of each bit for bit; returns the
    kernel-line entries by name."""
    import torch

    from elliptic_gnn_tpu_torch.kernels import gat_cuda
    from elliptic_gnn_tpu_torch.kernels.bsda_spmm_cuda import kernel_table
    from elliptic_gnn_tpu_torch.kernels.gat_bwd import grad_payload

    t = g.transpose
    nnz = int(g.a.sum())
    n_pad = g.num_chunks * g.chunk
    plane_bytes = g.chunk * g.chunk
    planes_read = {}
    for name, tab in (("dst", g), ("src", t)):
        a, _, pack = kernel_table(tab)
        planes_read[name] = int(((tab.slot_occ + pack - 1) // pack).sum())
        log(f"two-sweep tables [{name}]: depth={tab.depth} pack={pack} table bytes "
            f"{a.numel()} mean slot cover {float(tab.slot_occ.float().mean()):.3f} "
            f"max {int(tab.slot_occ.max())} planes read {planes_read[name]} "
            f"({planes_read[name] * plane_bytes} bytes) max_chunk_dist={tab.max_chunk_dist}")
    if int(t.a.sum()) != nnz:
        fail("the transpose tables do not hold the forward tables' edges")

    def bound(n_planes, columns, flops):
        bytes_moved = (n_planes * plane_bytes + g.src_chunk.numel() * 4
                       + g.slot_occ.numel() * 4 + n_pad * columns * 4)
        bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / PEAK_OPS["float32"] * 1e3
        return dict(bound_ms=max(bytes_ms, ops_ms), bytes=bytes_moved,
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations")

    gen = torch.Generator(device=device).manual_seed(5)
    failures, entries = [], {}
    for h, ch in ((4, 8), (1, 2)):
        hc, width = h * ch, gat_cuda.payload_width(h, ch)
        pay = torch.randn((n_pad, width), generator=gen, device=device)
        gbar = torch.randn((n_pad, width), generator=gen, device=device)
        for normalized in (True, False):
            out_k = gat_cuda.gat_fwd_cuda(g, pay, h, ch, 0.2, normalized)
            g2 = grad_payload(gbar, pay, out_k, h, ch, normalized)

            def dst():
                return gat_cuda.gat_bwd_dst_cuda(g, g2, pay, h, ch, 0.2)

            def src():
                return gat_cuda.gat_bwd_src_cuda(t, pay, g2, h, ch, 0.2)

            d_dst, d_src = dst(), src()
            torch.cuda.synchronize()
            want_dst = gat_cuda.gat_bwd_dst_plain(g, g2, pay, h, ch, 0.2)
            want_src = gat_cuda.gat_bwd_src_plain(t, pay, g2, h, ch, 0.2)
            one = gat_cuda.gat_bwd_cuda(g, gbar, pay, out_k, h, ch, 0.2, normalized)
            err_dst = float((d_dst - want_dst).abs().max())
            err_src = float((d_src - want_src).abs().max())
            err_one = float((d_dst + d_src - one).abs().max())
            own_columns = not bool(d_dst[:, : hc + h].any() or d_src[:, hc + h:].any())
            same = torch.equal(d_dst, dst()) and torch.equal(d_src, src())
            ok = (bool(torch.isfinite(d_dst).all() and torch.isfinite(d_src).all())
                  and within(d_dst, want_dst, GAT_BWD_TOL)
                  and within(d_src, want_src, GAT_BWD_TOL)
                  and within(d_dst + d_src, one, GAT_BWD_TOL) and own_columns)
            case = f"gat two-sweep[h={h}] normalized={normalized}"
            log(f"kernel vs plain [{case}]: max_abs dst={err_dst:.3e} src={err_src:.3e}, "
                f"dst + src vs one-sweep kernel {err_one:.3e} (tol rtol="
                f"{GAT_BWD_TOL['rtol']:.3g} atol={GAT_BWD_TOL['atol']:.3g}) "
                f"{'ok' if ok else 'MISMATCH'}; two launches of each "
                f"{'bit-equal' if same else 'DIFFER'}")
            if not ok or not same:
                failures.append(case)
            if not normalized:
                continue  # the main path's forward normalizes in the kernel
            times = dict(
                dst=cuda_ms(dst, flush_buf), src=cuda_ms(src, flush_buf),
                dst_plain=cuda_ms(lambda: gat_cuda.gat_bwd_dst_plain(
                    g, g2, pay, h, ch, 0.2), flush_buf),
                src_plain=cuda_ms(lambda: gat_cuda.gat_bwd_src_plain(
                    t, pay, g2, h, ch, 0.2), flush_buf),
                g2=cuda_ms(lambda: grad_payload(gbar, pay, out_k, h, ch, True),
                           flush_buf),
                one=cuda_ms(lambda: gat_cuda.gat_bwd_cuda(
                    g, gbar, pay, out_k, h, ch, 0.2, True), flush_buf),
                two=cuda_ms(lambda: gat_cuda.gat_bwd_two_sweep(
                    g, gbar, pay, out_k, h, ch, 0.2, True), flush_buf))
            log(f"backward of one layer [h={h}]: one-sweep kernel {times['one']:.4f} ms; "
                f"two-sweep {times['two']:.4f} ms = grad payload (plain torch) "
                f"{times['g2']:.4f} + dst {times['dst']:.4f} + src {times['src']:.4f} ms")
            # columns a sweep must touch: all of G2, the payload's xp and
            # a_src, and its own output columns
            entries[f"gat_bwd_dst[h={h}]"] = dict(
                max_abs_err=err_dst, ms=times["dst"], plain_ms=times["dst_plain"],
                **bound(planes_read["dst"], (hc + 3 * h) + (hc + h) + h,
                        4.0 * nnz * hc))
            entries[f"gat_bwd_src[h={h}]"] = dict(
                max_abs_err=err_src, ms=times["src"], plain_ms=times["src_plain"],
                **bound(planes_read["src"], (hc + 3 * h) + 2 * (hc + h),
                        6.0 * nnz * hc))
        del pay, gbar, out_k, g2, d_dst, d_src, want_dst, want_src, one
    if failures:
        fail(f"two-sweep GAT backward fails its checks: {failures}")
    for name, e in entries.items():
        log(f"{name}: bytes={e['bytes']} bound={e['bound_ms']:.4f} ms "
            f"({e['bound_by']}) kernel={e['ms']:.4f} ms plain={e['plain_ms']:.4f} ms "
            "library=none (no single PyTorch call computes this function)")
    return entries


def hub_phase(device) -> None:
    """The two edge-list kernels on a 700-node graph in which one chunk
    holds thousands of dense edges (several edge lists, many gather batches,
    a row of 300 sources) and one chunk none: against their plain versions,
    and two launches bit for bit."""
    import torch

    from elliptic_gnn_tpu_torch.graph.synthetic import hub_edges
    from elliptic_gnn_tpu_torch.kernels import bsda, bsda_spmm_cuda, gat_cuda

    n = 700
    ei = hub_edges(n, seed=11)
    gen = torch.Generator(device=device).manual_seed(7)
    failures = []
    g = bsda.build_bsda_for_kind(ei, n, "sage", depth=3, a_dtype="int8",
                                 transpose=True).to(device)
    hub, empty = int((g.a[1] != 0).sum()), int((g.a[3] != 0).sum())
    if hub <= 2048 or empty != 0:
        fail(f"the hub graph's chunks hold {hub} and {empty} edges, not > 2048 and 0")
    for f, dtype in ((2, torch.bfloat16), (168, torch.bfloat16), (65, torch.float32)):
        dname = str(dtype).replace("torch.", "")
        x = torch.randn((n, f), generator=gen, device=device).to(dtype)
        for name, table in (("forward", g), ("transpose", g.transpose)):
            got = bsda_spmm_cuda.bsda_dense_cuda(table, x)
            same = torch.equal(got, bsda_spmm_cuda.bsda_dense_cuda(table, x))
            torch.cuda.synchronize()
            want = bsda.bsda_dense_plain(table, x)
            ok = same and within(got.float(), want.float(), TOL[dname])
            log(f"hub graph, bsda_spmm [{name} F={f} {dname}]: max_abs="
                f"{float((got.float() - want.float()).abs().max()):.3e} "
                f"{'ok' if ok else 'MISMATCH'}, two launches "
                f"{'bit-equal' if same else 'DIFFER'}")
            if not ok:
                failures.append(f"bsda_spmm {name} F={f} {dname}")
    g = bsda.build_bsda_for_kind(ei, n, "gat", depth=4, transpose=False).to(device)
    n_pad = g.num_chunks * g.chunk
    for h, ch in ((4, 8), (1, 2)):
        pay = torch.randn((n_pad, gat_cuda.payload_width(h, ch)), generator=gen,
                          device=device)
        want = gauge_free(gat_cuda.gat_fwd_plain(g, pay, h, ch, 0.2, True), h, ch, True)
        for gated in (True, False):
            got = gat_cuda.gat_fwd_cuda(g, pay, h, ch, 0.2, True, gated=gated)
            same = torch.equal(
                got, gat_cuda.gat_fwd_cuda(g, pay, h, ch, 0.2, True, gated=gated))
            torch.cuda.synchronize()
            errs = [float((a - b).abs().max())
                    for a, b in zip(gauge_free(got, h, ch, True), want)]
            ok = same and bool(torch.isfinite(got).all()) and all(
                within(a, b, GAT_FWD_TOL)
                for a, b in zip(gauge_free(got, h, ch, True), want))
            log(f"hub graph, gat_fwd [h={h} ch={ch}{' gated' if gated else ''}]: max_abs "
                f"val={errs[0]:.3e} m+log s={errs[1]:.3e} {'ok' if ok else 'MISMATCH'}, "
                f"two launches {'bit-equal' if same else 'DIFFER'}")
            if not ok:
                failures.append(f"gat_fwd h={h} gated={gated}")
    if failures:
        fail(f"a kernel disagrees with its plain version on the hub graph: {failures}")


def gat_step_times(device, g, flush_buf) -> None:
    """One training step of the gat.yaml model (forward, loss, backward) at
    the Elliptic-scale tables `g`: through the kernels, as the model runs on
    the card, with the one-sweep and with the two-sweep backward, and
    through its plain version (forward_plain, autograd), which the port runs
    on CPU tensors only. Timed and logged, used nowhere."""
    import torch
    import yaml

    from elliptic_gnn_tpu_torch.kernels import gat_cuda
    from elliptic_gnn_tpu_torch.models import build_model

    with open(os.path.join(HERE, "configs", "gat.yaml")) as fh:
        cfg = dict(yaml.safe_load(fh), dropout=0.0)
    gen = torch.Generator(device=device).manual_seed(2)
    x = torch.randn((g.num_nodes, 167), generator=gen, device=device)
    y = torch.randint(0, 2, (g.num_nodes,), generator=gen, device=device)
    model = build_model("gat", 167, cfg,
                        generator=torch.Generator().manual_seed(0)).to(device).train()

    def step(run):
        model.zero_grad(set_to_none=True)
        torch.nn.functional.cross_entropy(run(x, g), y).backward()
        return [p.grad for p in model.parameters()]

    def counted_step(want):
        gat_cuda.reset_launches()
        grads = step(model)
        if gat_cuda.launches != {"gat_fwd": 1, "gat_fwd_gated": 1, **want}:
            fail(f"the GAT model's training step on the card launched "
                 f"{gat_cuda.launches}, not the kernels expected: {want}")
        return grads

    grads_k = counted_step({"gat_bwd": 2, "gat_bwd_dst": 0, "gat_bwd_src": 0})
    with two_sweep_backward():
        two = {"gat_bwd": 0, "gat_bwd_dst": 2, "gat_bwd_src": 2}
        grads_2 = counted_step(two)
        same = all(torch.equal(a, b) for a, b in zip(grads_2, counted_step(two)))
    grads_p = step(model.forward_plain)
    err = max(float((a - b).abs().max()) for a, b in zip(grads_k, grads_p))
    err_2 = max(float((a - b).abs().max()) for a, b in zip(grads_2, grads_p))
    ok = all(within(a, b, GAT_BWD_TOL) and within(c, b, GAT_BWD_TOL)
             for a, b, c in zip(grads_k, grads_p, grads_2))
    # in turns within one call: one-sweep, two-sweep, two-sweep, one-sweep
    ms = [cuda_ms(lambda: step(model), flush_buf)]
    with two_sweep_backward():
        ms_2 = [cuda_ms(lambda: step(model), flush_buf) for _ in range(2)]
    ms.append(cuda_ms(lambda: step(model), flush_buf))
    plain_ms = cuda_ms(lambda: step(model.forward_plain), flush_buf)
    log(f"gat.yaml training step at {g.num_nodes} nodes (forward, loss, backward): "
        f"kernels with the one-sweep backward {ms[0]:.3f} and {ms[1]:.3f} ms, with the "
        f"two-sweep backward {ms_2[0]:.3f} and {ms_2[1]:.3f} ms, plain version on the "
        f"card {plain_ms:.3f} ms; parameter gradients differ from the plain version's "
        f"by max_abs={err:.3e} (one-sweep) and {err_2:.3e} (two-sweep) (tol rtol="
        f"{GAT_BWD_TOL['rtol']:.3g} atol={GAT_BWD_TOL['atol']:.3g}) "
        f"{'ok' if ok else 'MISMATCH'}; two two-sweep steps give "
        f"{'bit-equal' if same else 'DIFFERENT'} gradients")
    if not ok:
        fail("GAT parameter gradients through the kernels disagree with autograd "
             "through the plain version at full size")
    if not same:
        fail("two training steps with the two-sweep backward differ in their bits")


def small_gat_graph(n=6000, seed=4, far=100):
    """Directed synthetic graph with far edges (a residual spill) and
    duplicate edges (multiplicity > 1), BFS-renumbered: (data, GAT tables)."""
    import numpy as np

    from elliptic_gnn_tpu_torch.graph import synthetic
    from elliptic_gnn_tpu_torch.kernels.bsda import bfs_order, build_bsda_for_kind

    data = synthetic.generate(num_nodes=n, seed=seed)
    data = data.renumber(bfs_order(data.edge_index, data.num_nodes, data.timestep))
    rng = np.random.default_rng(seed)
    ei = data.edge_index
    ei = np.concatenate([ei, rng.integers(0, n, (2, far)),
                         ei[:, rng.integers(0, ei.shape[1], far)]], axis=1)
    g = build_bsda_for_kind(ei, n, "gat", depth=4, transpose=False)
    if g.residual is None:
        fail("the small GAT graph has no spill to test the merge with")
    return data, g


def gat_autograd_check(device):
    """Backward kernel, spill merge included, against autograd through the
    plain formulation (bsda_gat_aggregate) on a 6,000-node graph."""
    import torch

    from elliptic_gnn_tpu_torch.kernels import bsda_gat, packed_gat

    _, g = small_gat_graph()
    g = g.to(device)
    h, ch = 4, 8
    hc, n, n_pad = h * ch, g.num_nodes, g.num_chunks * g.chunk
    gen = torch.Generator(device=device).manual_seed(1)
    pay = torch.randn((n_pad, hc + 2 * h), generator=gen, device=device)
    pay[n:] = 0.0
    c = torch.randn((n, hc), generator=gen, device=device)

    p_k = pay.clone().requires_grad_(True)
    val_k = packed_gat._attend_packed(g, p_k, h, ch, 0.2)[:n, :hc]
    (val_k * c).sum().backward()

    p_a = pay.clone().requires_grad_(True)
    y = bsda_gat.bsda_gat_aggregate(
        g, p_a[:n, :hc].reshape(n, h, ch), p_a[:n, hc: hc + h], p_a[:n, hc + h:])
    (y.reshape(n, hc) * c).sum().backward()
    torch.cuda.synchronize()

    ok_v = within(val_k.detach(), y.detach().reshape(n, hc), GAT_FWD_TOL)
    ok_g = within(p_k.grad[:n], p_a.grad[:n], GAT_BWD_TOL)
    log(f"packed attend vs autograd (6,000 nodes, {g.residual.num_nodes} spill rows): "
        f"value max_abs={float((val_k.detach() - y.detach().reshape(n, hc)).abs().max()):.3e}, "
        f"payload gradient max_abs={float((p_k.grad[:n] - p_a.grad[:n]).abs().max()):.3e} "
        f"(tol rtol={GAT_BWD_TOL['rtol']:.3g} atol={GAT_BWD_TOL['atol']:.3g})")
    if not (ok_v and ok_g):
        fail("the GAT kernels with the spill merge disagree with autograd "
             "through the plain formulation")


def small_reference_check(device):
    """SAGE-ResBN logits with amp on the card (kernel) against the same
    weights on the CPU (plain version), on a small graph."""
    import numpy as np
    import torch

    from elliptic_gnn_tpu_torch.graph import synthetic
    from elliptic_gnn_tpu_torch.graph.transform import symmetrize_edges
    from elliptic_gnn_tpu_torch.kernels.bsda import bfs_order, build_bsda_for_kind
    from elliptic_gnn_tpu_torch.models import build_model

    data = symmetrize_edges(synthetic.generate(num_nodes=6000, seed=4))
    data = data.renumber(bfs_order(data.edge_index, data.num_nodes, data.timestep))
    g = build_bsda_for_kind(data.edge_index, data.num_nodes, "sage", depth=3,
                            a_dtype="int8", transpose=True)
    cfg = {"hidden_dim": 64, "layers": 3, "dropout": 0.0, "amp": True,
           "time_embed_dim": 2, "time_embed_type": "sin"}
    model = build_model("sage_resbn", data.num_features, cfg,
                        generator=torch.Generator().manual_seed(0)).eval()
    x = torch.from_numpy(data.x)
    t = torch.from_numpy(data.timestep.astype(np.int32))
    with torch.no_grad():
        want = model(x, g, t)
        got = model.to(device)(x.to(device), g.to(device), t.to(device)).cpu()
    err = float((got - want).abs().max())
    log(f"small-graph reference: SAGE-ResBN logits cuda vs cpu max_abs={err:.3e} "
        "(tol 2e-2 + 2e-2*|ref|)")
    if not bool(((got - want).abs() <= 2e-2 + 2e-2 * want.abs()).all()):
        fail("model logits on the card disagree with the CPU reference")

    # gcn.yaml's and sage.yaml's models on the directed graph; GCN's tables
    # carry both scales and its last layer aggregates the F = 2 logits
    data = synthetic.generate(num_nodes=6000, seed=4)
    data = data.renumber(bfs_order(data.edge_index, data.num_nodes, data.timestep))
    x = torch.from_numpy(data.x)
    for arch, layers in (("gcn", 3), ("sage", 2)):
        g = build_bsda_for_kind(data.edge_index, data.num_nodes, arch, depth=3,
                                a_dtype="int8", transpose=True)
        cfg = {"hidden_dim": 128, "layers": layers, "dropout": 0.0, "amp": True}
        model = build_model(arch, data.num_features, cfg,
                            generator=torch.Generator().manual_seed(0)).eval()
        with torch.no_grad():
            want = model(x, g)
            got = model.to(device)(x.to(device), g.to(device)).cpu()
        log(f"small-graph reference: {arch} logits cuda (kernel) vs cpu (plain) "
            f"max_abs={float((got - want).abs().max()):.3e} (tol 2e-2 + 2e-2*|ref|)")
        if not bool(((got - want).abs() <= 2e-2 + 2e-2 * want.abs()).all()):
            fail(f"{arch} logits on the card disagree with the CPU reference")

    data, g = small_gat_graph()
    cfg = {"hidden_dim": 32, "layers": 2, "heads": 4, "dropout": 0.0}
    model = build_model("gat", data.num_features, cfg,
                        generator=torch.Generator().manual_seed(0)).eval()
    x = torch.from_numpy(data.x)
    with torch.no_grad():
        want = model(x, g)
        got = model.to(device)(x.to(device), g.to(device)).cpu()
    log(f"small-graph reference: GAT logits cuda (kernels) vs cpu (plain) "
        f"max_abs={float((got - want).abs().max()):.3e} "
        f"(tol {GAT_FWD_TOL['atol']:.3g} + {GAT_FWD_TOL['rtol']:.3g}*|ref|)")
    if not within(got, want, GAT_FWD_TOL):
        fail("GAT logits on the card disagree with the CPU reference")


def build_processed(tmp) -> str:
    from elliptic_gnn_tpu_torch.graph import build_graph

    processed = os.path.join(tmp, "processed")
    build_graph.main({"seed": 0, "synthetic": True, "synthetic_nodes": N_NODES,
                      "t_max": 49, "t_train_end": 34, "t_val_end": 43,
                      "processed_dir": processed})
    return processed


def slice_phase(tmp, processed, config_name, run_name=None):
    """train_gnn.main on one config's values at full width for EPOCHS
    epochs, launch counts set to 0 just before and read just after.
    `run_name` replaces the config's, for a second run of one config.
    Returns a dict: launches, cfg, outdir, losses, val_pr_auc, scores."""
    import numpy as np
    import yaml

    from elliptic_gnn_tpu_torch.kernels import bsda_spmm_cuda, gat_cuda
    from elliptic_gnn_tpu_torch.train import train_gnn

    with open(os.path.join(HERE, "configs", config_name)) as fh:
        cfg = yaml.safe_load(fh)
    cfg.update(processed_dir=processed, output_root=os.path.join(tmp, "out"),
               max_epochs=EPOCHS)
    if run_name is not None:
        cfg["run_name"] = run_name
    bsda_spmm_cuda.reset_launches()
    gat_cuda.reset_launches()
    t0 = time.time()
    metrics = train_gnn.main(cfg)
    wall = time.time() - t0
    launches = {**bsda_spmm_cuda.launches, **gat_cuda.launches}

    outdir = os.path.join(cfg["output_root"], "gnn", cfg["run_name"])
    epochs = int(metrics["epochs_run"])
    log(f"slice: {config_name} as {cfg['run_name']} ({cfg['arch']}, hidden {cfg['hidden_dim']}, "
        f"{cfg['layers']} layers, heads {cfg.get('heads', '-')}, amp {cfg['amp']}) "
        f"ran {epochs} epochs, main() wall {wall:.1f} s, "
        f"train {metrics['train_seconds']:.3f} s")
    log("epoch wall times (s): " + ", ".join(
        f"{s:.4f}" for s in metrics["epoch_seconds"]))
    log(f"kernel launches in the run: {launches}")
    if epochs != EPOCHS:
        fail(f"{config_name} ran {epochs} epochs, not {EPOCHS}")
    for name in ("metrics.json", "scores_val.npy", "scores_test.npy", "y_test.npy",
                 "node_idx_test.npy", "training_log.csv", "config_used.yaml",
                 "best.ckpt"):
        if not os.path.exists(os.path.join(outdir, name)):
            fail(f"missing artifact {name}")
    with open(os.path.join(outdir, "training_log.csv")) as fh:
        rows = [line.split(",") for line in fh.read().splitlines()[1:]]
    losses = [float(r[1]) for r in rows]
    val_pr_auc = [float(r[2]) for r in rows]
    scores = np.load(os.path.join(outdir, "scores_test.npy"))
    y_test = np.load(os.path.join(outdir, "y_test.npy"))
    if len(losses) != epochs or not all(math.isfinite(v) for v in losses):
        fail(f"losses not finite: {losses}")
    if scores.shape != y_test.shape or not np.isfinite(scores).all() or \
            scores.min() < 0 or scores.max() > 1:
        fail("test scores are not finite probabilities of the expected shape")
    log(f"losses {losses}; val PR-AUC {val_pr_auc}; test PR-AUC "
        f"{metrics['pr_auc_illicit']:.4f}, ROC-AUC {metrics['roc_auc']:.4f} "
        f"(random weights, {epochs} epochs)")
    return dict(launches=launches, cfg=cfg, outdir=outdir, losses=losses,
                val_pr_auc=val_pr_auc, scores=scores)


def check_rec_k8_launches(launches) -> None:
    gat = {k: v for k, v in launches.items() if k.startswith("gat")}
    if launches["ring"] + launches["banded"] < 8 * EPOCHS or \
            min(launches["ring"], launches["banded"]) == 0 or any(gat.values()):
        fail(f"rec_k8 did not run every epoch through the BSDA kernel alone: "
             f"{launches} for {EPOCHS} epochs (want >= 8 per epoch, both variants)")


def check_gat_launches(launches, two_sweep=False) -> None:
    """Per epoch: the training step launches the forward twice (hidden
    layer with the slot cover, final layer without) and the backward twice
    (one a layer: the one-sweep kernel, or with `two_sweep` each of the two
    sweeps and the one-sweep kernel never), the val eval the forward
    twice; the final scoring pass adds one forward of each variant."""
    want = {"gat_fwd_gated": 2 * EPOCHS + 1, "gat_fwd": 2 * EPOCHS + 1,
            "gat_bwd": 0 if two_sweep else 2 * EPOCHS,
            "gat_bwd_dst": 2 * EPOCHS if two_sweep else 0,
            "gat_bwd_src": 2 * EPOCHS if two_sweep else 0, "ring": 0, "banded": 0}
    if launches != want:
        fail(f"gat.yaml did not run every epoch through the GAT kernels: "
             f"{launches}, want {want}")


def check_conv_launches(name, launches, per_epoch, scoring) -> None:
    """gcn.yaml: three aggregations a forward, all of one 128-lane tile (F =
    128, 128 and the 2 logits): per epoch 3 forward + 3 on the transpose
    tables + 3 val eval as `ring`, none as `banded`. sage.yaml: layer 1
    aggregates the 167 input features (`banded`, no gradient: forward + val
    eval), layer 2 F = 128 (`ring`: forward, transpose, val eval). The
    scoring pass adds one forward."""
    want = {k: per_epoch[k] * EPOCHS + scoring[k] for k in ("ring", "banded")}
    got = {k: launches[k] for k in want}
    if got != want or any(v for k, v in launches.items() if k.startswith("gat")):
        fail(f"{name} did not run every epoch through the BSDA kernel alone: "
             f"{launches}, want {want}")


def check_two_sweep_runs(one, two_a, two_b) -> None:
    """Two gat.yaml runs with the two-sweep backward give the same bits, and
    agree per epoch with the one-sweep run within the stated tolerances."""
    import numpy as np

    if not np.array_equal(two_a["scores"], two_b["scores"]) or \
            two_a["losses"] != two_b["losses"]:
        fail("two gat.yaml runs with the two-sweep backward differ: max abs score "
             f"difference {float(np.abs(two_a['scores'] - two_b['scores']).max()):.3e}, "
             f"losses {two_a['losses']} and {two_b['losses']}")
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(two_a["losses"], one["losses"]))
    pr_abs = max(abs(a - b) for a, b in zip(two_a["val_pr_auc"], one["val_pr_auc"]))
    score_abs = float(np.abs(two_a["scores"] - one["scores"]).max())
    log(f"gat.yaml two-sweep: {EPOCHS} epochs twice, scores_test.npy and losses "
        f"bit-equal; against the one-sweep run: loss max rel {loss_rel:.3e} (tol "
        f"{TWO_SWEEP_LOSS_RTOL:.0e}), val PR-AUC max abs {pr_abs:.3e} (tol "
        f"{TWO_SWEEP_PR_ATOL:.0e}), test scores max abs {score_abs:.3e}")
    if loss_rel > TWO_SWEEP_LOSS_RTOL or pr_abs > TWO_SWEEP_PR_ATOL:
        fail("the two-sweep gat.yaml run disagrees with the one-sweep run")


def predict_check(outdir) -> None:
    """predict.predict on the finished GAT run dir reproduces the trainer's
    own test scores."""
    import numpy as np

    from elliptic_gnn_tpu_torch.kernels import gat_cuda
    from elliptic_gnn_tpu_torch.train import predict

    gat_cuda.reset_launches()
    t0 = time.time()
    node_idx, probs, flags, thr, data = predict.predict(outdir)
    wall = time.time() - t0
    idx = np.load(os.path.join(outdir, "node_idx_test.npy"))
    want = np.load(os.path.join(outdir, "scores_test.npy"))
    if not np.array_equal(node_idx, np.arange(data.num_nodes)):
        fail("predict did not report every node once, in on-disk order")
    err = float(np.abs(probs[idx] - want).max())
    log(f"predict: scored {probs.size} nodes in {wall:.1f} s (threshold {thr:.4f}, "
        f"{int(flags.sum())} flagged), launches {gat_cuda.launches}; test scores vs "
        f"scores_test.npy max_abs={err:.3e} (tol 1e-6)")
    if err > 1e-6 or gat_cuda.launches["gat_fwd"] != 1 or \
            gat_cuda.launches["gat_fwd_gated"] != 1:
        fail("predict does not reproduce the trainer's test scores through the kernels")


def profile_phase(cfg, kernel_names) -> None:
    """Where the device time goes: the same run for PROFILE_EPOCHS epochs
    under torch.profiler, device time summed by kernel name (setup, the
    epochs and the final scoring pass); `kernel_names` are this path's
    hand-written kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from elliptic_gnn_tpu_torch.train import train_gnn

    cfg = dict(cfg, max_epochs=PROFILE_EPOCHS,
               output_root=cfg["output_root"] + "_profile")
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        metrics = train_gnn.main(cfg)
        torch.cuda.synchronize()
    wall = time.time() - t0
    # device-side events only (kernels, copies): the CPU ops that launch
    # them, and annotated ranges such as Optimizer.step, carry the same
    # device time again
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    total_us = sum(r[1] for r in rows)
    copy_us = sum(r[1] for r in rows if r[0].startswith("Memcpy"))
    log(f"profile of {cfg['arch']} ({PROFILE_EPOCHS} epochs + setup + scoring, "
        f"main() wall {wall:.1f} s, train {metrics['train_seconds']:.3f} s): device "
        f"time {total_us / 1e3:.3f} ms, of it copies {copy_us / 1e3:.3f} ms")
    for name in kernel_names:
        us = sum(r[1] for r in rows if name in r[0])
        count = sum(r[2] for r in rows if name in r[0])
        log(f"  {name}: {us / 1e3:.3f} ms over {count} launches "
            f"({us / max(total_us - copy_us, 1):.1%} of kernel time)")
    for key, us, count in rows[:12]:
        log(f"  {us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")


def drive(device) -> list:
    """Every phase after the build, on `device`; returns the kernel line's
    entries."""
    import torch

    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    entries = kernel_phase(device, flush_buf)
    arch_entries = arch_kernel_phase(device, flush_buf)
    gat_entries, gat_tables = gat_kernel_phase(device, flush_buf)
    gat_entries.update(gat_two_sweep_phase(device, flush_buf, gat_tables))
    gat_step_times(device, gat_tables, flush_buf)
    del flush_buf, gat_tables
    hub_phase(device)
    gat_autograd_check(device)
    small_reference_check(device)
    with tempfile.TemporaryDirectory() as tmp:
        processed = build_processed(tmp)
        rec = slice_phase(tmp, processed, "rec_k8.yaml")
        check_rec_k8_launches(rec["launches"])
        gat = slice_phase(tmp, processed, "gat.yaml")
        check_gat_launches(gat["launches"])
        predict_check(gat["outdir"])
        with two_sweep_backward():
            gat2 = slice_phase(tmp, processed, "gat.yaml", "gat_two_sweep_a")
            gat2_again = slice_phase(tmp, processed, "gat.yaml", "gat_two_sweep_b")
        check_gat_launches(gat2["launches"], two_sweep=True)
        check_gat_launches(gat2_again["launches"], two_sweep=True)
        check_two_sweep_runs(gat, gat2, gat2_again)
        gcn = slice_phase(tmp, processed, "gcn.yaml")
        check_conv_launches("gcn.yaml", gcn["launches"],
                            per_epoch={"ring": 9, "banded": 0},
                            scoring={"ring": 3, "banded": 0})
        sage = slice_phase(tmp, processed, "sage.yaml")
        check_conv_launches("sage.yaml", sage["launches"],
                            per_epoch={"ring": 3, "banded": 2},
                            scoring={"ring": 1, "banded": 1})
        profile_phase(rec["cfg"], ["bsda_spmm_kernel"])
        profile_phase(gat["cfg"], ["gat_fwd_kernel", "gat_bwd_kernel"])
        with two_sweep_backward():
            profile_phase(gat2["cfg"], ["gat_fwd_kernel", "gat_bwd_dst_kernel",
                                        "gat_bwd_src_kernel", "gat_bwd_kernel"])
        profile_phase(gcn["cfg"], ["bsda_spmm_kernel"])
        profile_phase(sage["cfg"], ["bsda_spmm_kernel"])

    def kernel_row(name, row, count, e, library=True):
        return {"name": name, "route": "cuda", "source": row[2], "replaces": row[0],
                "launches": count, "max_abs_err": e["max_abs_err"], "ms": e["ms"],
                "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
                "bound_by": e["bound_by"],
                "library_ms": e["library_ms"] if library else None}

    def second_shape(suffix, e):
        """A kernel counted once but launched at two shapes a step: the
        second shape's numbers under *_<suffix> keys of the same entry."""
        return {f"{k}_{suffix}": e[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}

    ring_row, banded_row = TPU_KERNELS[0], TPU_KERNELS[1]
    kernels = [
        kernel_row(f"bsda_spmm[ring: rec_k8 F={entries['ring']['f']} bf16]", ring_row,
                   rec["launches"]["ring"], entries["ring"]),
        kernel_row(f"bsda_spmm[banded: rec_k8 F={entries['banded']['f']} bf16]",
                   banded_row, rec["launches"]["banded"], entries["banded"]),
        # gcn.yaml counts its F = 128 and F = 2 aggregations together
        kernel_row("bsda_spmm[ring: gcn F=128 bf16, dst and src scales]", ring_row,
                   gcn["launches"]["ring"], arch_entries[("gcn", 128)]),
        kernel_row("bsda_spmm[banded: sage F=167 bf16]", banded_row,
                   sage["launches"]["banded"], arch_entries[("sage", 167)]),
        kernel_row("bsda_spmm[ring: sage F=128 bf16]", ring_row,
                   sage["launches"]["ring"], arch_entries[("sage", 128)]),
    ]
    f2 = arch_entries[("gcn", 2)]
    kernels[2].update(second_shape("f2", f2), library_ms_f2=f2["library_ms"])
    # the backwards run once per layer under one count: an entry holds the
    # hidden layer's shape (h=4) and, under *_h1 keys, the final layer's
    for name, row, count in (
            ("gat_fwd[h=4 gated]", TPU_KERNELS[3], gat["launches"]["gat_fwd_gated"]),
            ("gat_fwd[h=1]", TPU_KERNELS[2], gat["launches"]["gat_fwd"]),
            ("gat_bwd", TPU_KERNELS[4], gat["launches"]["gat_bwd"]),
            ("gat_bwd_dst", TPU_KERNELS[5], gat2["launches"]["gat_bwd_dst"]),
            ("gat_bwd_src", TPU_KERNELS[6], gat2["launches"]["gat_bwd_src"])):
        per_layer = "[" not in name
        e = gat_entries[f"{name}[h=4]" if per_layer else name]
        kernels.append(kernel_row(name, row, count, e, library=False))
        if per_layer:
            kernels[-1].update(second_shape("h1", gat_entries[f"{name}[h=1]"]))
    if any(k["launches"] <= 0 for k in kernels):
        fail(f"a kernel of the main paths was never launched: {kernels}")
    return kernels


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    sys.path.insert(0, HERE)
    try:
        from elliptic_gnn_tpu_torch.kernels import cuda_build
    except ImportError as exc:
        fail(f"elliptic_gnn_tpu_torch not found beside chip_smoke.py: {exc}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    t_start = time.time()

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    log(f"device: {kind} | nvidia-smi: {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.time()
    libs = cuda_build.build(list(cuda_build.SOURCES), verbose=True)
    log(f"built {', '.join(os.path.relpath(p, HERE) for p in libs.values())} "
        f"in {time.time() - t0:.1f} s")

    kernels = drive(device)
    table = [{"replaces": loc, "tpu_kernel": name,
              "status": "ported" if port else "todo", "port": port}
             for loc, name, port in TPU_KERNELS]
    log(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernel_table": table}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
