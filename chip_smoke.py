#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (elliptic_gnn_tpu_torch) on one
NVIDIA GPU. Run from the repository root:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. device: the card's name and power limit;
  2. build: compiles the eight kernel sources of kernels/csrc with nvcc, in
     parallel, and prints what ptxas says of each kernel;
  3. BSDA kernel vs plain: on the Elliptic-scale synthetic graph (203,769
     nodes, 234,355 edges before symmetrization, 166 features, 49 timesteps,
     seed 0), the kernel's dense output against its plain PyTorch version
     for the forward (dst scale) and transpose (src scale) tables, the
     bit-packed (pack 4) and int8 (pack 1) tables, at F=168 f32, F=168 bf16
     and F=64 bf16; CUDA-event medians of kernel, plain version and the
     torch.sparse yardstick; then on the same graph directed, the GCN
     tables (self-looped, dst and src scales together) at F=128 and F=2
     bf16 and at F=256 f32 (egcn_o.yaml's aggregation) and the SAGE tables
     at F=167 and F=128 bf16, kernel against plain version;
     every launch shape twice, the two results equal bit for bit; one line
     per shape with kernel, bound and library ms and their ratios; then the
     halo path's shards: the rec_k8 tables padded (pad_bsda_chunks) and
     partitioned (partition_bsda) at n = 4 and n = 2, each shard's
     shard_local_aggregate (the kernel on its local split tables, the halo
     fix-up, the spill; backward the kernel on its block-transpose tables)
     with its halo rows from the global x, at F=64 bf16, F=168 bf16 and
     F=64 f32: the shards' rows and gradient against the single-device
     kernel, each shard's two launches against their plain versions, two
     runs bit for bit; launches, each shard's ms and the whole graph's;
     then the GSPMD row sharding's rectangular launches: the same tables
     padded at n = 4 and n = 2, every rank's slice of destination chunks
     over the whole x (what the all-gather delivers), forward and the
     transpose slice over the whole cotangent, at the same (F, dtype)
     cases: the ranks' rows and gradient against the single-device kernel
     (and whether the dense parts are bit-equal to its rows), each launch
     against its plain version, two runs bit for bit; launches, a rank's ms
     against the whole graph's, forward and transpose;
     then the SAGE-ResBN hidden-layer epilogue (resbn_epilogue.cu) at the
     main path's [203,769 x 64] f32: its training forward, backward and eval
     forward against the plain version (epilogue_plain) on the card, twice
     bit for bit, each timed against its bound and the plain version;
     then EvolveGCN-O's weight evolution (egcn_evolve.cu) at d -> 256 for
     d = 166 and 256 over 49 steps, forward and backward through time
     against the plain chain, twice bit for bit, the eval forward equal to
     the kept one; the persistent passes (training forward, eval forward,
     backward, one launch each) timed against their bounds and against
     the step kernels' graphed passes, the step kernels' steps and the
     whole chains against their bounds and the plain chain;
     then the ELL kernel (ell_spmm.cu) on rec_k8's `aggregation: ell`
     encoding of the same graph (mean, renumber_for_ell, the flat tables
     and their transpose) at F=168 and F=64 f32, forward and transpose,
     against the plain version (ell_weighted_sum and its autograd
     backward), twice bit for bit; kernel, plain version and
     torch.sparse.mm (CSR f32 of the same weights) timed against the
     bound;
  4. GAT kernels vs plain: on the same graph, directed and self-looped,
     depth 4: the forward at (h, ch) = (4, 8) with the slot cover and
     (1, 2) without, normalize on and off, compared on val = acc / s and
     m + log s; the backward in both gauges against the closed form; two
     runs of the same backward against each other (atomics); the two-sweep
     backward (destination sweep over the forward tables, which also
     writes the grad payload G2, source sweep over the transpose tables):
     each sweep against its plain version, G2 against grad_payload, their
     sum against the one-sweep kernel, two launches of each bit for bit
     equal, grad_payload timed alone; GAT wider than one launch (4, 128)
     and (1, 600): the four kernels against their plain versions in both
     gauges, and a training step and eval pass of a GAT of 4 heads of 128
     through the kernels with both backwards, launch counts read, against
     its plain version;
     the BSDA and GAT forward kernels on a 700-node graph with a hub chunk
     of thousands of dense edges and an empty chunk, against their plain
     versions and twice, bit for bit; the three backwards on the same graph
     with an out-hub (a source of 300 edges, a source chunk whose transpose
     edge list is taken in several groups), against their plain versions,
     the two sweeps twice bit for bit and the one-sweep backward's d a_dst
     too;
     one training step of the gat.yaml model through the kernels, with the
     one-sweep and with the two-sweep backward, against its plain version,
     gradients and times; and on a 6,000-node graph with a spill,
     the backward through the packed attend against autograd through the
     plain formulation;
     GAT on a mesh: the gat.yaml tables padded at n = 4 and n = 2, every
     GSPMD rank's rectangular launch (its destination chunks over every
     payload row, the source sweep on its transpose slice over every G2
     row) and every halo shard's (its table over its halo-extended rows,
     the source sweep on the block transpose over the ext grid) of the
     forward, the one-sweep backward and both sweeps at (4, 8) and (1, 2),
     each against its plain version, the ranks' rows bit for bit against
     the whole graph's launch; a rank's and a shard's ms beside the whole
     graph's;
  5. small-graph references: SAGE-ResBN, GCN, SAGE and GAT logits on the
     card (kernels) against the same weights on the CPU (plain versions);
  6. CSV round trip: the same synthetic graph written as the three Elliptic
     CSVs and built again through the port's CSV branch with the native
     parser; graph.npz must equal the synthetic build's; write and parse
     seconds printed. The slices train from this CSV build;
  7. slices: train_gnn.main on the values of configs/rec_k8.yaml, gat.yaml,
     gcn.yaml and sage.yaml at full width, with the launch counts set to 0
     just before and read just after: every epoch must have gone through
     the kernels (the K-epoch loop's replays counted as the launches
     captured in its graph times its replays), losses and scores finite,
     the artifacts present and best.ckpt an npz in the JAX package's key
     layout (read with numpy alone; EvolveGCN-O, which the JAX package
     lacks, in its own). rec_k8 and gat.yaml run 16 epochs with
     `epochs_per_sync: auto` (K = 8, the epoch a replayed CUDA graph) and,
     interleaved, with 1 (serial): loss and val PR-AUC per epoch within 1e-4;
     then both loops with the patience at which the stop falls inside a
     block: the same stop epoch and rows. rec_k8 also writes checkpoints
     (every 8 epochs) and the hub ablation (`ablate_hubs_frac: 0.05`): a
     run stopped at its checkpoint after 8 epochs and resumed to 16 ends
     with the uninterrupted run's rows and best_val; the hub-ablation and
     robustness CLIs score its run dir through the kernel. predict.predict
     on the GAT run dir must reproduce its scores_test.npy; gat.yaml again,
     twice, K loop, with the two-sweep backward chosen
     (EGNN_GAT_ONE_SWEEP=0): only the two sweeps may run the backward, the
     two runs' scores_test.npy must be equal bit for bit, and loss and val
     PR-AUC per epoch must agree with the one-sweep run (loss rtol 1e-4,
     PR-AUC atol 2e-3); gcn.yaml and sage.yaml 5 epochs, K loop;
     egcn_o.yaml 16 epochs, K loop, every epoch through the weight
     evolution's kernels (egcn_*) and bsda_spmm at F = 256 f32, its
     best.ckpt in its own flat layout (models/convert.py), and
     predict.predict on its run dir reproducing its scores_test.npy. Epoch
     walls of K and serial runs and the device time of one replayed epoch
     are printed;
  8. the trainer's other single-device paths, on the same CSV build:
     rec_k8 with `aggregation: ell` (the ELL kernel on the flat tables,
     renumber_for_ell) 16 epochs in the K loop and in the serial loop, per
     epoch within 1e-4, ell_spmm launched 8 times an epoch and no BSDA or
     GAT kernel, and predict reproducing its test scores (3 launches); rec_k8 with
     `mini_batch: true` at its fanout and batch size for 3 epochs, and one
     sampled batch's forward, loss and gradients on the card against the
     CPU; rec_k8 with `profile_dir` (auto K stays 8): the Chrome trace of
     the K loop's blocks 4-6 holds their `loop.*` annotations and
     bsda_spmm_kernel, the spans beside it; and with `epochs_per_sync: 1`:
     the serial loop's trace of epochs 4-6 names bsda_spmm_kernel, the
     spans beside it; sweep_gnn over two
     learning rates of rec_k8, sequential and with two workers on the one
     card: the same ranks and run names, metrics within 2e-3; walls,
     sampling and step times printed;
  9. the halo path in a world of one (`aggregation: shard_map,
     mesh_devices: 1`, an NCCL group of one rank): rec_k8 16 epochs in the
     K loop (its all-reduces captured) and serial, gcn.yaml 5 epochs,
     gat.yaml 16 epochs in the K loop and serial and once more with the
     two-sweep backward; rec_k8 and gcn launch bsda_spmm every epoch as
     their single-device runs do, gat.yaml its GAT kernels (the
     rectangular launches over each shard's halo-extended rows) as its
     single-device run does; first-epoch losses against the single-device
     runs within 1e-4 relative, final and best val PR-AUC within 2e-3, K
     against serial within 1e-4 per epoch; walls and replayed epochs beside
     the single-device runs'. Then the GSPMD row sharding in a world of one
     NCCL rank, entered through train_gnn.train_rank (the function a rank
     process runs) with a pinned `aggregation` at `mesh_devices: 1`:
     rec_k8 with `bsda` 16 epochs in the K loop (its all-gathers captured)
     and serial, gcn.yaml 5 epochs, gat.yaml 16 epochs in the K loop and
     serial with `bsda` (the GAT kernels' rectangular launches over the
     gathered rows), rec_k8 with `ell` 16 epochs; rec_k8, gcn and GAT
     launch their kernels as often as their single-device runs, the ELL run
     no BSDA or GAT kernel (its ranks gather; the whole graph's scoring
     pass launches ell_spmm); first-epoch losses within 1e-4 relative, test and best val
     PR-AUC within 2e-3 of the single-device runs, K against serial within
     1e-4. With two cards or more, the SAGE-ResBN epilogue's kernels over
     min(4, cards) NCCL ranks, each with padding rows of row_mask 0,
     against the plain version on the mesh and against the whole batch on
     one card, then rec_k8 and gat.yaml over min(4, cards) NCCL ranks that
     train_gnn.main starts, on the halo path and on the GSPMD row sharding;
     with one, a line saying they did not run;
 10. post-hoc: analysis.run_all on the rec_k8 and gat.yaml run dirs on the
     card, every stage (eval_by_time, calibration, workload, robustness,
     hub_ablation, explain, report), launch counts set to 0 just before
     and read just after: robustness and hub_ablation must have scored
     through bsda_spmm (rec_k8) and gat_fwd (gat.yaml); their CSV and JSON,
     report.html and, where matplotlib imports, the figures are checked on
     disk and no stage may have failed; explain_node on both run dirs on
     the card and on the CPU from the same best.ckpt and node (the test
     node with the most incoming edges), 20 steps:
     the same subgraph and class, masks within 1e-4, no kernel launched
     (the explainer's EllGraph goes to the ELL gather), walls printed with
     the card; the host-only CLIs (eda, and train_baselines and explain xgb
     where sklearn and matplotlib import);
 11. profile: the runs for 3 epochs under torch.profiler, device time by
     kernel name (rec_k8 in both loops, with `aggregation: ell` and with
     `mini_batch: true`);
 12. prints the table of TPU kernels, the kernel line (each entry with its
     post-hoc launches; the rec_k8 rows also with those of the profile_dir
     runs (K loop and serial), of the sequential sweep, of the shard phase (`shard_launches`),
     of the mesh-1 runs (`mesh1_launches`), of the GSPMD kernel phase
     (`gspmd_launches`, with a rank's and the whole graph's ms under
     `gspmd_ms`) and of the GSPMD mesh-1 runs (`gspmd_mesh1_launches`), the
     gcn row with its two mesh-1 runs', the GAT rows with the GAT mesh
     phase's launches (`mesh_kernel_launches`, a rank's, a shard's and the
     whole graph's ms under `mesh_ms`) and those of the mesh-1 runs of
     both routes, the egcn_evolve row with the egcn_o.yaml run's launches
     and those of its captured epoch (`captured_epoch_launches`), the
     ell_spmm row with the ELL runs' launches and those of its captured
     epoch), the card line, and the result line
     {"ok": true, "device": {...}}.

With `--multicard`, on a host of two cards or more, it runs only the
synthetic graph's rec_k8 and gat.yaml on one card and the multi-card runs
of phase 9 (the epilogue's kernels, then the halo path and the GSPMD row
sharding, over min(4, cards) NCCL ranks), then the card line and the
result line.

Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
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
KLOOP_EPOCHS = 16                   # two blocks of K = 8
KLOOP_TOL = 1e-4                    # K loop against serial, per epoch
PROFILE_EPOCHS = 3
TIMING_ITERS = 20
SPIN_CYCLES = 200_000               # device spin before a timed call, ~0.1 ms
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
PEAK_OPS = {"float32": 67e12,        # CUDA-core f32
            "bfloat16": 989e12}      # dense bf16 tensor cores
# the ELL kernel's error against the f64 sums, over its row's sum of |terms|
ELL_SUM_RTOL = 1e-5
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
# the post-hoc phase: explain_node on the card against the CPU at the CPU
# test's steps and mask tolerance (tests/test_torch_port_explain.py)
EXPLAIN_STEPS = 20
EXPLAIN_MASK_ATOL = 1e-4
# the trainer's single-device options: sampled mini-batch training, one
# sampled batch on the card against the CPU (logits within MB_RTOL of the
# largest |logit|, the loss of itself, every gradient of the model's
# largest gradient entry: f32 sums over 203,769 rows, BatchNorm's among
# them, in another order), the profile_dir traces (six blocks of K = 8, the
# fourth to the sixth traced; six serial epochs, the fourth to the sixth
# traced), and the grid sweep, sequential against two workers (the BSDA spill's
# index_add_ is not bit-stable)
MB_EPOCHS = 3
MB_RTOL = 1e-4
PROFILE_DIR_EPOCHS = 48
PROFILE_DIR_SERIAL_EPOCHS = 6
SWEEP_TOL = 2e-3
# the halo path: the per-shard kernel phase at these partitions and
# (F, dtype) cases; bf16 shards against the whole-graph kernel relative to
# the largest entry (two roundings to bf16 where the kernel rounds once);
# the mesh-1 runs against the single-device runs of the same seed: the
# first-epoch loss (the dense tables are the same, the spill takes another
# route) and the final and best val PR-AUC (tests/test_parallel.py)
SHARD_WAYS = (4, 2)
MESH_EPILOGUE_PAD = 37              # a rank's padding rows (row_mask 0)
SHARD_CASES = ((64, "bfloat16"), (168, "bfloat16"), (64, "float32"))
SHARD_BF16_TOL = dict(rtol=1 / 64, atol=1e-3)
MESH1_LOSS_RTOL = 1e-4
MESH1_PR_ATOL = 2e-3


CARD = "unknown"  # nvidia-smi's name and power limit, set by main()


def fail(msg: str) -> None:
    print(f"[SMOKE] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[SMOKE] {msg}", flush=True)


def cuda_ms(fn, flush_buf) -> float:
    """Median CUDA-event time of fn() in ms, device time only: before each
    call the L2 is flushed and the device held in a spin of SPIN_CYCLES
    (~0.1 ms), so that the host has queued all of fn()'s work (the
    wrappers' checks take tens of microseconds of Python) before the start
    event is reached."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMING_ITERS):
        flush_buf.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
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
    return entries, g


def spmm_entry(label, t, x, r, flush_buf):
    """Kernel-line numbers of one launch shape of the BSDA kernel on the
    bit-packed tables `t`: r's measured error and times, the bound from
    this call's bytes (planes, src_chunk, the scale vectors present, x read
    and the output written once) and nonzeros at x's dtype's peak, and the
    torch.sparse.mm yardstick on the same weights."""
    import torch

    f = x.shape[1]
    csr, nnz = sparse_yardstick(t, x)
    try:
        library_ms = cuda_ms(lambda: torch.sparse.mm(csr, x), flush_buf)
    except RuntimeError as exc:  # no bf16 sparse product on this build
        log(f"torch.sparse.mm yardstick unavailable for {x.dtype}: {exc}")
        library_ms = None
    del csr
    scales = [v for v in (t.dst_scale, t.src_scale) if v is not None]
    bytes_moved = (t.a_packed.numel() + t.src_chunk.numel() * 4
                   + sum(v.numel() * 4 for v in scales)
                   + 2 * x.numel() * x.element_size())
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = 2.0 * nnz * f / PEAK_OPS[str(x.dtype).replace("torch.", "")] * 1e3
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


def ell_kernel_phase(device, flush_buf) -> dict:
    """The ELL kernel (kernels/ell_spmm_cuda.py) on rec_k8's `aggregation:
    ell` encoding of the Elliptic-scale graph (symmetrized, mean,
    renumber_for_ell, the flat tables and their transpose), at F = 168 and
    64 f32: the forward and the transpose against the same sums in f64, each
    element within ELL_SUM_RTOL of its row's sum of |terms| (the hubs' rows
    sum ~300 terms: an f32 sum's error grows with them, ~sqrt(n) 2^-24 of
    that sum, (n - 1) 2^-24 at worst), and beside it the largest difference
    from the plain version (ell_weighted_sum and its autograd backward,
    whose index_add_ sums in an order that changes run to run); each launch
    twice bit for bit; CUDA-event medians of the kernel, the plain version
    (the transpose's: forward and backward together) and torch.sparse.mm
    on a CSR f32 of the same weights, against the bound: x read and out
    written once, the row pointers, 8 bytes a nonzero (column and weight)
    and the scales present. Returns the kernel line's entries by (table,
    F)."""
    import torch

    from elliptic_gnn_tpu_torch.graph import synthetic
    from elliptic_gnn_tpu_torch.graph.transform import symmetrize_edges
    from elliptic_gnn_tpu_torch.kernels import ell
    from elliptic_gnn_tpu_torch.kernels.ell_spmm_cuda import ell_spmm_launch
    from elliptic_gnn_tpu_torch.models import prepare_graph_ops

    data = symmetrize_edges(synthetic.generate(
        num_nodes=N_NODES, num_features=166, num_timesteps=49,
        avg_degree=N_EDGES / N_NODES, seed=0))
    t0 = time.time()
    g, _ = ell.renumber_for_ell(prepare_graph_ops(data.edge_index, data.num_nodes, "sage"))
    g = ell.with_flat_tables(g, transpose=True)
    log(f"ELL flat tables and transpose built in {time.time() - t0:.2f} s: "
        f"nnz={int(g.flat.col.numel())} widths={g.widths} zero-degree={g.n_zero_deg}")
    g = g.to(device)
    plain = dataclasses.replace(g, flat=None, flat_t=None)
    gen = torch.Generator(device=device).manual_seed(2)
    entries, failures = {}, []
    for f in (168, 64):
        x = torch.randn((g.num_nodes, f), generator=gen, device=device)
        ct = torch.randn((g.num_nodes, f), generator=gen, device=device)
        xr = x.clone().requires_grad_()
        want = ell.ell_weighted_sum(plain, xr)
        (want_t,) = torch.autograd.grad(want, xr, ct)

        def plain_fwd():
            return ell.ell_weighted_sum(plain, x)

        def plain_fwd_bwd():
            return torch.autograd.grad(ell.ell_weighted_sum(plain, xr), xr, ct)

        for name, t, inp, ref, plain_fn in (("forward", g.flat, x, want.detach(), plain_fwd),
                                            ("transpose", g.flat_t, ct, want_t,
                                             plain_fwd_bwd)):
            got = ell_spmm_launch(t, inp)
            same = torch.equal(got, ell_spmm_launch(t, inp))
            torch.cuda.synchronize()
            max_abs = float((got - ref).abs().max())
            rows = torch.repeat_interleave(
                torch.arange(t.n_rows, device=device), t.row_ptr[1:] - t.row_ptr[:-1])
            w64 = t.weight.double() * (1.0 if t.scale is None else t.scale.double()[rows])
            terms = w64[:, None] * inp.double()[t.col.long()]
            exact = torch.zeros_like(got, dtype=torch.float64).index_add_(0, rows, terms)
            mag = torch.zeros_like(exact).index_add_(0, rows, terms.abs())
            del terms
            err = float(((got.double() - exact).abs() / mag.clamp_min(1e-30)).max())
            ok = same and err <= ELL_SUM_RTOL
            ms = cuda_ms(lambda: ell_spmm_launch(t, inp), flush_buf)
            plain_ms = cuda_ms(plain_fn, flush_buf)
            n_rows, nnz = t.n_rows, int(t.col.numel())
            vals = t.weight if t.scale is None else t.weight * t.scale[rows]
            csr = torch.sparse_csr_tensor(t.row_ptr.long(), t.col.long(), vals,
                                          size=(n_rows, t.n_src))
            library_ms = cuda_ms(lambda: torch.sparse.mm(csr, inp), flush_buf)
            del csr, rows, vals, exact, mag
            bytes_moved = (2 * n_rows * f * 4 + 4 * (n_rows + 1) + 8 * nnz
                           + (4 * n_rows if t.scale is not None else 0))
            bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
            ops_ms = 2.0 * nnz * f / PEAK_OPS["float32"] * 1e3
            bound_ms = max(bytes_ms, ops_ms)
            entries[(name, f)] = dict(
                max_abs_err=max_abs, sum_rel_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=library_ms, bytes=bytes_moved, nnz=nnz, f=f)
            case = f"ell_spmm {name} F={f} f32"
            log(f"{case}: error {err:.3e} of the row's sum of |terms| (tol {ELL_SUM_RTOL:.0e}) "
                f"{'ok' if ok else 'MISMATCH'}, max_abs against the plain version "
                f"{max_abs:.3e}, two launches "
                f"{'bit-equal' if same else 'DIFFER'} | bytes={bytes_moved} nnz={nnz} "
                f"bound={bound_ms:.4f} ms kernel={ms:.4f} ms "
                f"plain{'' if name == 'forward' else ' fwd+bwd'}={plain_ms:.4f} ms "
                f"library={library_ms:.4f} ms | kernel / bound {ms / bound_ms:.2f}, "
                f"kernel / library {ms / library_ms:.2f}")
            if not ok:
                failures.append(case)
    if failures:
        fail(f"the ELL kernel disagrees with the exact sums: {failures}")
    return entries


def epilogue_phase(device, flush_buf) -> dict:
    """The SAGE-ResBN hidden-layer epilogue (kernels/resbn_epilogue.py) at
    the main path's shape, [N_NODES x 64] f32, rec_k8's dropout 0.2: the
    training forward (the column sums, then the apply pass, with u given),
    the backward (its column sums, then dz) and the eval forward (the
    apply pass on the running statistics), each timed against its bound,
    every input read once and every output written once at
    HBM_BYTES_PER_S (forward z, u, res in, out and the keep bytes out;
    backward g, z, the keep bytes in, dz out; eval z, res in, out out), and
    against the plain version on the card (SageResBN.epilogue_plain: the
    training forward with its draw, autograd's backward of it, the eval
    forward); the fused module path (the draw, then the kernels) timed
    beside it. Output, dz and the running statistics against the plain
    version (TOL f32; the gradients of scale and bias, sums of N_NODES
    rows, rtol 1e-4), every pass twice bit for bit. No PyTorch call
    computes the same function: no library time. Returns the kernel
    line's entry."""
    import copy

    import torch

    from elliptic_gnn_tpu_torch.kernels import resbn_epilogue as rk
    from elliptic_gnn_tpu_torch.models import build_model

    n, c, rate = N_NODES, 64, 0.2
    keep = 1.0 - rate
    gen = torch.Generator(device=device).manual_seed(3)
    cfg = {"hidden_dim": c, "layers": 3, "dropout": rate}
    model = build_model("sage_resbn", c, cfg,
                        generator=torch.Generator().manual_seed(0)).to(device)
    plain = copy.deepcopy(model)
    bn = model.bns[0]
    z = torch.randn((n, c), generator=gen, device=device) * 1.5 + 0.3
    res = torch.randn((n, c), generator=gen, device=device)
    u = torch.rand((n, c), generator=gen, device=device)
    ct = torch.randn((n, c), generator=gen, device=device)
    running = (bn.mean, bn.var, bn.count)

    # correctness: the module paths, fused and plain, on the same draws
    got, want = {}, {}
    for m, dest, fn in ((model, got, model.epilogue), (plain, want, plain.epilogue_plain)):
        m.train()
        zc, rc = z.clone().requires_grad_(True), res.clone().requires_grad_(True)
        o = fn(0, zc, rc, torch.Generator(device=device).manual_seed(9))
        o.backward(ct)
        m.eval()
        with torch.no_grad():
            e = fn(0, z, res)
        b = m.bns[0]
        dest.update(out=o.detach(), dz=zc.grad, dres=rc.grad, dscale=b.scale.grad,
                    dbias=b.bias.grad, mean=b.mean.clone(), var=b.var.clone(), eval=e)
    errs, ok = {}, True
    for k in got:
        tol = dict(rtol=1e-4, atol=1e-5) if k in ("dscale", "dbias") else TOL["float32"]
        errs[k] = float((got[k] - want[k]).abs().max())
        ok = ok and within(got[k], want[k], tol)

    def fused_fwd():
        stats = rk.batch_stats(z)
        return stats, rk.apply(z, res, bn.scale.detach(), bn.bias.detach(), stats, running, u,
                               keep)

    stats, (_, keep_mask) = fused_fwd()

    def fused_bwd():
        sums = rk.backward_sums(ct, z, bn.scale.detach(), bn.bias.detach(), stats,
                                keep_mask=keep_mask, keep=keep)
        return sums, rk.backward_dz(ct, z, bn.scale.detach(), bn.bias.detach(), stats,
                                    sums=sums, keep_mask=keep_mask, keep=keep)

    def fused_eval():
        return rk.apply(z, res, bn.scale.detach(), bn.bias.detach(), None, running)[0]

    same = torch.equal(fused_fwd()[1][0], fused_fwd()[1][0]) and \
        torch.equal(fused_bwd()[1], fused_bwd()[1]) and torch.equal(fused_eval(), fused_eval())
    log(f"SAGE-ResBN epilogue fused vs plain [{n} x {c} f32]: max_abs "
        + ", ".join(f"{k}={v:.3e}" for k, v in errs.items())
        + f" {'ok' if ok else 'MISMATCH'}; two launches of each pass "
        f"{'bit-equal' if same else 'DIFFER'}")
    if not ok or not same:
        fail("the SAGE-ResBN epilogue disagrees with its plain version or does not repeat")

    p_bytes = n * c * 4
    bound = {"fwd": 4.25 * p_bytes, "bwd": 3.25 * p_bytes, "eval": 3.0 * p_bytes}
    ms = {"fwd": cuda_ms(fused_fwd, flush_buf), "bwd": cuda_ms(fused_bwd, flush_buf),
          "eval": cuda_ms(fused_eval, flush_buf)}
    plain.train()
    zp = z.clone().requires_grad_(True)
    rp = res.clone().requires_grad_(True)
    params = [plain.bns[0].scale, plain.bns[0].bias]

    def plain_fwd():
        return plain.epilogue_plain(0, zp, rp, gen)

    out_p = plain_fwd()
    plain_ms = {"fwd": cuda_ms(plain_fwd, flush_buf),
                "bwd": cuda_ms(lambda: torch.autograd.grad(out_p, [zp, rp] + params, ct,
                                                           retain_graph=True), flush_buf)}
    plain.eval()
    with torch.no_grad():
        plain_ms["eval"] = cuda_ms(lambda: plain.epilogue_plain(0, z, res), flush_buf)
    model.train()
    with torch.no_grad():
        module_ms = cuda_ms(lambda: model.epilogue(0, z, res, gen), flush_buf)
    entry = {"max_abs_err": max(errs.values()), "ms": ms, "plain_ms": plain_ms,
             "bound_ms": {k: v / HBM_BYTES_PER_S * 1e3 for k, v in bound.items()},
             "bound_by": "bytes", "library_ms": None, "module_fwd_ms": module_ms,
             "shape": [n, c]}
    log(f"SAGE-ResBN epilogue [{n} x {c} f32] ms, kernels / bound / plain: "
        + "; ".join(f"{k} {ms[k]:.4f} / {entry['bound_ms'][k]:.4f} / {plain_ms[k]:.4f} "
                    f"(kernels / bound {ms[k] / entry['bound_ms'][k]:.2f}, plain / kernels "
                    f"{plain_ms[k] / ms[k]:.2f})" for k in ms)
        + f"; the module's training forward with its draw {module_ms:.4f} ms")
    return entry


EGCN_STEPS = 49           # EvolveGCN-O's snapshots: the chain's steps
EGCN_WIDTHS = (166, 256)  # a GRCU layer's input width d; its output c = 256
EGCN_FWD_TOL = dict(rtol=1e-4, atol=1e-5)  # 49 dependent f32 steps, other sums
EGCN_GRAD_REL = 1e-4      # each gradient against its largest entry


def graphed(fn):
    """fn captured as a CUDA graph (after three runs on a side stream);
    returns the graph's replay."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def egcn_phase(device, flush_buf) -> dict:
    """EvolveGCN-O's weight evolution (kernels/egcn_evolve.py) at the
    configuration's widths, d -> 256 for d = 166 and 256, 49 steps: the
    kernels' chain, forward and backward through time, against the plain
    chain (evolve_plain, autograd) on the card, twice bit for bit, the
    forward without a gradient to come equal to the kept one; the same for
    the step kernels' passes (forward_steps, backward_steps, then the
    gradient sums), which the card runs past CHAIN_MAX_D; then each
    timed (median of TIMING_ITERS CUDA-event runs): the persistent passes,
    one launch each (egcn_chain_fwd with the stacks kept, as the training
    forward runs it, and without, as the eval; egcn_chain_bwd), each
    against the step kernels' same pass captured as a CUDA graph (98 launches
    a forward, 98 a backward) and against its bound; one forward step of the
    step kernels (egcn_gates + egcn_update), one backward step (egcn_bwd_gate +
    egcn_bwd_dq), the gradient sums (egcn_wgrad + egcn_bias_sum), and the
    whole chain, captured and replayed as the K loop runs it, in the eval
    forward and in the training forward with its backward, beside the plain
    chain's (graphed too). Bounds: a forward step's six products, a backward
    step's six, the gradient sums' four a step, at the f32 peak, or the
    bytes at HBM_BYTES_PER_S (the six [d, d] weights, the [d, c] operands
    read and written). No PyTorch call computes a step: no library time.
    Returns the kernel line's entry (its launches are the main path's,
    counted in the egcn_o.yaml slice)."""
    import torch

    from elliptic_gnn_tpu_torch.kernels import egcn_evolve as ek

    steps, c = EGCN_STEPS, 256
    entry = {"shape": {"steps": steps, "d": list(EGCN_WIDTHS), "c": c}, "ms": {},
             "plain_ms": {}, "steps_ms": {}, "bound_ms": {}, "bound_by": "operations",
             "library_ms": None, "max_rel_err": 0.0}
    for d in EGCN_WIDTHS:
        if not ek.persistent(d, c):
            fail(f"the EvolveGCN-O chain at d={d} c={c} should run one launch a pass")
        gen = torch.Generator(device=device).manual_seed(d)
        p = {}
        for k in ek.PARAMS:
            shape = (d, c) if k in ("q0", "b_u", "b_r", "b_h") else (d, d)
            lim = (6.0 / sum(shape)) ** 0.5
            p[k] = ((torch.rand(shape, generator=gen, device=device) * 2 - 1) * lim
                    ).requires_grad_()
        ct = torch.randn((steps, d, c), generator=gen, device=device)
        params = list(p.values())

        def run():
            qs = ek.evolve(p, steps)
            return qs.detach(), torch.autograd.grad(qs, params, ct)

        pd = {k: v.detach() for k, v in p.items()}

        def run_steps():
            qs, kept = ek.forward_steps(pd, steps, keep=True)
            dq, dah, dau, dar = ek.backward_steps(pd, ct, qs, *kept)
            g = {"q0": dq, **ek.wgrad(dah, dau, dar, qs[:steps], kept[1]),
                 **ek.bias_sum(dah, dau, dar)}
            return qs[1:], [g[k] for k in p]

        def eval_steps():
            return ek.forward_steps(pd, steps, keep=False)[0][1:]

        want = ek.evolve_plain(p, steps)
        g_want = torch.autograd.grad(want, params, ct)
        want = want.detach()
        for path, fn, fn_eval in (("persistent", run, lambda: ek.evolve(pd, steps)),
                                  ("step kernels", run_steps, eval_steps)):
            got, g_got = fn()
            again, g_again = fn()
            same = torch.equal(got, again) and all(
                torch.equal(a, b) for a, b in zip(g_got, g_again))
            with torch.no_grad():
                same = same and torch.equal(fn_eval(), got)
            rel = {k: float((a - b).abs().max() / b.abs().max())
                   for k, a, b in zip(p, g_got, g_want)}
            rel["forward"] = float((got - want).abs().max() / want.abs().max())
            entry["max_rel_err"] = max(entry["max_rel_err"], max(rel.values()))
            ok = within(got, want, EGCN_FWD_TOL) and all(
                v <= EGCN_GRAD_REL for k, v in rel.items() if k != "forward")
            log(f"EvolveGCN-O chain d={d} c={c}, {steps} steps, {path} vs plain: max rel err "
                + ", ".join(f"{k}={v:.2e}" for k, v in rel.items())
                + f" {'ok' if ok else 'MISMATCH'}; twice and eval "
                + ('bit-equal' if same else 'DIFFER'))
            if not ok or not same:
                fail(f"the EvolveGCN-O {path} chain disagrees with the plain chain or does "
                     "not repeat")

        q = pd["q0"]
        u, r, ph, h, qn, dah, dau, dar, dqp, dq = (torch.empty_like(q) for _ in range(10))
        stack = torch.randn((steps, d, c), generator=gen, device=device)
        kept_qs, kept = ek.forward_chain(pd, steps, keep=True)
        ms = {"train_fwd_pass": cuda_ms(lambda: ek.forward_chain(pd, steps, keep=True),
                                        flush_buf),
              "eval_fwd_pass": cuda_ms(lambda: ek.forward_chain(pd, steps, keep=False),
                                       flush_buf),
              "bwd_pass": cuda_ms(lambda: ek.backward_chain(pd, ct, kept_qs, *kept), flush_buf),
              "fwd_step": cuda_ms(lambda: (ek.gates(pd, q, u, r, ph),
                                           ek.update(pd["u_h"], q, r, u, ph, h, qn)), flush_buf),
              "bwd_step": cuda_ms(lambda: (ek.bwd_gate(pd["u_h"], qn, u, h, q, r, dah, dau, dar,
                                                       dqp),
                                           ek.bwd_dq(pd, dah, dau, dar, dqp, qn, dq)), flush_buf),
              "grad_sums": cuda_ms(lambda: (ek.wgrad(stack, stack, stack, stack, stack),
                                            ek.bias_sum(stack, stack, stack)), flush_buf)}
        # the same passes a step at a time, captured as the K loop would (the
        # host's 98 launches a pass would otherwise set the pace)
        step_qs, step_kept = ek.forward_steps(pd, steps, keep=True)
        by_steps = {
            "train_fwd_pass": cuda_ms(graphed(lambda: ek.forward_steps(pd, steps, keep=True)),
                                      flush_buf),
            "eval_fwd_pass": cuda_ms(graphed(lambda: ek.forward_steps(pd, steps, keep=False)),
                                     flush_buf),
            "bwd_pass": cuda_ms(graphed(lambda: ek.backward_steps(pd, ct, step_qs, *step_kept)),
                                flush_buf)}

        # the chains as the K loop runs them: captured once, replayed
        def eval_k():
            with torch.no_grad():
                return ek.evolve(pd, steps)

        def eval_p():
            with torch.no_grad():
                return ek.evolve_plain(pd, steps)

        ms["eval_chain"] = cuda_ms(graphed(eval_k), flush_buf)
        ms["train_chain"] = cuda_ms(graphed(lambda: torch.autograd.grad(
            ek.evolve(p, steps), params, ct)), flush_buf)
        plain = {"eval_chain": cuda_ms(graphed(eval_p), flush_buf),
                 "train_chain": cuda_ms(graphed(lambda: torch.autograd.grad(
                     ek.evolve_plain(p, steps), params, ct)), flush_buf)}

        def bound(products, operands):
            return 1e3 * max(2.0 * products * d * d * c / PEAK_OPS["float32"],
                             4.0 * (6 * d * d + operands * d * c) / HBM_BYTES_PER_S)

        b = {"train_fwd_pass": steps * bound(6, 8), "eval_fwd_pass": steps * bound(6, 5),
             "bwd_pass": steps * bound(6, 7), "fwd_step": bound(6, 5), "bwd_step": bound(6, 7),
             "grad_sums": 1e3 * max(8.0 * d * d * steps * c / PEAK_OPS["float32"],
                                    4.0 * (4 * steps * d * c + 6 * d * d + 3 * d * c)
                                    / HBM_BYTES_PER_S),
             "eval_chain": steps * bound(6, 5),
             "train_chain": steps * (bound(6, 8) + bound(10, 7))}
        for k, v in ms.items():
            entry["ms"][f"{k}_d{d}"] = v
        for k, v in plain.items():
            entry["plain_ms"][f"{k}_d{d}"] = v
        for k, v in by_steps.items():
            entry["steps_ms"][f"{k}_d{d}"] = v
        for k, v in b.items():
            entry["bound_ms"][f"{k}_d{d}"] = v
        log(f"EvolveGCN-O chain d={d} c={c} ms, kernels / bound / step kernels graphed / plain: "
            + "; ".join(f"{k} {v:.4f} / {b.get(k, float('nan')):.4f} / "
                        f"{by_steps.get(k, float('nan')):.4f} / "
                        f"{plain.get(k, float('nan')):.4f}" for k, v in ms.items())
            + f" | {CARD}")
        if any(ms[k] >= by_steps[k] for k in by_steps):
            fail(f"a persistent pass of the EvolveGCN-O chain at d={d} is not faster than the "
                 f"step kernels' graphed pass: {ms} against {by_steps}")
    return entry


def shard_close(got, want, dname) -> bool:
    """f32: elementwise within TOL; bf16: within SHARD_BF16_TOL of the
    largest reference entry (a shard rounds its kernel part and its halo
    fix-up to bf16 apart, the whole-graph kernel once)."""
    if dname == "float32":
        return within(got, want, TOL["float32"])
    tol = SHARD_BF16_TOL
    return float((got - want).abs().max()) <= tol["atol"] + tol["rtol"] * float(
        want.abs().max())


def shard_kernel_phase(device, flush_buf, g):
    """The halo path's per-shard aggregation on the card, in one process:
    the rec_k8 tables `g` (Elliptic scale, symmetrized, int8, bit-packed,
    depth 3) padded with pad_bsda_chunks and partitioned with
    partition_bsda at n = 4 and n = 2; each shard's shard_local_aggregate
    (the kernel on its local split tables, the halo fix-up and the spill;
    backward: the kernel on its block-transpose tables) with its halo rows
    taken from the global x, the rows the ring would deliver. Held three
    ways: the shards' rows and the gradient of sum(out * w) summed back
    onto x against the single-device kernel (shard_close); each shard's two
    kernel launches against their plain versions (TOL); two runs of each
    shard bit for bit. Returns the launches made through the shards'
    aggregation (forward and backward, both runs) by variant."""
    import torch

    from elliptic_gnn_tpu_torch.kernels import bsda, bsda_spmm_cuda
    from elliptic_gnn_tpu_torch.parallel import shardmap_step as sm

    gen = torch.Generator(device=device).manual_seed(5)
    n0 = g.num_nodes
    launches = {"ring": 0, "banded": 0}
    failures = []
    for n in SHARD_WAYS:
        t0 = time.time()
        g_p = bsda.pad_bsda_chunks(g, n)
        sg = sm.partition_bsda(g_p, n, use_kernel=True)
        shards = [sm.shard_slice(sg, d).to(device) for d in range(n)]
        n_rows = g_p.num_chunks * g_p.chunk
        n_loc, hc = n_rows // n, sg.halo_chunks * sg.chunk
        log(f"partition n={n}: {time.time() - t0:.1f} s; {n_loc // sg.chunk} chunks a shard, "
            f"halo {sg.halo_chunks} chunks, b_ext_pad {sg.b_ext_pad}, transpose depth "
            f"{sg.depth_t}, pack {sg.a_pack}; halo fix-up chunks "
            f"{[s.hal_dst.shape[1] for s in shards]}, spill rows "
            f"{[s.res_rows.shape[1] for s in shards]}")
        for f, dname in SHARD_CASES:
            dtype = getattr(torch, dname)
            x = torch.randn((n0, f), generator=gen, device=device).to(dtype)
            w = torch.randn(f, generator=gen, device=device)
            xr = x.clone().requires_grad_(True)
            want = bsda_spmm_cuda.bsda_spmm_cuda(g, xr)
            (want.float() * w).sum().backward()
            want, want_grad = want.detach().float(), xr.grad.float()
            x_pad = torch.cat([x, x.new_zeros((n_rows - n0, f))])
            ct = w.to(dtype).expand(n_loc, f).contiguous()
            outs, grad = [], torch.zeros((n_rows, f), device=device)
            shard_ms, plain_err = [], 0.0
            for d, sd in enumerate(shards):
                lo, hi = d * n_loc - hc, (d + 1) * n_loc + hc
                x_ext = torch.cat([x_pad.new_zeros((max(-lo, 0), f)),
                                   x_pad[max(lo, 0): min(hi, n_rows)],
                                   x_pad.new_zeros((max(hi - n_rows, 0), f))])
                runs = []
                for _ in range(2):
                    before = dict(bsda_spmm_cuda.launches)
                    xe = x_ext.clone().requires_grad_(True)
                    out = sm.shard_local_aggregate(sd, xe)
                    (out.float() * w).sum().backward()
                    for k in launches:
                        launches[k] += bsda_spmm_cuda.launches[k] - before[k]
                    runs.append((out.detach(), xe.grad))
                if not (torch.equal(runs[0][0], runs[1][0])
                        and torch.equal(runs[0][1], runs[1][1])):
                    failures.append(f"n={n} shard {d} F={f} {dname}: two runs differ")
                outs.append(runs[0][0])
                grad[max(lo, 0): min(hi, n_rows)] += runs[0][1][
                    max(-lo, 0): max(-lo, 0) + min(hi, n_rows) - max(lo, 0)].float()
                # the kernel's two launches of the shard against their plain versions
                lv, tv = sm._local_view(sd), sm._transpose_view(sd)
                xl = x_ext[hc: hc + n_loc]
                ctp = torch.cat([ct.new_zeros((hc, f)), ct, ct.new_zeros(
                    (sd.b_ext_pad * sd.chunk - hc - n_loc, f))])
                for view, inp in ((lv, xl), (tv, ctp)):
                    got = bsda_spmm_cuda.bsda_dense_cuda(view, inp).float()
                    ref = bsda.bsda_dense_plain(view, inp).float()
                    plain_err = max(plain_err, float((got - ref).abs().max()))
                    if not within(got, ref, TOL[dname]):
                        failures.append(f"n={n} shard {d} F={f} {dname}: kernel vs plain")
                shard_ms.append((cuda_ms(lambda: bsda_spmm_cuda.bsda_dense_cuda(lv, xl),
                                         flush_buf),
                                 cuda_ms(lambda: bsda_spmm_cuda.bsda_dense_cuda(tv, ctp),
                                         flush_buf)))
            out_all = torch.cat(outs)[:n0].float()
            err_out = float((out_all - want).abs().max())
            err_grad = float((grad[:n0] - want_grad).abs().max())
            ok = shard_close(out_all, want, dname) and shard_close(grad[:n0], want_grad, dname)
            whole_ms = cuda_ms(lambda: bsda_spmm_cuda.bsda_dense_cuda(g, x), flush_buf)
            whole_bwd_ms = cuda_ms(lambda: bsda_spmm_cuda.bsda_dense_cuda(
                g.transpose, w.to(dtype).expand(n0, f).contiguous()), flush_buf)
            log(f"shards n={n} F={f} {dname}: against the single-device kernel max_abs "
                f"out {err_out:.3e}, grad {err_grad:.3e} ({'ok' if ok else 'MISMATCH'}); "
                f"kernel vs plain max_abs {plain_err:.3e}; kernel ms a shard forward "
                f"{[round(a, 4) for a, _ in shard_ms]}, backward "
                f"{[round(b, 4) for _, b in shard_ms]}; whole graph forward "
                f"{whole_ms:.4f} ms, transpose {whole_bwd_ms:.4f} ms")
            if not ok:
                failures.append(f"n={n} F={f} {dname}: shards against the whole graph")
    log(f"shard phase launches (shard_local_aggregate, two runs a shard): {launches}")
    if failures:
        fail(f"the halo path's shard aggregation disagrees: {failures}")
    if not all(launches.values()):
        fail(f"a BSDA variant was never launched by the shards: {launches}")
    return launches


def gspmd_kernel_phase(device, flush_buf, g):
    """The GSPMD row sharding's kernel on the card, in one process: the
    rec_k8 tables `g` (Elliptic scale, symmetrized, int8, bit-packed, depth
    3, with transposes) padded with pad_bsda_chunks at n = 4 and n = 2;
    every rank's rectangular slice (gspmd_step.bsda_row_slice) over the
    whole x, which is what the all-gather delivers: the forward (dense part
    and the slice's spill) and the transpose slice over the whole
    cotangent of sum(out * w). Held three ways: the ranks' rows and
    gradient against the whole-graph kernel's (shard_close, and whether
    the dense parts are bit-equal: the same tables and summation order);
    each rectangular launch against its plain version (TOL); two runs bit
    for bit. Prints the CUDA-event medians of a rank's slice against the
    whole graph, forward and transpose. Returns (launches by variant, both
    runs of every rank, forward and transpose; the per-case times)."""
    import torch

    from elliptic_gnn_tpu_torch.kernels import bsda, bsda_spmm_cuda
    from elliptic_gnn_tpu_torch.parallel.gspmd_step import bsda_row_slice

    gen = torch.Generator(device=device).manual_seed(6)
    n0 = g.num_nodes
    launches = {"ring": 0, "banded": 0}
    times, failures = {}, []
    dense = bsda_spmm_cuda.bsda_dense_cuda
    for n in SHARD_WAYS:
        t0 = time.time()
        g_p = bsda.pad_bsda_chunks(g, n)
        n_rows = g_p.num_chunks * g_p.chunk
        n_loc = n_rows // n
        views = [(bsda_row_slice(g_p, n, d).to(device),
                  bsda_row_slice(g_p.transpose, n, d).to(device)) for d in range(n)]
        log(f"GSPMD slices n={n}: {time.time() - t0:.1f} s; {n_loc // g_p.chunk} destination "
            f"chunks a rank of {g_p.num_chunks}; spill rows a rank "
            f"{[0 if v.residual_rows is None else v.residual_rows.numel() for v, _ in views]}")
        for f, dname in SHARD_CASES:
            dtype = getattr(torch, dname)
            x = torch.randn((n0, f), generator=gen, device=device).to(dtype)
            w = torch.randn(f, generator=gen, device=device)
            xr = x.clone().requires_grad_(True)
            want = bsda_spmm_cuda.bsda_spmm_cuda(g, xr)
            (want.float() * w).sum().backward()
            want, want_grad = want.detach().float(), xr.grad.float()
            x_all = torch.cat([x, x.new_zeros((n_rows - n0, f))])
            ct_all = w.to(dtype).expand(n_rows, f).contiguous()
            whole_fwd, whole_bwd = dense(g_p, x_all), dense(g_p.transpose, ct_all)
            outs, grads, bit_equal, plain_err, rank_ms = [], [], True, 0.0, []
            for d, (fv, tv) in enumerate(views):
                rows = slice(d * n_loc, (d + 1) * n_loc)
                runs = []
                for _ in range(2):
                    before = dict(bsda_spmm_cuda.launches)
                    out = bsda.bsda_forward(fv, x_all, dense, n_out=n_loc)
                    dx = bsda.bsda_forward(tv, ct_all, dense, n_out=n_loc)
                    for k in launches:
                        launches[k] += bsda_spmm_cuda.launches[k] - before[k]
                    runs.append((out, dx))
                if not (torch.equal(runs[0][0], runs[1][0])
                        and torch.equal(runs[0][1], runs[1][1])):
                    failures.append(f"n={n} rank {d} F={f} {dname}: two runs differ")
                outs.append(runs[0][0])
                grads.append(runs[0][1])
                for view, inp, whole in ((fv, x_all, whole_fwd), (tv, ct_all, whole_bwd)):
                    got = dense(view, inp, n_loc)
                    bit_equal = bit_equal and torch.equal(got, whole[rows])
                    ref = bsda.bsda_dense_plain(view, inp, n_loc).float()
                    plain_err = max(plain_err, float((got.float() - ref).abs().max()))
                    if not within(got.float(), ref, TOL[dname]):
                        failures.append(f"n={n} rank {d} F={f} {dname}: kernel vs plain")
                rank_ms.append((cuda_ms(lambda: dense(fv, x_all, n_loc), flush_buf),
                                cuda_ms(lambda: dense(tv, ct_all, n_loc), flush_buf)))
            out_all = torch.cat(outs)[:n0].float()
            grad_all = torch.cat(grads)[:n0].float()
            err_out = float((out_all - want).abs().max())
            err_grad = float((grad_all - want_grad).abs().max())
            ok = shard_close(out_all, want, dname) and shard_close(grad_all, want_grad, dname)
            whole_ms = cuda_ms(lambda: dense(g_p, x_all), flush_buf)
            whole_bwd_ms = cuda_ms(lambda: dense(g_p.transpose, ct_all), flush_buf)
            times[(n, f, dname)] = dict(rank_fwd=[a for a, _ in rank_ms],
                                        rank_bwd=[b for _, b in rank_ms],
                                        whole_fwd=whole_ms, whole_bwd=whole_bwd_ms)
            log(f"GSPMD ranks n={n} F={f} {dname}: against the whole graph max_abs out "
                f"{err_out:.3e}, grad {err_grad:.3e} ({'ok' if ok else 'MISMATCH'}); dense "
                f"parts {'bit-equal to' if bit_equal else 'NOT bit-equal to'} the whole "
                f"graph's rows; kernel vs plain max_abs {plain_err:.3e}; kernel ms a rank "
                f"forward {[round(a, 4) for a, _ in rank_ms]}, transpose "
                f"{[round(b, 4) for _, b in rank_ms]}; whole graph forward {whole_ms:.4f} ms, "
                f"transpose {whole_bwd_ms:.4f} ms")
            if not ok:
                failures.append(f"n={n} F={f} {dname}: ranks against the whole graph")
    log(f"GSPMD kernel phase launches (every rank's slice, forward and transpose, two "
        f"runs): {launches}")
    if failures:
        fail(f"the GSPMD row sharding's rectangular launches disagree: {failures}")
    if not all(launches.values()):
        fail(f"a BSDA variant was never launched by the GSPMD slices: {launches}")
    return launches, times


def arch_kernel_phase(device, flush_buf):
    """The BSDA kernel at the launch shapes of gcn.yaml (self-looped
    directed tables with dst and src scales together; F = 128 and the F = 2
    logits, bf16 under amp), egcn_o.yaml (the same tables, F = 256 f32) and
    sage.yaml (directed tables; F = 167 and 128, bf16), forward and
    transpose tables against the plain version. Returns the kernel-line
    entries by (kind, F), timed on the forward tables."""
    import torch

    from elliptic_gnn_tpu_torch.kernels import bsda, bsda_spmm_cuda

    gen = torch.Generator(device=device).manual_seed(3)
    entries, failures = {}, []
    bf16, f32 = torch.bfloat16, torch.float32
    for kind, widths in (("gcn", ((128, bf16), (2, bf16), (256, f32))),
                         ("sage", ((167, bf16), (128, bf16)))):
        g = elliptic_tables(device, kind, symmetrize=False)
        scales = "+".join(n for n in ("dst_scale", "src_scale")
                          if getattr(g, n) is not None)
        log(f"{kind} tables (directed): chunks={g.num_chunks} depth={g.depth} "
            f"pack={g.a_pack} scales={scales}")
        for f, dtype in widths:
            dname = str(dtype).replace("torch.", "")
            tol = TOL[dname]
            x = torch.randn((g.num_nodes, f), generator=gen, device=device).to(dtype)
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
                    failures.append(f"{kind} F={f} {dname}"
                                    f"{'' if same else ' (two launches differ)'}")
            r = dict(max_abs=max(errs),
                     ms=cuda_ms(lambda: bsda_spmm_cuda.bsda_dense_cuda(g, x), flush_buf),
                     plain_ms=cuda_ms(lambda: bsda.bsda_dense_plain(g, x), flush_buf))
            log(f"kernel vs plain [{kind} F={f} {dname}, {scales}]: max_abs forward "
                f"{errs[0]:.3e}, transpose {errs[1]:.3e} (tol rtol={tol['rtol']:.3g} "
                f"atol={tol['atol']:.3g})")
            entries[(kind, f)] = spmm_entry(
                f"{kind} tables' shape F={f} {dname}, forward tables", g, x, r, flush_buf)
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
    sweep over the forward tables `g`, which writes G2, and the source sweep
    over g.transpose, each against its plain version (the destination
    sweep's: grad_payload and gat_bwd_dst_plain), G2 against grad_payload,
    their sum against the one-sweep kernel, two launches of each bit for
    bit; returns the kernel-line entries by name."""
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

            def dst():
                return gat_cuda.gat_bwd_dst_cuda(g, gbar, pay, out_k, h, ch, 0.2, normalized)

            def dst_plain():
                return gat_cuda.gat_bwd_dst_fused_plain(g, gbar, pay, out_k, h, ch, 0.2,
                                                        normalized)

            (d_dst, g2), (again, g2_again) = dst(), dst()

            def src():
                return gat_cuda.gat_bwd_src_cuda(t, pay, g2, h, ch, 0.2)

            d_src = src()
            torch.cuda.synchronize()
            want_dst, want_g2 = dst_plain()
            g2_ref = grad_payload(gbar, pay, out_k, h, ch, normalized)
            want_src = gat_cuda.gat_bwd_src_plain(t, pay, g2, h, ch, 0.2)
            one = gat_cuda.gat_bwd_cuda(g, gbar, pay, out_k, h, ch, 0.2, normalized)
            err_dst = float((d_dst - want_dst).abs().max())
            err_g2 = float((g2 - g2_ref).abs().max())
            err_src = float((d_src - want_src).abs().max())
            err_one = float((d_dst + d_src - one).abs().max())
            own_columns = not bool(d_dst[:, : hc + h].any() or d_src[:, hc + h:].any())
            same = (torch.equal(d_dst, again) and torch.equal(g2, g2_again)
                    and torch.equal(d_src, src()))
            ok = (bool(torch.isfinite(d_dst).all() and torch.isfinite(d_src).all()
                       and torch.isfinite(g2).all())
                  and within(d_dst, want_dst, GAT_BWD_TOL)
                  and within(g2, want_g2, GAT_BWD_TOL) and torch.equal(want_g2, g2_ref)
                  and within(d_src, want_src, GAT_BWD_TOL)
                  and within(d_dst + d_src, one, GAT_BWD_TOL) and own_columns)
            case = f"gat two-sweep[h={h}] normalized={normalized}"
            log(f"kernel vs plain [{case}]: max_abs d a_dst={err_dst:.3e} G2 vs "
                f"grad_payload={err_g2:.3e} src={err_src:.3e}, dst + src vs one-sweep "
                f"kernel {err_one:.3e} (tol rtol={GAT_BWD_TOL['rtol']:.3g} "
                f"atol={GAT_BWD_TOL['atol']:.3g}) {'ok' if ok else 'MISMATCH'}; two "
                f"launches of each {'bit-equal' if same else 'DIFFER'}")
            if not ok or not same:
                failures.append(case)
            if not normalized:
                continue  # the main path's forward normalizes in the kernel
            times = dict(
                dst=cuda_ms(dst, flush_buf), src=cuda_ms(src, flush_buf),
                dst_plain=cuda_ms(dst_plain, flush_buf),
                src_plain=cuda_ms(lambda: gat_cuda.gat_bwd_src_plain(
                    t, pay, g2, h, ch, 0.2), flush_buf),
                g2=cuda_ms(lambda: grad_payload(gbar, pay, out_k, h, ch, True),
                           flush_buf),
                one=cuda_ms(lambda: gat_cuda.gat_bwd_cuda(
                    g, gbar, pay, out_k, h, ch, 0.2, True), flush_buf),
                two=cuda_ms(lambda: gat_cuda.gat_bwd_two_sweep(
                    g, gbar, pay, out_k, h, ch, 0.2, True), flush_buf))
            log(f"backward of one layer [h={h}]: one-sweep kernel {times['one']:.4f} ms; "
                f"two-sweep {times['two']:.4f} ms = dst with G2 {times['dst']:.4f} + src "
                f"{times['src']:.4f} ms; grad_payload alone (plain torch, the work the "
                f"dst kernel took in) {times['g2']:.4f} ms")
            # columns the dst sweep must touch: gbar's acc and s, out_k's val,
            # m and s, the payload's a_dst (own rows) and xp, a_src (streamed),
            # G2 and d a_dst written
            entries[f"gat_bwd_dst[h={h}]"] = dict(
                max_abs_err=max(err_dst, float((g2 - want_g2).abs().max())),
                ms=times["dst"], plain_ms=times["dst_plain"], grad_payload_ms=times["g2"],
                **bound(planes_read["dst"],
                        (hc + h) + (hc + 2 * h) + h + (hc + h) + (hc + 3 * h) + h,
                        4.0 * nnz * hc + 2.0 * n_pad * hc))
            entries[f"gat_bwd_src[h={h}]"] = dict(
                max_abs_err=err_src, ms=times["src"], plain_ms=times["src_plain"],
                **bound(planes_read["src"], (hc + 3 * h) + 2 * (hc + h),
                        6.0 * nnz * hc))
        del pay, gbar, out_k, g2, d_dst, d_src, want_dst, want_src, one, again, g2_again
    if failures:
        fail(f"two-sweep GAT backward fails its checks: {failures}")
    for name, e in entries.items():
        log(f"{name}: bytes={e['bytes']} bound={e['bound_ms']:.4f} ms "
            f"({e['bound_by']}) kernel={e['ms']:.4f} ms plain={e['plain_ms']:.4f} ms "
            "library=none (no single PyTorch call computes this function) | "
            f"kernel / bound {e['ms'] / e['bound_ms']:.2f}")
    return entries


def gat_mesh_kernel_phase(device, flush_buf, g):
    """GAT on a mesh, the rectangular launches of the four GAT kernels on
    the card, in one process: the gat.yaml tables `g` (Elliptic scale,
    directed, self-looped, depth 4, with the transpose) padded at n = 4
    and n = 2, at (h, ch) = (4, 8) (the forward with the slot cover) and
    (1, 2). Every GSPMD rank's slice (row_sharded_bsda: its destination
    chunks over every payload row, what the all-gather delivers; the
    source sweep on its transpose slice over every G2 row) and every halo
    shard (its whole table over its halo-extended rows, taken from the
    whole payload as the ring delivers them; the source sweep on the block
    transpose over the ext grid, its G2 rows at their ext offset): the
    forward, the one-sweep backward, the destination sweep and the source
    sweep, each against its plain version (GAT_FWD_TOL on val and
    m + log s, GAT_BWD_TOL), and the ranks' forward rows, G2, d a_dst and
    source-sweep rows against the whole graph's launch (bit-equal: the same
    tables and order), the shards' within the plain tolerances. Prints a
    rank's and a shard's kernel ms beside the whole graph's. Returns
    (launches by counter, {(kernel, h, n): {"gspmd", "halo", "whole"}})."""
    import torch

    from elliptic_gnn_tpu_torch.kernels import bsda, gat_cuda
    from elliptic_gnn_tpu_torch.parallel import gspmd_step, shardmap_step as sm

    gen = torch.Generator(device=device).manual_seed(9)
    launches = {k: 0 for k in gat_cuda.launches}
    times, failures = {}, []

    def close_fwd(got, want, h, ch):
        return all(within(a, b, GAT_FWD_TOL) for a, b in
                   zip(gauge_free(got, h, ch, True), gauge_free(want, h, ch, True)))

    def calls(fwd_g, src_g, pay, gbar, out, g2_src, row0, t_row0):
        """The four launches of one rank or shard, by kernel name."""
        return {
            "fwd": lambda: gat_cuda.gat_fwd_cuda(fwd_g, pay, h, ch, 0.2, True,
                                                 dst_row0=row0),
            "bwd": lambda: gat_cuda.gat_bwd_cuda(fwd_g, gbar, pay, out, h, ch, 0.2, True,
                                                 row0),
            "dst": lambda: gat_cuda.gat_bwd_dst_cuda(fwd_g, gbar, pay, out, h, ch, 0.2,
                                                     True, None, row0),
            "src": lambda: gat_cuda.gat_bwd_src_cuda(src_g, pay, g2_src, h, ch, 0.2, None,
                                                     t_row0)}

    def check(where, fwd_g, src_g, pay, gbar, g2_src, row0, t_row0, own, whole):
        """Runs one rank's or shard's launches, holds them against their
        plain versions and the whole graph's rows `own` (`whole`: the whole
        graph's results, held bit for bit, or None: the forward within the
        plain tolerance); returns its per-kernel ms."""
        before = dict(gat_cuda.launches)
        out = gat_cuda.gat_fwd_cuda(fwd_g, pay, h, ch, 0.2, True, dst_row0=row0)
        ct = gat_cuda.gat_bwd_cuda(fwd_g, gbar, pay, out, h, ch, 0.2, True, row0)
        ct_d, g2 = gat_cuda.gat_bwd_dst_cuda(fwd_g, gbar, pay, out, h, ch, 0.2, True,
                                             None, row0)
        ct_s = gat_cuda.gat_bwd_src_cuda(src_g, pay, g2_src, h, ch, 0.2, None, t_row0)
        torch.cuda.synchronize()
        for k in launches:
            launches[k] += gat_cuda.launches[k] - before[k]
        hc = h * ch
        if not close_fwd(out, gat_cuda.gat_fwd_plain(fwd_g, pay, h, ch, 0.2, True, row0),
                         h, ch):
            failures.append(f"{where}: gat_fwd vs plain")
        if not within(ct, gat_cuda.gat_bwd_plain(fwd_g, gbar, pay, out, h, ch, 0.2, True,
                                                 row0), GAT_BWD_TOL):
            failures.append(f"{where}: gat_bwd vs plain")
        want_d, want_g2 = gat_cuda.gat_bwd_dst_fused_plain(fwd_g, gbar, pay, out, h, ch,
                                                           0.2, True, row0)
        if not (within(ct_d, want_d, GAT_BWD_TOL) and within(g2, want_g2, GAT_BWD_TOL)):
            failures.append(f"{where}: gat_bwd_dst vs plain")
        if not within(ct_s, gat_cuda.gat_bwd_src_plain(src_g, pay, g2_src, h, ch, 0.2,
                                                       t_row0), GAT_BWD_TOL):
            failures.append(f"{where}: gat_bwd_src vs plain")
        if whole is not None:
            out_w, ct_d_w, g2_w, src_w = whole
            same = (torch.equal(out, out_w[own]) and torch.equal(g2, g2_w[own])
                    and torch.equal(ct_d[own][:, hc + h:], ct_d_w[own][:, hc + h:])
                    and torch.equal(ct_s[own][:, : hc + h], src_w[own][:, : hc + h]))
            if not same:
                failures.append(f"{where}: not bit-equal to the whole graph's rows")
        elif not close_fwd(out, w_out[own], h, ch):
            failures.append(f"{where}: forward rows against the whole graph's")
        return {k: cuda_ms(fn, flush_buf) for k, fn in calls(
            fwd_g, src_g, pay, gbar, w_out[own], g2_src, row0, t_row0).items()}

    for n in SHARD_WAYS:
        t0 = time.time()
        g_p = bsda.pad_bsda_chunks(g, n)
        n_rows = g_p.num_chunks * g_p.chunk
        n_loc = n_rows // n
        ranks = [gspmd_step.row_sharded_bsda(g_p, n, d).to(device) for d in range(n)]
        sg = sm.partition_bsda(g_p, n, use_kernel=True)
        shards = [sm.shard_slice(sg, d).to(device) for d in range(n)]
        hc_rows, rows_ext = sg.halo_chunks * sg.chunk, sg.b_ext_pad * sg.chunk
        log(f"GAT mesh tables n={n}: {time.time() - t0:.1f} s; {n_loc // g_p.chunk} "
            f"destination chunks a rank or shard of {g_p.num_chunks}; halo "
            f"{sg.halo_chunks} chunks, b_ext_pad {sg.b_ext_pad}, transpose depth "
            f"{sg.depth_t}; spill rows a rank "
            f"{[0 if r.fwd.residual_rows is None else r.fwd.residual_rows.numel() for r in ranks]}, "
            f"a shard {[s.res_rows.shape[1] for s in shards]}")
        for h, ch in ((4, 8), (1, 2)):
            width = gat_cuda.payload_width(h, ch)
            pay = torch.randn((n_rows, width), generator=gen, device=device)
            gbar = torch.randn((n_rows, width), generator=gen, device=device)
            w_out = gat_cuda.gat_fwd_cuda(g_p, pay, h, ch, 0.2, True)
            w_ct_d, w_g2 = gat_cuda.gat_bwd_dst_cuda(g_p, gbar, pay, w_out, h, ch, 0.2, True)
            w_src = gat_cuda.gat_bwd_src_cuda(g_p.transpose, pay, w_g2, h, ch, 0.2)
            whole = (w_out, w_ct_d, w_g2, w_src)
            whole_ms = {k: cuda_ms(fn, flush_buf) for k, fn in calls(
                g_p, g_p.transpose, pay, gbar, w_out, w_g2, 0, 0).items()}
            rank_ms, shard_ms = [], []
            for d, rs in enumerate(ranks):
                own = slice(d * n_loc, (d + 1) * n_loc)
                rank_ms.append(check(f"n={n} (h, ch)=({h}, {ch}) rank {d}", rs.fwd, rs.bwd,
                                     pay, gbar[own], w_g2, d * n_loc, d * n_loc, own, whole))
            for d, sd in enumerate(shards):
                own = slice(d * n_loc, (d + 1) * n_loc)
                idx = (torch.arange(-hc_rows, n_loc + hc_rows, device=device)
                       + d * n_loc) % n_rows
                ext = torch.cat([pay[idx], pay.new_zeros((rows_ext - idx.numel(), width))])
                g2_ext = torch.nn.functional.pad(
                    w_g2[own], (0, 0, hc_rows, rows_ext - hc_rows - n_loc))
                shard_ms.append(check(f"n={n} (h, ch)=({h}, {ch}) shard {d}",
                                      sm._gat_view(sd), sm._transpose_view(sd), ext,
                                      gbar[own], g2_ext, hc_rows, 0, own, None))
            for k in ("fwd", "bwd", "dst", "src"):
                times[(k, h, n)] = {"gspmd": [m[k] for m in rank_ms],
                                    "halo": [m[k] for m in shard_ms], "whole": whole_ms[k]}
                log(f"GAT mesh launches n={n} (h, ch)=({h}, {ch}) {k}: kernel ms a rank "
                    f"{[round(m[k], 4) for m in rank_ms]}, a shard "
                    f"{[round(m[k], 4) for m in shard_ms]}; whole graph {whole_ms[k]:.4f} ms")
    log(f"GAT mesh kernel phase launches (checks, not timing): {launches}")
    if failures:
        fail(f"the GAT kernels' rectangular launches disagree: {failures}")
    if not all(launches.values()):
        fail(f"a GAT kernel was never launched by the mesh phase: {launches}")
    return launches, times


def wide_gat_phase(device, flush_buf, g) -> None:
    """GAT wider than one launch (h*ch + 2h > 512 columns), on the
    Elliptic-scale GAT tables `g`: the four kernels at (4, 128) (two launches
    of two heads) and (1, 600) (two column tiles of one head) against their
    plain versions in both gauges, the two sweeps twice bit for bit; then a
    training step and an eval pass of a GAT of 4 heads of 128 through the
    kernels, with both backwards, launch counts read, against the plain
    version on the card."""
    import torch

    from elliptic_gnn_tpu_torch import kernels
    from elliptic_gnn_tpu_torch.kernels import gat_cuda
    from elliptic_gnn_tpu_torch.models import build_model

    n_pad = g.num_chunks * g.chunk
    gen = torch.Generator(device=device).manual_seed(9)
    failures = []
    for h, ch in ((4, 128), (1, 600)):
        width = gat_cuda.payload_width(h, ch)
        tiles = gat_cuda.width_tiles(h, ch)
        # inputs of variance sqrt(8 / ch): the head dot xp_j . A_i then has
        # the variance it has at (4, 8) with unit inputs, so that the f32
        # rounding of its ch products is held to the same tolerance
        sd = (8.0 / ch) ** 0.25
        pay = sd * torch.randn((n_pad, width), generator=gen, device=device)
        gbar = sd * torch.randn((n_pad, width), generator=gen, device=device)
        for normalized in (True, False):
            kernels.launch_counts(reset=True)
            out_k = gat_cuda.gat_fwd_cuda(g, pay, h, ch, 0.2, normalized)
            one = gat_cuda.gat_bwd_cuda(g, gbar, pay, out_k, h, ch, 0.2, normalized)
            d_dst, g2 = gat_cuda.gat_bwd_dst_cuda(g, gbar, pay, out_k, h, ch, 0.2,
                                                  normalized)
            d_src = gat_cuda.gat_bwd_src_cuda(g.transpose, pay, g2, h, ch, 0.2)
            two = gat_cuda.gat_bwd_two_sweep(g, gbar, pay, out_k, h, ch, 0.2, normalized)
            counts = dict(gat_cuda.launches)
            same = torch.equal(two, gat_cuda.gat_bwd_two_sweep(
                g, gbar, pay, out_k, h, ch, 0.2, normalized))
            torch.cuda.synchronize()
            n = len(tiles)  # launches a call: fwd, bwd, dst, src, then both sweeps
            want_counts = {"gat_fwd": 0 if h >= 2 else n, "gat_fwd_gated": n if h >= 2 else 0,
                           "gat_bwd": n, "gat_bwd_dst": 2 * n, "gat_bwd_src": 2 * n}
            errs, ok = {}, same and counts == want_counts
            want = gat_cuda.gat_fwd_plain(g, pay, h, ch, 0.2, normalized)
            for name, a, b in zip(("val", "m+log s"), gauge_free(out_k, h, ch, normalized),
                                  gauge_free(want, h, ch, normalized)):
                errs[name] = float((a - b).abs().max())
                ok = ok and within(a, b, GAT_FWD_TOL)
            want = gat_cuda.gat_bwd_plain(g, gbar, pay, out_k, h, ch, 0.2, normalized)
            want_dst, want_g2 = gat_cuda.gat_bwd_dst_fused_plain(
                g, gbar, pay, out_k, h, ch, 0.2, normalized)
            want_src = gat_cuda.gat_bwd_src_plain(g.transpose, pay, g2, h, ch, 0.2)
            for name, a, b, tol in (("gat_bwd", one, want, GAT_BWD_TOL),
                                    ("two-sweep", two, want, GAT_BWD_TOL),
                                    ("d a_dst", d_dst, want_dst, GAT_BWD_TOL),
                                    ("G2", g2, want_g2, GAT_BWD_TOL),
                                    ("src", d_src, want_src, GAT_BWD_TOL)):
                errs[name] = float((a - b).abs().max())
                ok = ok and bool(torch.isfinite(a).all()) and within(a, b, tol)
            case = f"wide GAT (h={h}, ch={ch}, {len(tiles)} launches) normalized={normalized}"
            log(f"kernels vs plain [{case}]: max_abs " + ", ".join(
                f"{k}={v:.3e}" for k, v in errs.items())
                + f" {'ok' if ok else 'MISMATCH'}; launches {counts}; two-sweep twice "
                f"{'bit-equal' if same else 'DIFFER'}")
            if not ok:
                failures.append(case)
            if normalized:
                ms = {name: cuda_ms(fn, flush_buf) for name, fn in (
                    ("fwd", lambda: gat_cuda.gat_fwd_cuda(g, pay, h, ch, 0.2, True)),
                    ("bwd", lambda: gat_cuda.gat_bwd_cuda(g, gbar, pay, out_k, h, ch, 0.2,
                                                          True)),
                    ("dst", lambda: gat_cuda.gat_bwd_dst_cuda(g, gbar, pay, out_k, h, ch,
                                                              0.2, True)),
                    ("src", lambda: gat_cuda.gat_bwd_src_cuda(g.transpose, pay, g2, h, ch,
                                                              0.2)))}
                log(f"wide GAT (h={h}, ch={ch}) ms, all launches of a call: " + ", ".join(
                    f"{k} {v:.4f}" for k, v in ms.items()))
        del pay, gbar, out_k, one, d_dst, g2, d_src, two, want, want_dst, want_g2, want_src
    if failures:
        fail(f"the GAT kernels disagree with their plain versions past 512 columns: "
             f"{failures}")

    cfg = {"hidden_dim": 512, "layers": 2, "heads": 4, "dropout": 0.0}
    x = torch.randn((g.num_nodes, 167), generator=gen, device=device)
    y = torch.randint(0, 2, (g.num_nodes,), generator=gen, device=device)
    model = build_model("gat", 167, cfg,
                        generator=torch.Generator().manual_seed(0)).to(device)
    results = {}
    for name, run, two_sweep in (("one-sweep", model, False), ("two-sweep", model, True),
                                 ("plain", model.forward_plain, False)):
        with two_sweep_backward() if two_sweep else contextlib.nullcontext():
            model.train().zero_grad(set_to_none=True)
            kernels.launch_counts(reset=True)
            torch.nn.functional.cross_entropy(run(x, g), y).backward()
            model.eval()
            with torch.no_grad():
                scores = run(x, g)
            counts = dict(gat_cuda.launches)
        results[name] = ([p.grad.clone() for p in model.parameters()], scores, counts)
        log(f"wide GAT model (hidden 512, 4 heads of 128) {name}: training step and eval "
            f"pass, launches {counts}")
    bwd = {"one-sweep": ("gat_bwd",), "two-sweep": ("gat_bwd_dst", "gat_bwd_src")}
    for name, keys in bwd.items():
        counts = results[name][2]
        # two launches of the hidden layer and one of the final layer a pass
        if counts["gat_fwd_gated"] != 4 or counts["gat_fwd"] != 2 or \
                any(counts[k] != 3 for k in keys):
            fail(f"the wide GAT model's {name} step did not run through the kernels: "
                 f"{counts}")
    if any(results["plain"][2].values()):
        fail("the plain version of the wide GAT model launched a kernel")
    grads_p, scores_p, _ = results["plain"]
    for name in bwd:
        grads, scores, _ = results[name]
        err = max(float((a - b).abs().max()) for a, b in zip(grads, grads_p))
        ok = within(scores, scores_p, GAT_FWD_TOL) and all(
            within(a, b, GAT_BWD_TOL) for a, b in zip(grads, grads_p))
        log(f"wide GAT model {name} vs plain version on the card: logits max_abs="
            f"{float((scores - scores_p).abs().max()):.3e}, parameter gradients max_abs="
            f"{err:.3e} {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"the wide GAT model's {name} step disagrees with its plain version")


def hub_phase(device) -> None:
    """The four edge-list kernels on a 700-node graph in which one chunk
    holds thousands of dense edges (several edge lists, many gather batches,
    a row of 300 sources) and one chunk none: against their plain versions,
    and two launches bit for bit. The three backwards on the same graph
    with the out-hub: the source sweep's transpose list of chunk 1 exceeds
    one list and its row 9 (300 destinations) several gather batches; the
    one-sweep backward adds hundreds of edges into that source by atomics;
    the destination sweep walks the hub rows and writes G2, which the
    source sweep reads."""
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
    g = bsda.build_bsda_for_kind(hub_edges(n, seed=11, out_hub=True), n, "gat",
                                 depth=4, transpose=True).to(device)
    t = g.transpose
    out_list, fan = int((t.a[1] != 0).sum()), int((t.a[1, :, 9] != 0).sum())
    if out_list <= 2048 or fan <= 256:
        fail(f"the out-hub graph's transpose chunk 1 holds {out_list} edges and its "
             f"row 9 {fan}, not > 2048 and > 256")
    for h, ch in ((4, 8), (1, 2)):
        hc, width = h * ch, gat_cuda.payload_width(h, ch)
        pay = torch.randn((n_pad, width), generator=gen, device=device)
        gbar = torch.randn((n_pad, width), generator=gen, device=device)
        for normalized in (True, False):
            out_k = gat_cuda.gat_fwd_cuda(g, pay, h, ch, 0.2, normalized)
            got = gat_cuda.gat_bwd_cuda(g, gbar, pay, out_k, h, ch, 0.2, normalized)
            again = gat_cuda.gat_bwd_cuda(g, gbar, pay, out_k, h, ch, 0.2, normalized)
            dst, g2 = gat_cuda.gat_bwd_dst_cuda(g, gbar, pay, out_k, h, ch, 0.2, normalized)
            dst_again, g2_again = gat_cuda.gat_bwd_dst_cuda(g, gbar, pay, out_k, h, ch, 0.2,
                                                            normalized)
            src = gat_cuda.gat_bwd_src_cuda(t, pay, g2, h, ch, 0.2)
            same_src = torch.equal(src, gat_cuda.gat_bwd_src_cuda(t, pay, g2, h, ch, 0.2))
            torch.cuda.synchronize()
            want = gat_cuda.gat_bwd_plain(g, gbar, pay, out_k, h, ch, 0.2, normalized)
            want_dst, want_g2 = gat_cuda.gat_bwd_dst_fused_plain(g, gbar, pay, out_k, h, ch,
                                                                 0.2, normalized)
            want_src = gat_cuda.gat_bwd_src_plain(t, pay, g2, h, ch, 0.2)
            same_dst = torch.equal(got[:, hc + h:], again[:, hc + h:])
            same_sweep = torch.equal(dst, dst_again) and torch.equal(g2, g2_again)
            ok = (bool(torch.isfinite(got).all()) and within(got, want, GAT_BWD_TOL)
                  and same_dst)
            ok_dst = (bool(torch.isfinite(dst).all() and torch.isfinite(g2).all())
                      and within(dst, want_dst, GAT_BWD_TOL)
                      and within(g2, want_g2, GAT_BWD_TOL) and same_sweep)
            ok_src = (bool(torch.isfinite(src).all()) and within(src, want_src, GAT_BWD_TOL)
                      and same_src)
            log(f"out-hub graph [h={h} ch={ch} normalized={normalized}]: gat_bwd max_abs="
                f"{float((got - want).abs().max()):.3e} {'ok' if ok else 'MISMATCH'}, d a_dst "
                f"of two launches {'bit-equal' if same_dst else 'DIFFER'}; gat_bwd_dst "
                f"max_abs d a_dst={float((dst - want_dst).abs().max()):.3e} G2="
                f"{float((g2 - want_g2).abs().max()):.3e} {'ok' if ok_dst else 'MISMATCH'}, "
                f"two launches {'bit-equal' if same_sweep else 'DIFFER'}; gat_bwd_src "
                f"max_abs={float((src - want_src).abs().max()):.3e} "
                f"{'ok' if ok_src else 'MISMATCH'}, two launches "
                f"{'bit-equal' if same_src else 'DIFFER'} (tol rtol="
                f"{GAT_BWD_TOL['rtol']:.3g} atol={GAT_BWD_TOL['atol']:.3g})")
            if not ok:
                failures.append(f"gat_bwd h={h} normalized={normalized}")
            if not ok_dst:
                failures.append(f"gat_bwd_dst h={h} normalized={normalized}")
            if not ok_src:
                failures.append(f"gat_bwd_src h={h} normalized={normalized}")
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

    from elliptic_gnn_tpu_torch import kernels
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
        kernels.launch_counts(reset=True)
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

    from elliptic_gnn_tpu_torch.kernels import bsda_gat

    _, g = small_gat_graph()
    g = g.to(device)
    h, ch = 4, 8
    hc, n, n_pad = h * ch, g.num_nodes, g.num_chunks * g.chunk
    gen = torch.Generator(device=device).manual_seed(1)
    pay = torch.randn((n_pad, hc + 2 * h), generator=gen, device=device)
    pay[n:] = 0.0
    c = torch.randn((n, hc), generator=gen, device=device)

    p_k = pay.clone().requires_grad_(True)
    val_k = g.packed_gat_route()[1](p_k, h, ch, 0.2)[:n, :hc]
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


def csv_phase(tmp, synthetic_dir) -> str:
    """The synthetic Elliptic-scale graph written as the three Elliptic CSVs
    (header-less features: txId, timestep, 166 features at 9 significant
    digits; classes with header and 1 / 2 / unknown; edge list with header;
    txIds a shuffled range of 9-digit ids), built again through the port's
    CSV branch with the native parser: graph.npz must equal the synthetic
    build's, array for array. Returns the CSV build's processed dir, which
    the slices then train from."""
    import numpy as np

    from elliptic_gnn_tpu_torch import native
    from elliptic_gnn_tpu_torch.graph import build_graph

    if not native.is_available():
        fail("the native CSV parser (native/libegnn_native.so) did not build or load")
    with np.load(os.path.join(synthetic_dir, "graph.npz")) as z:
        want = {k: z[k] for k in z.files}
    raw = os.path.join(tmp, "raw")
    os.makedirs(raw)
    n = want["x"].shape[0]
    ids = 230_000_000 + np.random.default_rng(0).permutation(n).astype(np.int64)
    labels = np.array(["unknown", "2", "1"])[want["y"] + 1]
    t0 = time.time()
    with open(os.path.join(raw, "elliptic_txs_features.csv"), "w") as fh:
        np.savetxt(fh, np.column_stack([ids, want["timestep"], want["x"]]).astype(np.float64),
                   fmt="%.9g", delimiter=",")
    with open(os.path.join(raw, "elliptic_txs_classes.csv"), "w") as fh:
        fh.write("txId,class\n")
        fh.write("\n".join(f"{i},{c}" for i, c in zip(ids.tolist(), labels.tolist())) + "\n")
    src, dst = ids[want["edge_index"][0]], ids[want["edge_index"][1]]
    with open(os.path.join(raw, "elliptic_txs_edgelist.csv"), "w") as fh:
        fh.write("txId1,txId2\n")
        fh.write("\n".join(f"{a},{b}" for a, b in zip(src.tolist(), dst.tolist())) + "\n")
    write_s = time.time() - t0
    sizes = {name: os.path.getsize(os.path.join(raw, name)) for name in sorted(os.listdir(raw))}
    t0 = time.time()
    parsed = native.parse_numeric_csv(os.path.join(raw, "elliptic_txs_features.csv"))
    parse_s = time.time() - t0
    if parsed is None or parsed.shape != (n, 168):
        fail("the native parser refused the features CSV")
    del parsed
    processed = os.path.join(tmp, "processed_csv")
    t0 = time.time()
    build_graph.main({"seed": 0, "t_max": 49, "t_train_end": 34, "t_val_end": 43,
                      "data_dir": raw, "processed_dir": processed})
    build_s = time.time() - t0
    with np.load(os.path.join(processed, "graph.npz")) as z:
        got = {k: z[k] for k in z.files}
    same = sorted(got) == sorted(want) and all(
        got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]) for k in want)
    log(f"CSV round trip: {n} nodes, {want['edge_index'].shape[1]} edges, 166 features; "
        f"wrote {sizes} in {write_s:.1f} s; native parse of the features {parse_s:.2f} s; "
        f"build_graph from the CSVs {build_s:.1f} s; graph.npz "
        f"{'equal to' if same else 'DIFFERS from'} the synthetic build's")
    if not same:
        fail("the graph built from the CSVs differs from the synthetic graph written")
    return processed


def true_launches(counted, metrics) -> dict:
    """A run's kernel launches: the counters count a captured epoch once,
    at its capture, which runs nothing; each replay of the graph launches
    every kernel recorded in it (captured launches x replays)."""
    out = dict(counted)
    for name, n in metrics.get("graph_launches", {}).items():
        out[name] = out.get(name, 0) + n * (metrics["graph_replays"] - 1)
    return out



def device_epochs(metrics) -> int:
    """Epochs the device ran: the K loop's eager epoch and every replay
    (those after a stop inside a block too); the serial loop's epochs."""
    if "graph_replays" in metrics:
        return 1 + metrics["graph_replays"]
    return metrics["epochs_run"]


def slice_phase(tmp, processed, config_name, run_name=None, epochs=EPOCHS,
                expect_epochs=True, entry=None, **overrides):
    """train_gnn.main (or `entry`, a function of the config that returns
    the metrics) on one config's values at full width for `epochs`
    epochs, launch counts set to 0 just before and read just after (the K
    loop's replays counted as true_launches counts them). `run_name`
    replaces the config's; `overrides` replace other values. Returns a
    dict: launches, metrics, cfg, outdir, losses, val_pr_auc, scores."""
    import numpy as np
    import yaml

    from elliptic_gnn_tpu_torch import kernels
    from elliptic_gnn_tpu_torch.train import train_gnn

    with open(os.path.join(HERE, "configs", config_name)) as fh:
        cfg = yaml.safe_load(fh)
    cfg.update(processed_dir=processed, output_root=os.path.join(tmp, "out"),
               max_epochs=epochs, **overrides)
    if run_name is not None:
        cfg["run_name"] = run_name
    kernels.launch_counts(reset=True)
    t0 = time.time()
    metrics = (entry or train_gnn.main)(cfg)
    wall = time.time() - t0
    launches = true_launches(kernels.launch_counts(), metrics)

    outdir = os.path.join(cfg["output_root"], "gnn", cfg["run_name"])
    n_run = int(metrics["epochs_run"])
    k = metrics.get("epochs_per_sync", 1)
    log(f"slice: {config_name} as {cfg['run_name']} ({cfg['arch']}, hidden {cfg['hidden_dim']}, "
        f"{cfg['layers']} layers, heads {cfg.get('heads', '-')}, amp {cfg['amp']}, "
        f"epochs_per_sync {cfg.get('epochs_per_sync', 'auto')} -> K={k}) ran {n_run} epochs "
        f"({device_epochs(metrics)} on the device), main() wall {wall:.1f} s, "
        f"train {metrics['train_seconds']:.3f} s")
    log("epoch wall times (s): " + ", ".join(f"{v:.4f}" for v in metrics["epoch_seconds"]))
    if "graph_replays" in metrics:
        log(f"K loop: {metrics['graph_replays']} replays of the captured epoch; launches "
            f"captured in it {metrics['graph_launches']}; device ms of one replayed epoch "
            f"per block {[round(v, 4) for v in metrics['replay_ms']]}")
    log(f"kernel launches in the run: {launches}")
    if expect_epochs and n_run != epochs:
        fail(f"{config_name} ran {n_run} epochs, not {epochs}")
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
    if not all(math.isfinite(v) for v in losses):
        fail(f"losses not finite: {losses}")
    if scores.shape != y_test.shape or not np.isfinite(scores).all() or \
            scores.min() < 0 or scores.max() > 1:
        fail("test scores are not finite probabilities of the expected shape")
    log(f"losses {losses}; val PR-AUC {val_pr_auc}; test PR-AUC "
        f"{metrics['pr_auc_illicit']:.4f}, ROC-AUC {metrics['roc_auc']:.4f} "
        f"(random weights, {n_run} epochs)")
    check_jax_ckpt(outdir, cfg)
    return dict(launches=launches, metrics=metrics, cfg=cfg, outdir=outdir,
                losses=losses, val_pr_auc=val_pr_auc, scores=scores)


def compare_runs(name, a, b, n=None) -> None:
    """Per-epoch loss and val PR-AUC of run a against run b (the first n
    epochs) within KLOOP_TOL."""
    n = len(b["losses"]) if n is None else n
    if len(a["losses"]) < n:
        fail(f"{name}: {len(a['losses'])} epochs logged, want {n}")
    loss = max(abs(x - y) for x, y in zip(a["losses"][:n], b["losses"][:n]))
    pr = max(abs(x - y) for x, y in zip(a["val_pr_auc"][:n], b["val_pr_auc"][:n]))
    log(f"{name}: {n} epochs, loss max abs {loss:.3e}, val PR-AUC max abs {pr:.3e} "
        f"(tol {KLOOP_TOL:.0e})")
    if loss > KLOOP_TOL or pr > KLOOP_TOL:
        fail(f"{name}: the runs disagree per epoch")


def stop_patience(prs, k=8):
    """The smallest patience at which the early stop on `prs` (val PR-AUC
    per epoch, no stop in them) falls inside a block of k epochs: (patience,
    stop epoch), or None."""
    for patience in range(1, len(prs)):
        best, bad = -1.0, 0
        for ep, pr in enumerate(prs, 1):
            best, bad = (pr, 0) if pr > best else (best, bad + 1)
            if bad >= patience:
                if ep % k:
                    return patience, ep
                break
    return None


def kloop_phase(tmp, processed, config_name, k_run, serial_run) -> bool:
    """The K = 8 run (k_run, KLOOP_EPOCHS, no stop) against the serial run
    of the same epochs per epoch; then both loops again with the patience at
    which the stop falls inside a block, chosen from k_run's log or, where
    val PR-AUC rose in every epoch, from a run at a 10 or 100 times larger
    step: the same stop epoch and the same rows. Returns whether a stop
    inside a block was found."""
    compare_runs(f"{config_name} K=8 against serial", k_run, serial_run)
    name, extra = k_run["cfg"]["run_name"], {}
    found = stop_patience(k_run["val_pr_auc"])
    for factor in (10, 100):
        if found is not None:
            break
        extra = {"lr": factor * float(k_run["cfg"]["lr"])}
        log(f"{config_name}: val PR-AUC rose in every epoch; a run at lr {extra['lr']}")
        probe = slice_phase(tmp, processed, config_name, f"{name}_lr{factor}",
                            epochs=KLOOP_EPOCHS, **extra)
        found = stop_patience(probe["val_pr_auc"])
    if found is None:
        log(f"{config_name}: no patience stops the {KLOOP_EPOCHS} epochs inside a block")
        return False
    patience, stop = found
    log(f"{config_name}: patience {patience} stops at epoch {stop}, inside block "
        f"{(stop - 1) // 8 + 1}" + (f", at lr {extra['lr']}" if extra else ""))
    runs = [slice_phase(tmp, processed, config_name, f"{name}_stop{k}",
                        epochs=KLOOP_EPOCHS, expect_epochs=False, patience=patience,
                        epochs_per_sync=k, **extra) for k in ("auto", 1)]
    got = [r["metrics"]["epochs_run"] for r in runs]
    if got != [stop, stop]:
        fail(f"{config_name} with patience {patience}: K loop stopped after {got[0]} "
             f"epochs, serial after {got[1]}, predicted {stop}")
    compare_runs(f"{config_name} K=8 stopped inside a block against serial", *runs)
    return True


def resume_phase(tmp, processed, uninterrupted) -> None:
    """rec_k8 stopped at its checkpoint after 8 epochs, then resumed to
    KLOOP_EPOCHS: the same rows and best_val as the uninterrupted run (which
    wrote checkpoint_every 8 too)."""
    import numpy as np

    name = "rec_k8_resumed"
    slice_phase(tmp, processed, "rec_k8.yaml", name, epochs=8, checkpoint_every=8)
    with np.load(os.path.join(tmp, "out", "gnn", name, "resume.ckpt")) as z:
        saved = int(z["__scalar__/epoch"])
    resumed = slice_phase(tmp, processed, "rec_k8.yaml", name, epochs=KLOOP_EPOCHS,
                          expect_epochs=False, checkpoint_every=8, resume=True)
    if saved != 8 or resumed["metrics"]["epochs_run"] != KLOOP_EPOCHS - 8:
        fail(f"resume: checkpoint of epoch {saved}, {resumed['metrics']['epochs_run']} "
             "epochs after it")
    compare_runs("rec_k8 stopped at epoch 8 and resumed, against one run", resumed,
                 uninterrupted)
    a = resumed["metrics"]["best_val_pr_auc"]
    b = uninterrupted["metrics"]["best_val_pr_auc"]
    log(f"resume: best_val {a:.6f}, uninterrupted {b:.6f}")
    if abs(a - b) > KLOOP_TOL:
        fail("the resumed run ends with another best_val than the uninterrupted one")


def analysis_phase(run) -> None:
    """The inline hub ablation of `run` (ablate_hubs_frac 0.05) and the
    robustness and hub-ablation CLIs on its run dir, through the kernels at
    Elliptic scale: finite metrics, kernels launched."""
    import json

    import numpy as np

    from elliptic_gnn_tpu_torch import kernels
    from elliptic_gnn_tpu_torch.analysis import hub_ablation, robustness
    from elliptic_gnn_tpu_torch.kernels import bsda_spmm_cuda

    outdir = run["outdir"]
    with open(os.path.join(outdir, "metrics_hub_removed.json")) as fh:
        inline = json.load(fh)
    results = {"inline": inline}
    for name, fn, argv in (
            ("hub_ablation", hub_ablation.main, ["--frac", "0.05"]),
            ("robustness", robustness.main, ["--drop_frac", "0.1", "--noise_std", "0.1"])):
        kernels.launch_counts(reset=True)
        t0 = time.time()
        results[name] = fn(["--run_dir", outdir] + argv)
        launched = dict(bsda_spmm_cuda.launches)
        log(f"{name} CLI on {run['cfg']['run_name']}: {time.time() - t0:.1f} s, "
            f"launches {launched}")
        if not launched["ring"] or not launched["banded"]:
            fail(f"the {name} CLI did not score through the BSDA kernel")
    for name, r in results.items():
        vals = [v for v in r.values() if isinstance(v, float)]
        log(f"{name}: " + ", ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                                    for k, v in r.items()))
        if not all(np.isfinite(vals)):
            fail(f"{name} metrics are not finite")
    want_hubs = int(0.05 * N_NODES)
    if inline["n_hubs"] != want_hubs or results["hub_ablation"]["n_hubs"] != want_hubs:
        fail(f"hub ablation removed {inline['n_hubs']} / "
             f"{results['hub_ablation']['n_hubs']} hubs, want {want_hubs}")


def report_walls(name, runs) -> None:
    """Epoch walls of runs of one config in the order run: the median of
    each run's epochs after the first block (K) or the first epoch
    (serial), and the device time of one replayed epoch."""
    import numpy as np

    for r in runs:
        m = r["metrics"]
        k = m.get("epochs_per_sync", 1)
        walls = m["epoch_seconds"][k if k > 1 else 1:]
        log(f"walls [{name} {r['cfg']['run_name']}, K={k}]: median "
            f"{1e3 * float(np.median(walls)):.3f} ms over {len(walls)} epochs"
            + (f", one replayed epoch {m['replay_ms'][-1]:.3f} ms on the device"
               if m.get("replay_ms") else ""))


def check_jax_ckpt(outdir, cfg) -> None:
    """best.ckpt in the JAX package's layout, read with numpy alone: a flat
    npz whose keys are the '/'-joined paths of the JAX model's params and
    state (params/layers/<i>/<name>, params/bns/<i>/..., state/bns/<i>/...,
    params/res_projs/<i>/w, params/time_emb), dense weights [d_in, d_out],
    BN counts 0-d. EvolveGCN-O, which the JAX package lacks, in the same
    flat form (models/convert.py): params/grcu/<i>/<name>, params/cls/<i>/{w,b}."""
    import numpy as np

    from elliptic_gnn_tpu_torch.kernels.egcn_evolve import PARAMS as EGCN_PARAMS

    with np.load(os.path.join(outdir, "best.ckpt"), allow_pickle=False) as z:
        shapes = {k: z[k].shape for k in z.files}
    arch, layers, hidden = cfg["arch"], int(cfg["layers"]), int(cfg["hidden_dim"])
    per_layer = {"gat": ("w", "a_src", "a_dst", "b"), "gcn": ("w", "b")}.get(
        arch, ("w_l", "b_l", "w_r"))
    want = {f"params/layers/{i}/{n}" for i in range(layers) for n in per_layer}
    final = f"params/layers/{layers - 1}/{per_layer[0]}"
    if arch == "egcn_o":
        want = ({f"params/grcu/{i}/{n}" for i in range(layers) for n in EGCN_PARAMS}
                | {f"params/cls/{i}/{n}" for i in range(2) for n in ("w", "b")})
        final, hidden = "params/cls/1/w", int(cfg.get("cls_feats", hidden))
    optional = set()
    if arch in ("sage_resbn", "sage_bn", "sage_res"):
        if cfg.get("use_bn", True):
            want |= {f"{tree}/bns/{i}/{n}" for i in range(layers - 1)
                     for tree, names in (("params", ("scale", "bias")),
                                         ("state", ("mean", "var", "count")))
                     for n in names}
        optional = {f"params/res_projs/{i}/w" for i in range(layers - 1)} | {"params/time_emb"}
    last = shapes.get(final, ())
    ok = (want <= set(shapes) and set(shapes) - want <= optional
          and len(last) >= 2 and last[0] == hidden and last[-1] == 2
          and all(shapes[k] == () for k in shapes if k.endswith("/count")))
    log(f"best.ckpt of {cfg['run_name']}: npz of {len(shapes)} arrays in the JAX layout "
        f"{'ok' if ok else 'WRONG'} (final layer {final} {last})")
    if not ok:
        fail(f"best.ckpt of {cfg['run_name']} is not in the JAX npz layout: {shapes}")


def check_rec_k8_launches(run) -> None:
    """Per epoch on the device: ring 6, banded 2 (three layers forward, two
    on the transpose tables, three in the val eval); the scoring pass adds
    one forward (ring 2, banded 1), the hub ablation's scoring another. The
    two hidden layers' epilogue an epoch: the training forward's sums and
    apply pass, the backward's sums and dz, the eval's apply pass, each
    twice, and the four column sums' second stage; twice a scoring pass."""
    launches, epochs = run["launches"], device_epochs(run["metrics"])
    scoring = 1 + (float(run["cfg"].get("ablate_hubs_frac", 0) or 0) > 0)
    want = {"ring": 6 * epochs + 2 * scoring, "banded": 2 * epochs + scoring,
            "resbn_stats": 2 * epochs, "resbn_finalize": 4 * epochs,
            "resbn_fwd": 2 * epochs, "resbn_eval": 2 * (epochs + scoring),
            "resbn_bwd_sums": 2 * epochs, "resbn_bwd": 2 * epochs}
    if {k: launches.get(k, 0) for k in want} != want or \
            any(v for k, v in launches.items() if k.startswith("gat")):
        fail(f"rec_k8 did not run every epoch through the BSDA kernel and the "
             f"epilogue alone: {launches} for {epochs} epochs on the device, want {want}")


def check_gat_launches(run, two_sweep=False) -> None:
    """Per epoch: the training step launches the forward twice (hidden
    layer with the slot cover, final layer without) and the backward twice
    (one a layer: the one-sweep kernel, or with `two_sweep` each of the two
    sweeps and the one-sweep kernel never), the val eval the forward
    twice; the final scoring pass adds one forward of each variant. No
    other kernel (the SAGE-ResBN epilogue's included) launches."""
    epochs = device_epochs(run["metrics"])
    want = {"gat_fwd_gated": 2 * epochs + 1, "gat_fwd": 2 * epochs + 1,
            "gat_bwd": 0 if two_sweep else 2 * epochs,
            "gat_bwd_dst": 2 * epochs if two_sweep else 0,
            "gat_bwd_src": 2 * epochs if two_sweep else 0, "ring": 0, "banded": 0}
    if {k: v for k, v in run["launches"].items() if k in want or v} != want:
        fail(f"gat.yaml did not run every epoch through the GAT kernels: "
             f"{run['launches']}, want {want}")


def check_conv_launches(name, run, per_epoch, scoring) -> None:
    """gcn.yaml: three aggregations a forward, all of one 128-lane tile (F =
    128, 128 and the 2 logits): per epoch 3 forward + 3 on the transpose
    tables + 3 val eval as `ring`, none as `banded`. sage.yaml: layer 1
    aggregates the 167 input features (`banded`, no gradient: forward + val
    eval), layer 2 F = 128 (`ring`: forward, transpose, val eval). The
    scoring pass adds one forward."""
    launches, epochs = run["launches"], device_epochs(run["metrics"])
    want = {k: per_epoch[k] * epochs + scoring[k] for k in ("ring", "banded")}
    got = {k: launches[k] for k in want}
    if got != want or any(v for k, v in launches.items() if k.startswith("gat")):
        fail(f"{name} did not run every epoch through the BSDA kernel alone: "
             f"{launches}, want {want}")


def check_egcn_launches(run) -> None:
    """egcn_o.yaml: per epoch on the device, each GRCU layer's chain of
    `max_timestep` steps runs forward twice (training, val eval: one
    egcn_chain_fwd each) and backward through time once (egcn_chain_bwd,
    then egcn_wgrad and egcn_bias_sum); each layer aggregates at F = 256
    (`banded`) forward, on the transpose tables and in the val eval. The
    scoring pass adds one forward. No other kernel launches: no step
    kernel."""
    cfg, epochs = run["cfg"], device_epochs(run["metrics"])
    chains = int(cfg["layers"])
    want = {"egcn_chain_fwd": 2 * chains * epochs + chains, "egcn_chain_bwd": chains * epochs,
            "egcn_wgrad": chains * epochs, "egcn_bias_sum": chains * epochs,
            "banded": 3 * chains * epochs + chains}
    if {k: v for k, v in run["launches"].items() if k in want or v} != want:
        fail(f"egcn_o.yaml did not run every epoch through the weight evolution's kernels "
             f"and bsda_spmm alone: {run['launches']}, want {want}")


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
    log(f"gat.yaml two-sweep: {len(two_a['losses'])} epochs twice, scores_test.npy and losses "
        f"bit-equal; against the one-sweep run: loss max rel {loss_rel:.3e} (tol "
        f"{TWO_SWEEP_LOSS_RTOL:.0e}), val PR-AUC max abs {pr_abs:.3e} (tol "
        f"{TWO_SWEEP_PR_ATOL:.0e}), test scores max abs {score_abs:.3e}")
    if loss_rel > TWO_SWEEP_LOSS_RTOL or pr_abs > TWO_SWEEP_PR_ATOL:
        fail("the two-sweep gat.yaml run disagrees with the one-sweep run")


def predict_check(outdir, want_launches) -> None:
    """predict.predict on a finished run dir reproduces the trainer's own
    test scores, launching exactly `want_launches` (every other kernel
    count 0)."""
    import numpy as np

    from elliptic_gnn_tpu_torch import kernels
    from elliptic_gnn_tpu_torch.kernels import (bsda_spmm_cuda, egcn_evolve, ell_spmm_cuda,
                                                gat_cuda)
    from elliptic_gnn_tpu_torch.train import predict

    counters = (bsda_spmm_cuda, gat_cuda, egcn_evolve, ell_spmm_cuda)
    kernels.launch_counts(reset=True)
    t0 = time.time()
    node_idx, probs, flags, thr, data = predict.predict(outdir)
    wall = time.time() - t0
    launches = {k: v for mod in counters for k, v in mod.launches.items()}
    idx = np.load(os.path.join(outdir, "node_idx_test.npy"))
    want = np.load(os.path.join(outdir, "scores_test.npy"))
    if not np.array_equal(node_idx, np.arange(data.num_nodes)):
        fail("predict did not report every node once, in on-disk order")
    err = float(np.abs(probs[idx] - want).max())
    log(f"predict on {os.path.basename(outdir)}: scored {probs.size} nodes in {wall:.1f} s "
        f"(threshold {thr:.4f}, {int(flags.sum())} flagged), launches {launches}; test "
        f"scores vs scores_test.npy max_abs={err:.3e} (tol 1e-6)")
    if err > 1e-6 or any(n != want_launches.get(k, 0) for k, n in launches.items()):
        fail(f"predict does not reproduce the trainer's test scores through its path "
             f"(want launches {want_launches})")


def no_kernel_launched(run) -> None:
    """No kernel of the BSDA or GAT path (the SAGE-ResBN epilogue runs on
    any aggregation, the ELL kernel on the full-batch ELL encoding)."""
    if any(v for k, v in run["launches"].items()
           if not k.startswith(("resbn", "ell_spmm"))):
        fail(f"{run['cfg']['run_name']} launched a kernel of the BSDA or GAT path: "
             f"{run['launches']}")


def ell_phase(tmp, processed) -> dict:
    """rec_k8 with `aggregation: ell` (the ELL kernel on the flat tables,
    renumber_for_ell) for KLOOP_EPOCHS epochs in the K loop, the epoch with
    its eight ell_spmm launches captured as a CUDA graph, and, interleaved,
    the serial loop: per epoch within KLOOP_TOL, ell_spmm 8 times an epoch
    (3 training forward, 2 backward, 3 eval) and no BSDA or GAT kernel;
    predict on the K run's dir rebuilds the encoding and reproduces its
    test scores in 3 launches. Returns the K run."""
    runs = [slice_phase(tmp, processed, "rec_k8.yaml", f"rec_k8_ell{suffix}",
                        epochs=KLOOP_EPOCHS, aggregation="ell", **extra)
            for suffix, extra in (("", {}), ("_serial", {"epochs_per_sync": 1}))]
    for run in runs:
        no_kernel_launched(run)
        n, epochs = run["launches"].get("ell_spmm", 0), device_epochs(run["metrics"])
        if n < 8 * epochs:
            fail(f"{run['cfg']['run_name']}: {n} ell_spmm launches in {epochs} epochs")
    captured = runs[0]["metrics"]["graph_launches"].get("ell_spmm")
    if captured != 8:
        fail(f"the captured ELL epoch launched ell_spmm {captured} times, not 8")
    compare_runs("rec_k8 aggregation: ell, K=8 against serial", *runs)
    report_walls("rec_k8 aggregation: ell", runs)
    predict_check(runs[0]["outdir"], {"ell_spmm": 3})
    return runs[0]


def minibatch_batch_check(cfg, device="cuda") -> None:
    """One sampled batch of rec_k8 at its fanout and batch size (the
    subgraph is the whole graph at this scale), dropout 0, the same weights
    from the seed: forward, loss and gradients on the card against the
    CPU."""
    import numpy as np
    import torch

    from elliptic_gnn_tpu_torch.models import MODEL_GRAPH_KIND, build_model
    from elliptic_gnn_tpu_torch.models.losses import class_weights, make_loss_fn
    from elliptic_gnn_tpu_torch.train import train_gnn
    from elliptic_gnn_tpu_torch.train.sampler import NeighborSampler

    cfg = dict(cfg, dropout=0.0)
    data = train_gnn.prepare_data(cfg)
    b = int(cfg["batch_size"])
    sampler = NeighborSampler(data.edge_index, data.num_nodes, cfg["fanout"], b,
                              MODEL_GRAPH_KIND[cfg["arch"]], int(cfg["seed"]))
    t0 = time.time()
    node_ids, ell, n_seed, seed_mask = sampler.sample_batch(np.where(data.train_mask)[0][:b])
    sample_s = time.time() - t0
    b = min(b, sampler.n_sub)
    t_train = data.timestep[data.train_mask]
    got = {}
    for dev in (device, "cpu"):
        model = build_model(cfg["arch"], data.num_features, cfg,
                            generator=torch.Generator().manual_seed(int(cfg["seed"])))
        model = model.to(dev).train()
        loss_fn = make_loss_fn(cfg, class_weights(data.y[data.train_mask]),
                               int(t_train.min()), int(t_train.max()), dev)
        ids = torch.from_numpy(node_ids).to(dev)
        x = torch.from_numpy(data.x).to(dev)
        t = torch.from_numpy(data.timestep.astype(np.int32)).to(dev)
        y = torch.from_numpy(np.maximum(data.y, 0).astype(np.int64)).to(dev)
        t0 = time.time()
        logits = model(x[ids], ell.to(dev), t[ids] if model.uses_time_embed else None)
        t_loss = t[ids[:b]] if str(cfg.get("time_loss_weighting", "none")) != "none" else None
        loss = loss_fn(model, logits[:b], y[ids[:b]], t_loss,
                       torch.from_numpy(seed_mask[:b]).to(dev))
        loss.backward()
        if dev == "cuda":
            torch.cuda.synchronize()
        got[dev] = (logits.detach().cpu(), loss.detach().cpu(), time.time() - t0,
                    {n: p.grad.cpu() for n, p in model.named_parameters()})
    (lg, ls, s_cuda, gr), (lg_ref, ls_ref, s_cpu, gr_ref) = got[device], got["cpu"]
    # each against the largest entry of its reference: a logit near 0, or
    # the gradient of a bias ahead of a BatchNorm (0 up to rounding), keeps
    # the absolute rounding error of the sums that made it
    logit_err = float((lg - lg_ref).abs().max() / lg_ref.abs().max())
    loss_err = float((ls - ls_ref).abs() / ls_ref.abs())
    scale = max(float(g.abs().max()) for g in gr_ref.values())
    grad_err = max(float((gr[n] - gr_ref[n]).abs().max()) for n in gr_ref) / scale
    log(f"mini-batch: one sampled batch of {n_seed} seeds, {sampler.n_sub} rows of width "
        f"{sampler.width}, sampled in {sample_s:.2f} s on the host; forward + loss + backward "
        f"{s_cuda:.3f} s on {CARD} (first call), {s_cpu:.2f} s on the CPU; errors relative "
        f"to the largest reference entry (tol {MB_RTOL:.0e}): logits {logit_err:.3e} (max abs "
        f"{float((lg - lg_ref).abs().max()):.3e} of {float(lg_ref.abs().max()):.3f}), loss "
        f"{loss_err:.3e} ({float(ls):.6f} vs {float(ls_ref):.6f}), gradients {grad_err:.3e}")
    if max(logit_err, loss_err, grad_err) > MB_RTOL:
        fail("a sampled batch's forward, loss or gradients on the card disagree with the CPU")


def minibatch_phase(tmp, processed) -> dict:
    """rec_k8 with `mini_batch: true` at its fanout and batch size for
    MB_EPOCHS epochs (sampled training and validation, the full graph
    scored through the ELL encoding, no hand-written kernel launched); then
    one batch on the card against the CPU. Returns the run."""
    run = slice_phase(tmp, processed, "rec_k8.yaml", "rec_k8_minibatch", epochs=MB_EPOCHS,
                      mini_batch=True)
    no_kernel_launched(run)
    m, cfg = run["metrics"], run["cfg"]
    log(f"mini-batch rec_k8 (fanout {cfg['fanout']}, batch {cfg['batch_size']}): budget "
        f"{m['n_sub']} rows of width {m['batch_width']}; per train batch, by epoch: sampling "
        f"{[round(v, 1) for v in m['sample_ms']]} ms on the host, step (upload, forward, "
        f"backward, Adam, loss read) {[round(v, 1) for v in m['step_ms']]} ms; epoch walls "
        f"{[round(v, 3) for v in m['epoch_seconds']]} s on {CARD}")
    minibatch_batch_check(cfg)
    return run


def profile_dir_phase(tmp, processed) -> tuple:
    """rec_k8 with `profile_dir`: `auto` K stays 8, the Chrome trace of the
    K loop's blocks 4-6 holds three `loop.block` annotations and names
    bsda_spmm_kernel (8 launches an epoch, 24 epochs), and
    <run_name>.spans.json lies beside it; then with `epochs_per_sync: 1`,
    the serial loop's trace of epochs 4-6 names bsda_spmm_kernel (3 epochs
    x 8) and holds no `loop.block`, the spans beside it. Returns the two
    runs' kernel launches (K loop, serial)."""
    prof_dir = os.path.join(tmp, "profile_dir")
    runs = []
    for name, epochs, k, blocks_want, spmm_want, extra in (
            ("rec_k8_profiled", PROFILE_DIR_EPOCHS, 8, 3, 192, {}),
            ("rec_k8_profiled_serial", PROFILE_DIR_SERIAL_EPOCHS, 1, 0, 24,
             {"epochs_per_sync": 1})):
        run = slice_phase(tmp, processed, "rec_k8.yaml", name, epochs=epochs,
                          profile_dir=prof_dir, **extra)
        check_rec_k8_launches(run)
        runs.append(run["launches"])
        path = os.path.join(prof_dir, f"{name}.trace.json")
        spans = os.path.join(prof_dir, f"{name}.spans.json")
        if run["metrics"]["epochs_per_sync"] != k or not os.path.exists(path) \
                or not os.path.exists(spans):
            fail(f"profile_dir {name}: K={run['metrics']['epochs_per_sync']} (want {k}), "
                 f"trace {'written' if os.path.exists(path) else 'missing'}, spans "
                 f"{'written' if os.path.exists(spans) else 'missing'}")
            continue
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
        kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
        blocks = sum(e.get("cat") == "user_annotation" and e.get("name") == "loop.block"
                     for e in events)
        spmm = sum("bsda_spmm_kernel" in kn for kn in kernels)
        walls = run["metrics"]["epoch_seconds"][::k]
        log(f"profile_dir {name}: {os.path.getsize(path)} bytes of Chrome trace, "
            f"{len(events)} events, {len(kernels)} kernel events, {blocks} loop.block "
            f"annotations ({blocks_want}), bsda_spmm_kernel x{spmm} ({spmm_want}); "
            f"{os.path.getsize(spans)} bytes of spans; "
            f"{'block' if k > 1 else 'epoch'} walls {[round(1e3 * v, 2) for v in walls]} "
            f"ms an epoch (4-6 traced)")
        if spmm != spmm_want or blocks != blocks_want:
            fail(f"the profile_dir trace of {name} names bsda_spmm_kernel x{spmm}, not "
                 f"{spmm_want}, or holds {blocks} loop.block spans, not {blocks_want}")
    return tuple(runs)


def sweep_phase(tmp, processed) -> dict:
    """sweep_gnn over two learning rates of rec_k8 (KLOOP_EPOCHS epochs
    each) sequentially, then with two workers on the one card: the same
    ranks and run names, metrics within SWEEP_TOL, the sequential sweep's
    combos through the kernels; walls printed. Returns the sequential
    sweep's kernel launches (in this process; each combo's replays counted
    as true_launches counts them)."""
    import yaml

    from elliptic_gnn_tpu_torch import kernels
    from elliptic_gnn_tpu_torch.kernels import bsda_spmm_cuda
    from elliptic_gnn_tpu_torch.sweeps import sweep_gnn

    with open(os.path.join(HERE, "configs", "rec_k8.yaml")) as fh:
        base = yaml.safe_load(fh)
    base.update(processed_dir=processed, max_epochs=KLOOP_EPOCHS)
    # time_embed_dim in the grid keeps the config's sin embedding: the
    # sweep's normalization turns the embedding type off in a combo without it
    grid = {"lr": [5e-4, 5e-3], "time_embed_dim": [2]}
    boards, results = {}, {}
    for workers in (1, 2):
        root = os.path.join(tmp, f"sweep_w{workers}")
        kernels.launch_counts(reset=True)
        t0 = time.time()
        rows = sweep_gnn.run_sweep(base, grid, rank_key="pr_auc_illicit",
                                   output_root=root, workers=workers)
        wall = time.time() - t0
        with open(os.path.join(root, "sweeps", "leaderboard.tsv")) as fh:
            boards[workers] = [line.split("\t")[:2] for line in fh.read().splitlines()[1:]]
        results[workers] = rows
        log(f"sweep_gnn, {workers} worker(s): {len(rows)} combos in {wall:.1f} s on {CARD} "
            f"(per combo {[r['dt_seconds'] for r in rows]} s); leaderboard {boards[workers]}"
            + (f"; kernel launches in this process {dict(bsda_spmm_cuda.launches)}"
               if workers == 1 else ""))
        if len(rows) != 2 or not os.path.exists(os.path.join(root, "gnn", "best")):
            fail(f"sweep_gnn with {workers} worker(s) did not finish both combos")
        if workers == 1:
            launches = dict(bsda_spmm_cuda.launches)
            for r in rows:
                launches = true_launches(launches, r)
            if not launches["ring"] or not launches["banded"]:
                fail("the sequential sweep did not train through the BSDA kernel")
    keys = ("pr_auc_illicit", "roc_auc", "best_val_pr_auc", "pr_auc_last3")
    err = max(abs(a[k] - b[k]) for a, b in zip(results[1], results[2]) for k in keys)
    log(f"sweep_gnn: sequential against two workers, ranks and run names "
        f"{'equal' if boards[1] == boards[2] else 'DIFFER'}, {', '.join(keys)} max abs "
        f"{err:.3e} (tol {SWEEP_TOL:.0e})")
    if boards[1] != boards[2] or err > SWEEP_TOL:
        fail("the sweep's workers disagree with its sequential run")
    return launches


def run_all_phase(run, outputs) -> dict:
    """analysis.run_all on a finished run dir on the card, every stage,
    launch counts set to 0 just before and read just after: the robustness
    and hub-ablation stages must have scored through the kernels (the
    explainer's ELL gather and the host stages launch none). Its outputs
    are checked directly: the CSV and JSON of every stage, report.html,
    and the figures where matplotlib imports; no stage may have failed
    (run_all returns the stages that printed FAILED). Returns the
    launches."""
    import importlib.util

    import numpy as np

    from elliptic_gnn_tpu_torch import kernels
    from elliptic_gnn_tpu_torch.analysis import run_all
    from elliptic_gnn_tpu_torch.kernels import bsda_spmm_cuda, gat_cuda

    outdir, name = run["outdir"], run["cfg"]["run_name"]
    kernels.launch_counts(reset=True)
    t0 = time.time()
    failed = run_all.main(["--run_dir", outdir, "--outputs", outputs])
    wall = time.time() - t0
    launches = {**bsda_spmm_cuda.launches, **gat_cuda.launches}
    log(f"run_all on {name}: {wall:.1f} s on {CARD}; kernel launches {launches}")
    if failed:
        fail(f"run_all on {name}: stage(s) {failed} failed")
    explained = os.path.join(outdir, "gnn_explainer_importance.json")
    if not os.path.exists(explained):
        fail(f"run_all on {name} did not write gnn_explainer_importance.json")
    with open(explained) as fh:
        node = json.load(fh)["node_idx"]
    want = ["by_time.csv", "workload_curve.csv", "robustness_drop0.1_noise0.0.json",
            "metrics_hub_removed_0p01.json", "gnn_explainer_importance.json"]
    figures = ["by_time_pr_auc.png", "calibration_curve.png", "workload_curve.png",
               f"gnn_explainer_node_{node}.png"]
    if importlib.util.find_spec("matplotlib") is not None:
        want += figures
    else:
        log(f"run_all on {name}: matplotlib is not importable here, so the stages drew "
            f"no figures ({', '.join(figures)}); their CSV and JSON are checked")
    paths = [os.path.join(outdir, f) for f in want] + [os.path.join(outputs, "report.html")]
    missing = [p for p in paths if not os.path.exists(p) or os.path.getsize(p) == 0]
    if missing:
        fail(f"run_all on {name} did not write {missing}")
    for f in ("robustness_drop0.1_noise0.0.json", "metrics_hub_removed_0p01.json"):
        with open(os.path.join(outdir, f)) as fh:
            r = json.load(fh)
        if not np.isfinite([v for v in r.values() if isinstance(v, float)]).all():
            fail(f"{f} of {name} holds values that are not finite")
        log(f"{name} {f}: pr_auc_illicit {r['pr_auc_illicit']:.4f}, "
            f"n_edges_remaining {r['n_edges_remaining']}")
    kernels = ("gat_fwd", "gat_fwd_gated") if run["cfg"]["arch"] == "gat" else ("ring", "banded")
    if any(launches[k] <= 0 for k in kernels):
        fail(f"run_all on {name}: robustness and hub_ablation did not score through "
             f"the kernels {kernels}: {launches}")
    return launches


def explain_check(run) -> None:
    """explain_node on the run dir, on the card and on the CPU, from the same
    best.ckpt and node: the test node with the most incoming edges (run_all
    explained its own pick, often a node of a few edges), so that the
    k-hop subgraph is large. The same subgraph edges and class, the masks
    within EXPLAIN_MASK_ATOL; no kernel launched (an EllGraph goes to the
    ELL gather). Prints the explainer's walls, and that of the CLI's 300
    steps on the card."""
    import numpy as np

    from elliptic_gnn_tpu_torch import kernels
    from elliptic_gnn_tpu_torch.analysis import explain
    from elliptic_gnn_tpu_torch.analysis.common import load_run_arrays, load_run_data
    from elliptic_gnn_tpu_torch.kernels import bsda_spmm_cuda, gat_cuda

    name = run["cfg"]["run_name"]
    _, data = load_run_data(run["outdir"])
    test_nodes = load_run_arrays(run["outdir"], "test")["node_idx"]
    in_deg = np.bincount(data.edge_index[1], minlength=data.num_nodes)[test_nodes]
    node = int(test_nodes[np.argmax(in_deg)])
    out = {}
    for dev in ("cuda", "cpu"):
        kernels.launch_counts(reset=True)
        t0 = time.time()
        out[dev] = explain.explain_node(run["outdir"], node_idx=node, steps=EXPLAIN_STEPS,
                                        device=dev)
        out[dev + "_s"] = time.time() - t0
        if dev == "cuda" and (any(bsda_spmm_cuda.launches.values())
                              or any(gat_cuda.launches.values())):
            fail("the explainer launched a BSDA or GAT kernel on an EllGraph")
    a, b = out["cuda"], out["cpu"]
    if not np.array_equal(a.edges, b.edges) or a.predicted_class != b.predicted_class or \
            a.node_idx != b.node_idx:
        fail(f"explain_node on {name}: the card and the CPU explain another subgraph")
    err_e = float(np.abs(a.edge_mask.cpu().numpy() - b.edge_mask.numpy()).max())
    err_f = float(np.abs(a.feat_mask.cpu().numpy() - b.feat_mask.numpy()).max())
    t0 = time.time()
    full = explain.explain_node(run["outdir"], node_idx=node, device="cuda")
    full_s = time.time() - t0
    log(f"explain_node on {name}: node {node} ({int(in_deg.max())} incoming edges), class "
        f"{a.predicted_class}, {a.edges.shape[0]} subgraph edge slots, "
        f"{a.feat_mask.numel()} features; {EXPLAIN_STEPS} steps: card {out['cuda_s']:.2f} s, "
        f"CPU {out['cpu_s']:.2f} s (load and build included), masks card vs CPU "
        f"edge max_abs={err_e:.3e} feature max_abs={err_f:.3e} (tol {EXPLAIN_MASK_ATOL:.0e}); "
        f"300 steps on the card {full_s:.2f} s, loss {full.loss:.4f}; {CARD}")
    if max(err_e, err_f) > EXPLAIN_MASK_ATOL:
        fail(f"explain_node on {name}: the masks on the card disagree with the CPU's")


def host_clis(tmp, processed) -> None:
    """The host-only CLIs, which touch no device: eda (numpy) on the CSV
    build; train_baselines on both baseline configs and explain xgb where
    sklearn and matplotlib import."""
    import importlib.util

    from elliptic_gnn_tpu_torch.analysis import eda

    ran, missing = ["eda"], [m for m in ("sklearn", "matplotlib")
                            if importlib.util.find_spec(m) is None]
    eda.main(["--processed_dir", processed, "--out_dir", os.path.join(tmp, "eda"),
              "--assert_no_cross_time_edges"])
    if not missing:
        import yaml

        from elliptic_gnn_tpu_torch.analysis import explain
        from elliptic_gnn_tpu_torch.train import train_baselines

        for config in ("baseline_lr.yaml", "baseline_xgb.yaml"):
            with open(os.path.join(HERE, "configs", config)) as fh:
                cfg = yaml.safe_load(fh)
            cfg.update(processed_dir=processed, output_root=os.path.join(tmp, "out"),
                       n_estimators=min(int(cfg.get("n_estimators", 50)), 50))
            train_baselines.main(cfg)
            explain.run_xgb(os.path.join(tmp, "out", "baselines", cfg["run_name"]),
                            processed, n_samples=50)
        ran += ["train_baselines (both configs)", "explain xgb"]
    log(f"host-only CLIs run: {', '.join(ran)}"
        + (f"; not run, {' and '.join(missing)} not importable here: train_baselines, "
           "explain xgb" if missing else ""))


def posthoc_phase(tmp, processed, rec, gat) -> dict:
    """The post-hoc layer on the rec_k8 and gat.yaml run dirs: run_all on
    each (all stages, on the card), explain_node card against CPU on each,
    and the host-only CLIs. Returns the kernels' post-hoc launches."""
    launches = {}
    for run in (rec, gat):
        t0 = time.time()
        launches[run["cfg"]["arch"]] = run_all_phase(run, os.path.join(tmp, "out"))
        explain_check(run)
        log(f"post-hoc on {run['cfg']['run_name']}: {time.time() - t0:.1f} s")
    host_clis(tmp, processed)
    return launches


def gat_mesh1_runs(tmp, processed, route, gat, gat2=None, **mesh) -> dict:
    """gat.yaml at `mesh_devices: 1` on one mesh route (`mesh`: its config
    values and entry): KLOOP_EPOCHS epochs in the K loop and in the serial
    loop, and with `gat2` (the single-device two-sweep run) once more in
    the K loop with the two-sweep backward. Every epoch must launch the GAT
    kernels as the single-device run does (check_gat_launches: the
    forwards, and gat_bwd or with two sweeps gat_bwd_dst and gat_bwd_src,
    through the rectangular launches); K against serial per epoch
    (KLOOP_TOL); each run's first-epoch loss, test and best val PR-AUC
    against the single-device run of the same backward (MESH1_LOSS_RTOL,
    MESH1_PR_ATOL). Returns the runs by name."""
    runs = {"k": slice_phase(tmp, processed, "gat.yaml", f"gat_{route}1",
                             epochs=KLOOP_EPOCHS, **mesh),
            "serial": slice_phase(tmp, processed, "gat.yaml", f"gat_{route}1_serial",
                                  epochs=KLOOP_EPOCHS, epochs_per_sync=1, **mesh)}
    pairs = [("k", gat), ("serial", gat)]
    if gat2 is not None:
        with two_sweep_backward():
            runs["two"] = slice_phase(tmp, processed, "gat.yaml", f"gat_{route}1_two_sweep",
                                      epochs=KLOOP_EPOCHS, **mesh)
        pairs.append(("two", gat2))
    for name, run in runs.items():
        check_gat_launches(run, two_sweep=name == "two")
    compare_runs(f"gat.yaml {route} mesh 1, K=8 against serial", runs["k"], runs["serial"])
    for name, single in pairs:
        mesh1 = runs[name]
        loss_rel = abs(mesh1["losses"][0] - single["losses"][0]) / abs(single["losses"][0])
        pr = [abs(mesh1["metrics"][k] - single["metrics"][k])
              for k in ("pr_auc_illicit", "best_val_pr_auc")]
        log(f"gat.yaml {route} mesh 1 ({name}) against single device: first-epoch loss "
            f"{mesh1['losses'][0]:.6f} vs {single['losses'][0]:.6f}, rel {loss_rel:.3e} (tol "
            f"{MESH1_LOSS_RTOL:.0e}); PR-AUC diffs {[f'{v:.3e}' for v in pr]} (tol "
            f"{MESH1_PR_ATOL:.0e}); one replayed epoch, device ms per block: mesh 1 "
            f"{mesh1['metrics'].get('replay_ms')}, single device "
            f"{single['metrics'].get('replay_ms')}")
        if loss_rel > MESH1_LOSS_RTOL or max(pr) > MESH1_PR_ATOL:
            fail(f"gat.yaml {route} at mesh_devices: 1 ({name}) disagrees with the "
                 "single-device run")
    report_walls(f"gat.yaml {route} mesh 1 and single device",
                 [runs["k"], runs["serial"], gat] + ([runs["two"], gat2] if gat2 else []))
    return runs


def gat_mesh_launches(runs) -> dict:
    """The GAT kernels' true launches summed over mesh-1 runs."""
    out = {}
    for run in runs.values():
        for k, v in run["launches"].items():
            if k.startswith("gat"):
                out[k] = out.get(k, 0) + v
    return out


def mesh1_phase(tmp, processed, rec, gcn, gat, gat2) -> dict:
    """`aggregation: shard_map` at `mesh_devices: 1`: the halo path in a
    world of one, a real NCCL process group around the sharded step. rec_k8
    KLOOP_EPOCHS epochs in the K loop (the epoch with its all-reduces
    captured) and the serial loop, gcn.yaml (dst and src scales) EPOCHS
    epochs, gat.yaml through the GAT kernels' rectangular launches over
    each shard's halo-extended rows (gat_mesh1_runs: K, serial and the
    two-sweep backward). Every epoch of rec_k8 and gcn goes through
    bsda_spmm (the same counts as the single-device runs); first-epoch
    losses against the single-device runs of the same seed
    (MESH1_LOSS_RTOL), final and best val PR-AUC against them
    (MESH1_PR_ATOL), K against serial per epoch (KLOOP_TOL). Returns the
    true launches of the rec_k8 runs, of the gcn run and of the GAT runs."""
    sm = {"aggregation": "shard_map", "mesh_devices": 1}
    k_run = slice_phase(tmp, processed, "rec_k8.yaml", "rec_k8_mesh1",
                        epochs=KLOOP_EPOCHS, **sm)
    serial = slice_phase(tmp, processed, "rec_k8.yaml", "rec_k8_mesh1_serial",
                         epochs=KLOOP_EPOCHS, epochs_per_sync=1, **sm)
    for run in (k_run, serial):
        check_rec_k8_launches(run)
    compare_runs("rec_k8 shard_map mesh 1, K=8 against serial", k_run, serial)
    gcn1 = slice_phase(tmp, processed, "gcn.yaml", "gcn_mesh1", **sm)
    check_conv_launches("gcn.yaml shard_map mesh 1", gcn1,
                        per_epoch={"ring": 9, "banded": 0}, scoring={"ring": 3, "banded": 0})
    gat_runs = gat_mesh1_runs(tmp, processed, "shard_map", gat, gat2, **sm)
    for name, one, mesh1 in (("rec_k8", rec, k_run), ("gcn.yaml", gcn, gcn1)):
        loss_rel = abs(mesh1["losses"][0] - one["losses"][0]) / abs(one["losses"][0])
        pr = [abs(mesh1["metrics"][k] - one["metrics"][k])
              for k in ("pr_auc_illicit", "best_val_pr_auc")]
        log(f"{name} shard_map mesh 1 against single device: first-epoch loss "
            f"{mesh1['losses'][0]:.6f} vs {one['losses'][0]:.6f}, rel {loss_rel:.3e} "
            f"(tol {MESH1_LOSS_RTOL:.0e}); test PR-AUC diff {pr[0]:.3e}, best val diff "
            f"{pr[1]:.3e} (tol {MESH1_PR_ATOL:.0e})")
        if loss_rel > MESH1_LOSS_RTOL or max(pr) > MESH1_PR_ATOL:
            fail(f"{name} with aggregation: shard_map, mesh_devices: 1 disagrees with "
                 "the single-device run")
    report_walls("rec_k8 shard_map mesh 1 and single device", (k_run, serial, rec))
    log(f"gcn.yaml one replayed epoch, device ms per block: shard_map mesh 1 "
        f"{gcn1['metrics'].get('replay_ms')}, single device {gcn['metrics'].get('replay_ms')}")
    rec_launches = {k: k_run["launches"][k] + serial["launches"][k]
                    for k in ("ring", "banded")}
    return {"rec_k8": rec_launches, "gcn": {k: gcn1["launches"][k] for k in ("ring", "banded")},
            "gat": gat_mesh_launches(gat_runs)}


def gspmd_mesh1_phase(tmp, processed, rec, gcn, gat, rec_ell) -> dict:
    """The GSPMD row sharding in a world of one NCCL rank, entered through
    train_gnn.train_rank (the function a rank process runs) with a pinned
    `aggregation` at `mesh_devices: 1`: rec_k8 with `bsda` KLOOP_EPOCHS
    epochs in the K loop (its all-gathers captured) and serial, gcn.yaml
    (dst and src scales) EPOCHS epochs, gat.yaml with `bsda` through the
    GAT kernels' rectangular launches over the gathered rows
    (gat_mesh1_runs: K and serial), rec_k8 with `ell` KLOOP_EPOCHS epochs:
    the epochs of the single-device runs. rec_k8 and gcn launch bsda_spmm
    as often per epoch as their single-device runs (one rectangular launch
    an aggregation), GAT its kernels as its single-device run does, the ELL
    run none at all. First-epoch losses against the single-device runs
    (MESH1_LOSS_RTOL), test and best val PR-AUC against them
    (MESH1_PR_ATOL), K against serial per epoch (KLOOP_TOL); replayed
    epochs beside the single-device runs'. Returns the true launches of
    the rec_k8 runs, of the gcn run and of the GAT runs."""
    from elliptic_gnn_tpu_torch.train import train_gnn

    one = {"mesh_devices": 1, "entry": train_gnn.train_rank}
    k_run = slice_phase(tmp, processed, "rec_k8.yaml", "rec_k8_gspmd1",
                        epochs=KLOOP_EPOCHS, aggregation="bsda", **one)
    serial = slice_phase(tmp, processed, "rec_k8.yaml", "rec_k8_gspmd1_serial",
                         epochs=KLOOP_EPOCHS, epochs_per_sync=1, aggregation="bsda", **one)
    for run in (k_run, serial):
        check_rec_k8_launches(run)
    compare_runs("rec_k8 GSPMD mesh 1, K=8 against serial", k_run, serial)
    gcn1 = slice_phase(tmp, processed, "gcn.yaml", "gcn_gspmd1", aggregation="bsda", **one)
    check_conv_launches("gcn.yaml GSPMD mesh 1", gcn1,
                        per_epoch={"ring": 9, "banded": 0}, scoring={"ring": 3, "banded": 0})
    gat_runs = gat_mesh1_runs(tmp, processed, "gspmd", gat, aggregation="bsda", **one)
    ell1 = slice_phase(tmp, processed, "rec_k8.yaml", "rec_k8_ell_gspmd1",
                       epochs=KLOOP_EPOCHS, aggregation="ell", **one)
    no_kernel_launched(ell1)
    for name, single, mesh1 in (("rec_k8", rec, k_run), ("gcn.yaml", gcn, gcn1),
                                ("rec_k8 ell", rec_ell, ell1)):
        loss_rel = abs(mesh1["losses"][0] - single["losses"][0]) / abs(single["losses"][0])
        pr = [abs(mesh1["metrics"][k] - single["metrics"][k])
              for k in ("pr_auc_illicit", "best_val_pr_auc")]
        log(f"{name} GSPMD mesh 1 against single device: first-epoch loss "
            f"{mesh1['losses'][0]:.6f} vs {single['losses'][0]:.6f}, rel {loss_rel:.3e} "
            f"(tol {MESH1_LOSS_RTOL:.0e}); PR-AUC diffs {[f'{v:.3e}' for v in pr]} "
            f"(tol {MESH1_PR_ATOL:.0e}); one replayed epoch, device ms per block: GSPMD "
            f"{mesh1['metrics'].get('replay_ms')}, single device "
            f"{single['metrics'].get('replay_ms')}")
        if loss_rel > MESH1_LOSS_RTOL or max(pr) > MESH1_PR_ATOL:
            fail(f"{name} with the GSPMD row sharding at mesh_devices: 1 disagrees with "
                 "the single-device run")
    report_walls("rec_k8 GSPMD mesh 1 and single device", (k_run, serial, rec))
    return {"rec_k8": {k: k_run["launches"][k] + serial["launches"][k]
                       for k in ("ring", "banded")},
            "gcn": {k: gcn1["launches"][k] for k in ("ring", "banded")},
            "gat": gat_mesh_launches(gat_runs)}


def epilogue_rank(out_dir, device_type, n_rows) -> None:
    """One rank of multicard_epilogue_phase (started by
    parallel/multihost.py::spawn_ranks): the rank's slice of one [n_rows x
    64] batch, the same on every rank, then MESH_EPILOGUE_PAD rows of
    row_mask 0 holding large values, through SageResBN.epilogue (on CUDA
    the kernels: BatchNorm's statistics all-reduced over the world, dz from
    the world's sums, the rank's own scale and bias gradients) in training
    at dropout 0.2, against epilogue_plain (BatchNorm's psum, autograd
    through it) on the same rows, draws and cotangents (the padding rows'
    too); and at dropout 0, the padding rows' cotangents 0 as a loss that
    leaves them out gives them, against the whole batch on this card alone
    (the rank's rows of the output and of dz, the world's sum of the scale
    and bias gradients, the running statistics). Writes its largest differences to out_dir/rank<r>.json."""
    import copy

    import torch
    import torch.distributed as dist

    from elliptic_gnn_tpu_torch import kernels
    from elliptic_gnn_tpu_torch.kernels import resbn_epilogue as rk
    from elliptic_gnn_tpu_torch.models import build_model
    from elliptic_gnn_tpu_torch.parallel import multihost

    multihost.maybe_initialize(device_type=device_type)
    rank, world = dist.get_rank(), dist.get_world_size()
    device = (torch.device("cuda", torch.cuda.current_device()) if device_type == "cuda"
              else torch.device("cpu"))
    c, group = 64, dist.group.WORLD
    gen = torch.Generator().manual_seed(11)
    z = torch.randn((n_rows, c), generator=gen) * 1.5 + 0.3
    res, ct = torch.randn((n_rows, c), generator=gen), torch.randn((n_rows, c), generator=gen)
    model = build_model("sage_resbn", c, {"hidden_dim": c, "layers": 3, "dropout": 0.2},
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.bns[0].scale.copy_(1.0 + 0.3 * torch.randn(c, generator=gen))
        model.bns[0].bias.copy_(0.2 * torch.randn(c, generator=gen))
    model = model.to(device)
    plain, mesh0 = copy.deepcopy(model), copy.deepcopy(model)
    mesh0.dropout = 0.0
    whole = copy.deepcopy(mesh0)

    per = -(-n_rows // world)
    lo, hi = min(rank * per, n_rows), min((rank + 1) * per, n_rows)
    rows = per + MESH_EPILOGUE_PAD
    pad_gen = torch.Generator().manual_seed(100 + rank)

    def padded(t, shift):
        fill = torch.randn((rows - (hi - lo), c), generator=pad_gen) + shift
        return torch.cat([t[lo:hi], fill]).to(device)

    zr, rr, gr = padded(z, 100.0), padded(res, 0.0), padded(ct, 0.0)
    mask = torch.cat([torch.ones(hi - lo), torch.zeros(rows - (hi - lo))]).to(device)
    gr0 = gr * mask[:, None]  # padding rows out of the loss, as in training

    def run(m, fn, zz, rs, g, row_mask, grp):
        m.train()
        zc, rc = zz.clone().requires_grad_(True), rs.clone().requires_grad_(True)
        o = fn(0, zc, rc, torch.Generator(device=device).manual_seed(9), row_mask, grp)
        o.backward(g)
        b = m.bns[0]
        return {"out": o.detach(), "dz": zc.grad, "dres": rc.grad, "dscale": b.scale.grad,
                "dbias": b.bias.grad, "mean": b.mean.clone(), "var": b.var.clone()}

    kernels.launch_counts(reset=True)
    fused = run(model, model.epilogue, zr, rr, gr, mask, group)
    launched = sum(rk.launches.values())
    ref = run(plain, plain.epilogue_plain, zr, rr, gr, mask, group)
    fused0 = run(mesh0, mesh0.epilogue, zr, rr, gr0, mask, group)
    one = run(whole, whole.epilogue, z.to(device), res.to(device), ct.to(device), None, None)
    for k in ("dscale", "dbias"):
        dist.all_reduce(fused0[k], group=group)
    errs_plain, errs_one, ok = {}, {}, True
    for k in fused:
        tol = dict(rtol=1e-4, atol=1e-5) if k in ("dscale", "dbias") else TOL["float32"]
        errs_plain[k] = float((fused[k] - ref[k]).abs().max())
        ok = ok and within(fused[k], ref[k], tol)
        got, want = fused0[k], one[k]
        if want.shape[0] == n_rows:  # a row tensor: the rank's real rows
            got, want = got[: hi - lo], want[lo:hi]
        errs_one[k] = float((got - want).abs().max())
        ok = ok and within(got, want, dict(rtol=1e-4, atol=1e-5))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "world": world, "rows": [lo, hi, rows], "launches": launched,
                   "vs_plain": errs_plain, "vs_one_card": errs_one, "ok": ok}, f)


def multicard_epilogue_phase(tmp, n, device_type="cuda", n_rows=N_NODES) -> None:
    """The SAGE-ResBN epilogue over n ranks (epilogue_rank): on each, the
    kernels against the plain version on the same mesh, and the mesh
    against the whole batch on one card."""
    from elliptic_gnn_tpu_torch.parallel import multihost

    out_dir = os.path.join(tmp, "epilogue_mesh")
    os.makedirs(out_dir, exist_ok=True)
    multihost.spawn_ranks(n, epilogue_rank, (out_dir, device_type, n_rows), device_type)
    for r in range(n):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            got = json.load(f)
        log(f"SAGE-ResBN epilogue over {n} ranks, rank {r} (rows {got['rows'][0]}:"
            f"{got['rows'][1]}, {got['rows'][2]} with padding; {got['launches']} launches): "
            "against the plain version on the mesh max_abs "
            + ", ".join(f"{k}={v:.3e}" for k, v in got["vs_plain"].items())
            + "; against one card (dropout 0) max_abs "
            + ", ".join(f"{k}={v:.3e}" for k, v in got["vs_one_card"].items())
            + (" ok" if got["ok"] else " MISMATCH"))
        if not got["ok"] or (device_type == "cuda" and got["launches"] <= 0):
            fail(f"the SAGE-ResBN epilogue over {n} ranks disagrees on rank {r}")


def multicard_phase(tmp, processed, rec, gat) -> None:
    """The SAGE-ResBN epilogue over min(4, cards) NCCL ranks
    (multicard_epilogue_phase), then rec_k8 and gat.yaml at mesh_devices:
    min(4, cards) over NCCL, their ranks started by train_gnn.main, on the
    halo path (`auto`) and on the GSPMD row sharding (`aggregation: bsda`),
    where the host has two cards or more, against the one-card runs `rec`
    and `gat`; else one line saying why they did not run."""
    import torch

    count = torch.cuda.device_count()
    if count < 2:
        log(f"multi-card runs: not run: this host has {count} card (NCCL runs one rank "
            "a card; the halo path and the GSPMD row sharding over more than one rank "
            "are held against the JAX package on the CPU with gloo ranks, "
            "tests/test_torch_port_multihost.py)")
        return
    n = min(4, count)
    multicard_epilogue_phase(tmp, n)
    for (config, name, single), (route, extra) in itertools.product(
            (("rec_k8.yaml", "rec_k8", rec), ("gat.yaml", "gat", gat)),
            (("halo", {}), ("GSPMD", {"aggregation": "bsda"}))):
        run = slice_phase(tmp, processed, config, f"{name}_mesh{n}_{route}",
                          epochs=KLOOP_EPOCHS, mesh_devices=n, **extra)
        diff = max(abs(run["metrics"][k] - single["metrics"][k])
                   for k in ("pr_auc_illicit", "best_val_pr_auc"))
        log(f"{name} over {n} cards (NCCL, {route}): test and best val PR-AUC against one "
            f"card max diff {diff:.3e} (tol {MESH1_PR_ATOL:.0e})")
        report_walls(f"{name} over {n} cards ({route}) and one card", (run, single))
        if diff > MESH1_PR_ATOL:
            fail(f"{name} over {n} cards ({route}) disagrees with the single-card run")


def multicard_drive() -> None:
    """`python3 chip_smoke.py --multicard` on a host of two cards or more:
    the mesh runs alone (what exists only across cards): the synthetic
    Elliptic-scale graph, rec_k8 and gat.yaml on one card for KLOOP_EPOCHS
    epochs, then multicard_phase (the halo path and the GSPMD row sharding
    over min(4, cards) NCCL ranks against them)."""
    with tempfile.TemporaryDirectory() as tmp:
        processed = build_processed(tmp)
        rec = slice_phase(tmp, processed, "rec_k8.yaml", epochs=KLOOP_EPOCHS)
        check_rec_k8_launches(rec)
        gat = slice_phase(tmp, processed, "gat.yaml", epochs=KLOOP_EPOCHS)
        check_gat_launches(gat)
        multicard_phase(tmp, processed, rec, gat)


def profile_phase(cfg, kernel_names) -> None:
    """Where the device time goes: the same run for PROFILE_EPOCHS epochs
    under torch.profiler, device time summed by kernel name (setup, the
    epochs and the final scoring pass); `kernel_names` are this path's
    hand-written kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from elliptic_gnn_tpu_torch.train import train_gnn

    cfg = dict(cfg, max_epochs=PROFILE_EPOCHS, checkpoint_every=0, ablate_hubs_frac=0.0,
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
    entries, rec_tables = kernel_phase(device, flush_buf)
    epilogue_entry = epilogue_phase(device, flush_buf)
    egcn_entry = egcn_phase(device, flush_buf)
    ell_entries = ell_kernel_phase(device, flush_buf)
    shard_launches = shard_kernel_phase(device, flush_buf, rec_tables)
    gspmd_launches, gspmd_times = gspmd_kernel_phase(device, flush_buf, rec_tables)
    del rec_tables
    arch_entries = arch_kernel_phase(device, flush_buf)
    gat_entries, gat_tables = gat_kernel_phase(device, flush_buf)
    gat_entries.update(gat_two_sweep_phase(device, flush_buf, gat_tables))
    gat_mesh_launches_k, gat_mesh_ms = gat_mesh_kernel_phase(device, flush_buf, gat_tables)
    gat_step_times(device, gat_tables, flush_buf)
    wide_gat_phase(device, flush_buf, gat_tables)
    del flush_buf, gat_tables
    hub_phase(device)
    gat_autograd_check(device)
    small_reference_check(device)
    with tempfile.TemporaryDirectory() as tmp:
        processed = csv_phase(tmp, build_processed(tmp))
        # rec_k8 as its config is written (epochs_per_sync auto: K = 8), with
        # checkpoints and the hub ablation; then, interleaved, the serial loop
        rec = slice_phase(tmp, processed, "rec_k8.yaml", epochs=KLOOP_EPOCHS,
                          checkpoint_every=8, ablate_hubs_frac=0.05)
        check_rec_k8_launches(rec)
        rec_serial = slice_phase(tmp, processed, "rec_k8.yaml", "rec_k8_serial",
                                 epochs=KLOOP_EPOCHS, epochs_per_sync=1)
        check_rec_k8_launches(rec_serial)
        stopped = [kloop_phase(tmp, processed, "rec_k8.yaml", rec, rec_serial)]
        resume_phase(tmp, processed, rec)
        analysis_phase(rec)
        report_walls("rec_k8", (rec, rec_serial))
        rec_ell = ell_phase(tmp, processed)
        rec_mb = minibatch_phase(tmp, processed)
        prof_k, prof_serial = profile_dir_phase(tmp, processed)
        slice_launches = {"profile_dir_launches": prof_k,
                          "profile_dir_serial_launches": prof_serial,
                          "sweep_launches": sweep_phase(tmp, processed)}
        gat = slice_phase(tmp, processed, "gat.yaml", epochs=KLOOP_EPOCHS)
        check_gat_launches(gat)
        predict_check(gat["outdir"], {"gat_fwd": 1, "gat_fwd_gated": 1})
        gat_serial = slice_phase(tmp, processed, "gat.yaml", "gat_serial",
                                 epochs=KLOOP_EPOCHS, epochs_per_sync=1)
        check_gat_launches(gat_serial)
        stopped.append(kloop_phase(tmp, processed, "gat.yaml", gat, gat_serial))
        if not any(stopped):
            fail("no K-loop run stopped inside a block")
        with two_sweep_backward():
            gat2 = slice_phase(tmp, processed, "gat.yaml", "gat_two_sweep_a",
                               epochs=KLOOP_EPOCHS)
            gat2_again = slice_phase(tmp, processed, "gat.yaml", "gat_two_sweep_b",
                                     epochs=KLOOP_EPOCHS)
        check_gat_launches(gat2, two_sweep=True)
        check_gat_launches(gat2_again, two_sweep=True)
        check_two_sweep_runs(gat, gat2, gat2_again)
        report_walls("gat.yaml", (gat, gat_serial, gat2, gat2_again))
        posthoc = posthoc_phase(tmp, processed, rec, gat)
        gcn = slice_phase(tmp, processed, "gcn.yaml")
        check_conv_launches("gcn.yaml", gcn,
                            per_epoch={"ring": 9, "banded": 0},
                            scoring={"ring": 3, "banded": 0})
        sage = slice_phase(tmp, processed, "sage.yaml")
        check_conv_launches("sage.yaml", sage,
                            per_epoch={"ring": 3, "banded": 2},
                            scoring={"ring": 1, "banded": 1})
        egcn = slice_phase(tmp, processed, "egcn_o.yaml", epochs=KLOOP_EPOCHS)
        check_egcn_launches(egcn)
        chains = int(egcn["cfg"]["layers"])
        predict_check(egcn["outdir"], {"banded": chains, "egcn_chain_fwd": chains})
        mesh1_launches = mesh1_phase(tmp, processed, rec, gcn, gat, gat2)
        gspmd1_launches = gspmd_mesh1_phase(tmp, processed, rec, gcn, gat, rec_ell)
        multicard_phase(tmp, processed, rec, gat)
        profile_phase(rec["cfg"], ["bsda_spmm_kernel"])
        profile_phase(rec_serial["cfg"], ["bsda_spmm_kernel"])
        profile_phase(rec_ell["cfg"], ["ell_spmm_kernel"])
        profile_phase(rec_mb["cfg"], [])
        profile_phase(gat["cfg"], ["gat_fwd_kernel", "gat_bwd_kernel"])
        with two_sweep_backward():
            profile_phase(gat2["cfg"], ["gat_fwd_kernel", "gat_bwd_dst_kernel",
                                        "gat_bwd_src_kernel", "gat_bwd_kernel"])
        profile_phase(gcn["cfg"], ["bsda_spmm_kernel"])
        profile_phase(sage["cfg"], ["bsda_spmm_kernel"])

    def kernel_row(name, row, count, e, library=True, posthoc_launches=None):
        """`posthoc_launches`: the launches of this kernel in run_all on the
        rec_k8 (BSDA rows) or gat.yaml (GAT rows) run dir; None for the rows
        of the gcn.yaml and sage.yaml paths, whose run dirs it does not read."""
        return {"name": name, "route": "cuda", "source": row[2], "replaces": row[0],
                "launches": count, "max_abs_err": e["max_abs_err"], "ms": e["ms"],
                "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"],
                "bound_by": e["bound_by"],
                "library_ms": e["library_ms"] if library else None,
                "posthoc_launches": posthoc_launches}

    def second_shape(suffix, e):
        """A kernel counted once but launched at two shapes a step: the
        second shape's numbers under *_<suffix> keys of the same entry."""
        return {f"{k}_{suffix}": e[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}

    ring_row, banded_row = TPU_KERNELS[0], TPU_KERNELS[1]
    kernels = [
        kernel_row(f"bsda_spmm[ring: rec_k8 F={entries['ring']['f']} bf16]", ring_row,
                   rec["launches"]["ring"], entries["ring"],
                   posthoc_launches=posthoc["sage_resbn"]["ring"]),
        kernel_row(f"bsda_spmm[banded: rec_k8 F={entries['banded']['f']} bf16]",
                   banded_row, rec["launches"]["banded"], entries["banded"],
                   posthoc_launches=posthoc["sage_resbn"]["banded"]),
        # gcn.yaml counts its F = 128 and F = 2 aggregations together
        kernel_row("bsda_spmm[ring: gcn F=128 bf16, dst and src scales]", ring_row,
                   gcn["launches"]["ring"], arch_entries[("gcn", 128)]),
        kernel_row("bsda_spmm[banded: sage F=167 bf16]", banded_row,
                   sage["launches"]["banded"], arch_entries[("sage", 167)]),
        kernel_row("bsda_spmm[ring: sage F=128 bf16]", ring_row,
                   sage["launches"]["ring"], arch_entries[("sage", 128)]),
        kernel_row("bsda_spmm[banded: egcn_o F=256 f32, dst and src scales]", banded_row,
                   egcn["launches"]["banded"], arch_entries[("gcn", 256)]),
    ]
    # the rec_k8 rows' launches on the ninth slice's BSDA paths, in the
    # halo path's shard phase and in its mesh-1 runs (K and serial) too;
    # the gcn row's in its mesh-1 run
    # and in the GSPMD row sharding's kernel phase (gspmd_launches; a rank's
    # rectangular launch against the whole graph's, forward and transpose,
    # at n = 4 and 2, under gspmd_ms) and in its mesh-1 runs
    for row, name, f in ((kernels[0], "ring", 64), (kernels[1], "banded", 168)):
        row.update({k: v[name] for k, v in slice_launches.items()})
        row.update(shard_launches=shard_launches[name],
                   mesh1_launches=mesh1_launches["rec_k8"][name],
                   gspmd_launches=gspmd_launches[name],
                   gspmd_mesh1_launches=gspmd1_launches["rec_k8"][name],
                   gspmd_ms={f"n={n}": gspmd_times[(n, f, "bfloat16")] for n in SHARD_WAYS})
    kernels[2].update(mesh1_launches=mesh1_launches["gcn"]["ring"],
                      gspmd_mesh1_launches=gspmd1_launches["gcn"]["ring"])
    f2 = arch_entries[("gcn", 2)]
    kernels[2].update(second_shape("f2", f2), library_ms_f2=f2["library_ms"])
    # the backwards run once per layer under one count: an entry holds the
    # hidden layer's shape (h=4) and, under *_h1 keys, the final layer's
    for name, row, count, counter in (
            ("gat_fwd[h=4 gated]", TPU_KERNELS[3], gat["launches"]["gat_fwd_gated"],
             "gat_fwd_gated"),
            ("gat_fwd[h=1]", TPU_KERNELS[2], gat["launches"]["gat_fwd"], "gat_fwd"),
            ("gat_bwd", TPU_KERNELS[4], gat["launches"]["gat_bwd"], "gat_bwd"),
            ("gat_bwd_dst", TPU_KERNELS[5], gat2["launches"]["gat_bwd_dst"], "gat_bwd_dst"),
            ("gat_bwd_src", TPU_KERNELS[6], gat2["launches"]["gat_bwd_src"], "gat_bwd_src")):
        per_layer = "[" not in name
        e = gat_entries[f"{name}[h=4]" if per_layer else name]
        kernels.append(kernel_row(name, row, count, e, library=False,
                                  posthoc_launches=posthoc["gat"][counter]))
        if per_layer:
            kernels[-1].update(second_shape("h1", gat_entries[f"{name}[h=1]"]))
        # GAT on a mesh: the rectangular launches of the mesh kernel phase
        # (every rank's and shard's at n = 4 and 2, under mesh_ms with the
        # whole graph's) and the mesh-1 runs of both routes
        short = {"gat_fwd": "fwd", "gat_fwd_gated": "fwd", "gat_bwd": "bwd",
                 "gat_bwd_dst": "dst", "gat_bwd_src": "src"}[counter]
        for suffix, h in (("", 4 if counter != "gat_fwd" else 1),
                          ("_h1", 1 if per_layer else None)):
            if h is not None:
                kernels[-1][f"mesh_ms{suffix}"] = {
                    f"n={n}": gat_mesh_ms[(short, h, n)] for n in SHARD_WAYS}
        kernels[-1].update(mesh_kernel_launches=gat_mesh_launches_k[counter],
                           mesh1_launches=mesh1_launches["gat"].get(counter, 0),
                           gspmd_mesh1_launches=gspmd1_launches["gat"].get(counter, 0))
        if name == "gat_bwd_dst":  # the plain torch step the kernel took in
            kernels[-1].update(grad_payload_ms=e["grad_payload_ms"],
                               grad_payload_ms_h1=gat_entries[f"{name}[h=1]"]["grad_payload_ms"])
    # replaces no TPU kernel: XLA fused the glue; launches a rec_k8 run
    kernels.append({"name": "resbn_epilogue[rec_k8 C=64 f32]", "route": "cuda",
                    "source": CSRC + "resbn_epilogue.cu", "replaces": None,
                    "launches": {k: v for k, v in rec["launches"].items()
                                 if k.startswith("resbn")}, **epilogue_entry})
    # replaces no TPU kernel: the JAX package has no temporal model;
    # launches an egcn_o.yaml run and a captured epoch of it
    kernels.append({"name": "egcn_evolve[egcn_o d=166, 256 -> c=256 f32, 49 steps]",
                    "route": "cuda", "source": CSRC + "egcn_evolve.cu", "replaces": None,
                    **egcn_entry,
                    "launches": {k: v for k, v in egcn["launches"].items()
                                 if k.startswith("egcn")},
                    "captured_epoch_launches": {
                        k: v for k, v in egcn["metrics"]["graph_launches"].items()
                        if k.startswith("egcn")}})
    # replaces no TPU kernel: the JAX package ran ELL as XLA gathers; the
    # forward at F = 168, the other shapes under suffixed keys; launches of
    # the K-loop ELL run and of its captured epoch
    kernels.append({"name": "ell_spmm[rec_k8 aggregation: ell, F=168 f32]", "route": "cuda",
                    "source": CSRC + "ell_spmm.cu", "replaces": None,
                    "launches": rec_ell["launches"].get("ell_spmm", 0),
                    "captured_epoch_launches": rec_ell["metrics"]["graph_launches"].get(
                        "ell_spmm", 0),
                    **ell_entries[("forward", 168)],
                    **{f"{k}_{table}_f{f}": v for (table, f), e in ell_entries.items()
                       if (table, f) != ("forward", 168) for k, v in e.items()
                       if k in ("ms", "plain_ms", "bound_ms", "library_ms",
                                "max_abs_err", "sum_rel_err")}})
    if any((sum(k["launches"].values()) if isinstance(k["launches"], dict)
            else k["launches"]) <= 0 for k in kernels):
        fail(f"a kernel of the main paths was never launched: {kernels}")
    return kernels


def main() -> None:
    if sys.argv[1:] not in ([], ["--multicard"]):
        fail(f"unknown arguments {sys.argv[1:]}: none, or --multicard")
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    if sys.argv[1:] and torch.cuda.device_count() < 2:
        fail("--multicard needs a host of two cards or more")
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
    global CARD
    CARD = card
    log(f"device: {kind} | nvidia-smi: {card} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.time()
    libs = cuda_build.build(list(cuda_build.SOURCES), verbose=True)
    log(f"built {', '.join(os.path.relpath(p, HERE) for p in libs.values())} "
        f"in {time.time() - t0:.1f} s")

    if sys.argv[1:]:
        multicard_drive()
        log(f"total {time.time() - t_start:.1f} s")
    else:
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
