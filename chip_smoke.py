#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (elliptic_gnn_tpu_torch) on one
NVIDIA GPU. Run from the repository root:

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):
  1. device: the card's name and power limit;
  2. build: compiles the BSDA kernel from kernels/csrc with nvcc;
  3. kernel vs plain: on the Elliptic-scale synthetic graph (203,769 nodes,
     234,355 edges before symmetrization, 166 features, 49 timesteps,
     seed 0), the kernel's dense output against its plain PyTorch version
     for the forward (dst scale) and transpose (src scale) tables, the
     bit-packed (pack 4) and int8 (pack 1) tables, at F=168 f32, F=168 bf16
     and F=64 bf16; CUDA-event medians of kernel, plain version and the
     torch.sparse yardstick;
  4. slice: builds the same graph with the port's build_graph, runs
     train_gnn.main on configs/rec_k8.yaml's values at full width for a few
     epochs, and checks that every epoch went through the kernel (launch
     counts), that losses and scores are finite, and the artifacts;
  5. profile: the same run for 3 epochs under torch.profiler, device time
     by kernel name;
  6. prints the table of TPU kernels, the kernel line, the card line, and
     the result line {"ok": true, "device": {...}}.

Imports nothing of JAX and nothing of the JAX package.
"""
from __future__ import annotations

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
TPU_KERNELS = [
    ("elliptic_gnn_tpu/kernels/pallas_bsda.py:218", "_ring_call", "ported"),
    ("elliptic_gnn_tpu/kernels/pallas_bsda.py:124", "_banded_call", "ported"),
    ("elliptic_gnn_tpu/kernels/pallas_gat.py:103", "_flash_gat_call", "todo"),
    ("elliptic_gnn_tpu/kernels/pallas_gat.py:247", "_flash_gat_call_gated", "todo"),
    ("elliptic_gnn_tpu/kernels/pallas_gat_bwd.py:326", "_sweep_fused_call", "todo"),
    ("elliptic_gnn_tpu/kernels/pallas_gat_bwd.py:63", "_sweep_dst_call", "todo"),
    ("elliptic_gnn_tpu/kernels/pallas_gat_bwd.py:181", "_sweep_src_call", "todo"),
]


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


def elliptic_tables(device):
    """The Elliptic-scale synthetic graph's main-path tables on `device`."""
    from elliptic_gnn_tpu_torch.graph import synthetic
    from elliptic_gnn_tpu_torch.graph.transform import symmetrize_edges
    from elliptic_gnn_tpu_torch.kernels.bsda import bfs_order, build_bsda_for_kind

    data = symmetrize_edges(synthetic.generate(
        num_nodes=N_NODES, num_features=166, num_timesteps=49,
        avg_degree=N_EDGES / N_NODES, seed=0))
    data = data.renumber(bfs_order(data.edge_index, data.num_nodes, data.timestep))
    g = build_bsda_for_kind(data.edge_index, data.num_nodes, "sage", depth=3,
                            a_dtype="int8", transpose=True)
    return g.to(device)


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
    g = elliptic_tables(device)
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
                torch.cuda.synchronize()
                want = bsda.bsda_dense_plain(t, x)
                diff = (got.float() - want.float()).abs()
                max_abs = float(diff.max())
                max_rel = float((diff / want.float().abs().clamp_min(1e-6)).max())
                tol = TOL[dname]
                ok = bool((diff <= tol["atol"] + tol["rtol"] * want.float().abs()).all())
                ms = cuda_ms(lambda: bsda_spmm_cuda.bsda_dense_cuda(t, x), flush_buf)
                plain_ms = cuda_ms(lambda: bsda.bsda_dense_plain(t, x), flush_buf)
                case = f"{table_name} pack={pack} F={f} {dname}"
                log(f"kernel vs plain [{case}]: max_abs={max_abs:.3e} "
                    f"max_rel={max_rel:.3e} (tol rtol={tol['rtol']:.3g} "
                    f"atol={tol['atol']:.3g}) {'ok' if ok else 'MISMATCH'} | "
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
        t, x = r["table"], r["x"]
        csr, nnz = sparse_yardstick(t, x)
        try:
            library_ms = cuda_ms(lambda: torch.sparse.mm(csr, x), flush_buf)
        except RuntimeError as exc:  # no bf16 sparse product on this build
            log(f"torch.sparse.mm yardstick unavailable for bf16: {exc}")
            library_ms = None
        del csr
        itemsize = x.element_size()
        bytes_moved = (t.a_packed.numel() + t.src_chunk.numel() * 4
                       + t.dst_scale.numel() * 4 + 2 * x.numel() * itemsize)
        bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        ops_ms = 2.0 * nnz * f / PEAK_OPS["bfloat16"] * 1e3
        entries[variant] = dict(
            max_abs_err=r["max_abs"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            library_ms=library_ms, bytes=bytes_moved, nnz=nnz, f=f)
        log(f"{variant} (F={f} bf16, forward tables): bytes={bytes_moved} "
            f"nnz={nnz} bound={entries[variant]['bound_ms']:.4f} ms "
            f"({entries[variant]['bound_by']}) kernel={r['ms']:.4f} ms "
            f"library={library_ms if library_ms is None else f'{library_ms:.4f}'} ms")
    return entries


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


def slice_phase(tmp):
    import numpy as np
    import yaml

    from elliptic_gnn_tpu_torch.graph import build_graph
    from elliptic_gnn_tpu_torch.kernels import bsda_spmm_cuda
    from elliptic_gnn_tpu_torch.train import train_gnn

    processed = os.path.join(tmp, "processed")
    build_graph.main({"seed": 0, "synthetic": True, "synthetic_nodes": N_NODES,
                      "t_max": 49, "t_train_end": 34, "t_val_end": 43,
                      "processed_dir": processed})
    with open(os.path.join(HERE, "configs", "rec_k8.yaml")) as fh:
        cfg = yaml.safe_load(fh)
    cfg.update(processed_dir=processed, output_root=os.path.join(tmp, "out"),
               max_epochs=EPOCHS)
    bsda_spmm_cuda.reset_launches()
    t0 = time.time()
    metrics = train_gnn.main(cfg)
    wall = time.time() - t0
    launches = dict(bsda_spmm_cuda.launches)

    outdir = os.path.join(cfg["output_root"], "gnn", cfg["run_name"])
    epochs = int(metrics["epochs_run"])
    log(f"slice: rec_k8 ({cfg['arch']}, hidden {cfg['hidden_dim']}, "
        f"{cfg['layers']} layers, amp {cfg['amp']}) ran {epochs} epochs, "
        f"main() wall {wall:.1f} s, train {metrics['train_seconds']:.3f} s")
    log("epoch wall times (s): " + ", ".join(
        f"{s:.4f}" for s in metrics["epoch_seconds"]))
    log(f"kernel launches in the run: {launches}")
    if sum(launches.values()) < 8 * epochs or min(launches.values()) == 0:
        fail(f"the trainer did not run every epoch through the kernel: "
             f"{launches} for {epochs} epochs (want >= 8 per epoch, both variants)")
    for name in ("metrics.json", "scores_val.npy", "scores_test.npy",
                 "y_test.npy", "training_log.csv", "config_used.yaml"):
        if not os.path.exists(os.path.join(outdir, name)):
            fail(f"missing artifact {name}")
    with open(os.path.join(outdir, "training_log.csv")) as fh:
        losses = [float(line.split(",")[1]) for line in fh.read().splitlines()[1:]]
    scores = np.load(os.path.join(outdir, "scores_test.npy"))
    y_test = np.load(os.path.join(outdir, "y_test.npy"))
    if len(losses) != epochs or not all(math.isfinite(v) for v in losses):
        fail(f"losses not finite: {losses}")
    if scores.shape != y_test.shape or not np.isfinite(scores).all() or \
            scores.min() < 0 or scores.max() > 1:
        fail("test scores are not finite probabilities of the expected shape")
    log(f"losses {losses}; test PR-AUC {metrics['pr_auc_illicit']:.4f}, "
        f"ROC-AUC {metrics['roc_auc']:.4f} (random weights, {epochs} epochs)")
    return launches, cfg


def profile_phase(cfg) -> None:
    """Where the device time goes: the same run for PROFILE_EPOCHS epochs
    under torch.profiler, device time summed by kernel name (setup, the
    epochs and the final scoring pass)."""
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
    bsda_us = sum(r[1] for r in rows if "bsda_spmm_kernel" in r[0])
    log(f"profile ({PROFILE_EPOCHS} epochs + setup + scoring, main() wall "
        f"{wall:.1f} s, train {metrics['train_seconds']:.3f} s): device time "
        f"{total_us / 1e3:.3f} ms, of it copies {copy_us / 1e3:.3f} ms, "
        f"bsda_spmm_kernel {bsda_us / 1e3:.3f} ms "
        f"({bsda_us / max(total_us - copy_us, 1):.1%} of kernel time)")
    for key, us, count in rows[:12]:
        log(f"  {us / 1e3:9.3f} ms  x{count:<5d} {key[:90]}")


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke test needs a GPU")
    sys.path.insert(0, HERE)
    try:
        from elliptic_gnn_tpu_torch.kernels import bsda_spmm_cuda
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
    lib = bsda_spmm_cuda.build(verbose=True)
    log(f"built {os.path.relpath(lib, HERE)} in {time.time() - t0:.1f} s")

    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=device)
    entries = kernel_phase(device, flush_buf)
    del flush_buf
    small_reference_check(device)
    with tempfile.TemporaryDirectory() as tmp:
        launches, cfg = slice_phase(tmp)
        profile_phase(cfg)

    source = "elliptic_gnn_tpu_torch/kernels/csrc/bsda_spmm.cu"
    kernels = []
    for variant, replaces in (("ring", TPU_KERNELS[0][0]), ("banded", TPU_KERNELS[1][0])):
        e = entries[variant]
        kernels.append({
            "name": f"bsda_spmm[{variant}: F={e['f']} bf16]", "route": "cuda",
            "source": source, "replaces": replaces, "launches": launches[variant],
            "max_abs_err": e["max_abs_err"], "ms": e["ms"], "plain_ms": e["plain_ms"],
            "bound_ms": e["bound_ms"], "bound_by": e["bound_by"],
            "library_ms": e["library_ms"],
        })
    table = [{"replaces": loc, "tpu_kernel": name, "status": status,
              "port": source if status == "ported" else None}
             for loc, name, status in TPU_KERNELS]
    log(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernel_table": table}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
