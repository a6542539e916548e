"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

The window drives the program's full-batch trainer as users run it with
`mini_batch: false`: `train_gnn._train_loop_fullbatch`, the K-epoch loop
(`_k_loop`, a captured epoch replayed), on the model, graph encoding and
optimizer that `train_gnn.build_train_state` builds. One run:

  set-up   the configuration's graph (graphgen.py), the trainer's own
           preprocessing (`train_gnn.prepare_data` on it), its set-up
           (`build_train_state`, `_Inputs`), the initial parameters made
           here from the run's seed; then the first steps through the trainer's
           loop in the calls follow.CALLS gives (1 epoch, then 2: the
           steps the check follows), and a warm-up call of two blocks
  window   one call of the loop with `patience` equal to its epochs, so
           that the data cannot stop it early, over whole blocks that
           fill `seconds` at the warm-up's epoch time
  check    the program's record of the first steps against the
           reference's (reference/follow.py), each number to its limit
           (limits/<cell>.json)

Everything of one configuration, traffic mix or per-layer metric sits in
its own file (configs/, traffic/, metrics/, reference/, limits/), found by
the names in BENCHMARK.json.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from . import graphgen
from .devtrace import Trace
from .reference import follow as ref_follow
from .weights import make_weights

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "elliptic_gnn_tpu")
TRACE_FROM_BLOCK = 3   # blocks of the window before the traced stretch
TRACE_BLOCKS = 6       # blocks in the traced stretch


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, taken whole, is JAX's, one of
    its libraries' or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def load_json(rel: str) -> dict:
    with open(os.path.join(os.path.dirname(BENCH_DIR), rel)) as fh:
        return json.load(fh)


def cell_files(manifest: dict, workload: str):
    """(cell, configuration, traffic, limits) of a workload's name."""
    cells = {c["name"]: c for c in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = next(c for c in manifest["configs"] if c["name"] == cell["config"])
    conf = load_json(config["file"])
    traffic = load_json(os.path.join(os.path.basename(BENCH_DIR), "traffic",
                                     f"{cell['traffic']}.json"))
    limits = load_json(os.path.join(os.path.basename(BENCH_DIR), "limits", f"{workload}.json"))
    return cell, conf, traffic, limits


def run_seed(seed: int) -> int:
    """Any whole number as a seed that numpy and torch both take."""
    return int(seed) % (1 << 62)


def trainer_config(conf: dict, traffic: dict, seed: int, device: str,
                   overrides: Optional[dict] = None) -> dict:
    cfg = dict(conf["trainer"])
    cfg.update(traffic.get("trainer", {}))
    cfg.update(seed=seed, device=device, resume=False, checkpoint_every=0)
    cfg.update(overrides or {})
    return cfg


class Recorder:
    """The trainer's logger: keeps each epoch's (loss, PR-AUC) and runs a
    hook when the host has logged a given epoch (a block boundary)."""

    def __init__(self):
        self.rows, self.hooks = [], {}

    def log_epoch(self, epoch, train_loss, val_pr_auc, extras=None):
        self.rows.append((int(epoch), float(train_loss), float(val_pr_auc)))
        hook = self.hooks.pop(int(epoch), None)
        if hook is not None:
            hook()

    def close(self):
        pass


class Program:
    """The program under test, set up as the trainer sets itself up, with
    the benchmark's initial parameters."""

    def __init__(self, cfg: dict, arrays: dict, graph: dict, weights: dict, device):
        from elliptic_gnn_tpu_torch.graph import GraphData, make_temporal_masks
        from elliptic_gnn_tpu_torch.train import train_gnn

        self.tg, self.cfg, self.device = train_gnn, cfg, device
        data = make_temporal_masks(GraphData(**arrays), int(graph["t_train_end"]),
                                   int(graph["t_val_end"]))
        saved = train_gnn.load_processed
        train_gnn.load_processed = lambda _dir: data  # the graph lives in memory
        try:
            data = train_gnn.prepare_data(cfg)
        finally:
            train_gnn.load_processed = saved
        t0 = time.perf_counter()
        data, model, gops, opt, loss_fn = train_gnn.build_train_state(
            cfg, data, cfg["seed"], device)
        if device.type == "cuda":
            torch.cuda.synchronize()
        self.build_s = time.perf_counter() - t0
        mine = {k: tuple(p.shape) for k, p in model.named_parameters()}
        theirs = {k: tuple(v.shape) for k, v in weights.items()}
        if mine != theirs:
            raise RuntimeError(f"the model's parameters {mine} are not the reference's {theirs}")
        with torch.no_grad():
            for k, p in model.named_parameters():
                p.copy_(weights[k])
        self.model, self.gops, self.opt, self.loss_fn = model, gops, opt, loss_fn
        self.inputs = train_gnn._Inputs(data, device)
        self.n, self.edges = data.num_nodes, data.num_edges
        self.in_dim = data.num_features
        self.k = train_gnn.epochs_per_sync(cfg, device)
        self.outdir = os.path.join(tempfile.gettempdir(), "port_bench_unused")

    def call(self, epochs: int, logger: Recorder):
        """One call of the trainer's loop: (epochs run, epoch_seconds,
        loop_info)."""
        cfg = dict(self.cfg, max_epochs=int(epochs), patience=int(epochs))
        _, _, run, secs, info = self.tg._train_loop_fullbatch(
            cfg, self.outdir, self.inputs, self.model, self.gops, self.opt,
            self.loss_fn, logger, self.device)
        return run, secs, info

    def first_gradients(self) -> dict:
        """Each parameter's gradient as Adam took it at its first step,
        from its first moment after one step: m = (1 - beta1) g; 0 where
        Adam holds no moment (it took no step)."""
        state = self.opt.state
        return {k: float(torch.linalg.vector_norm(state[p]["exp_avg"] / 0.1))
                if "exp_avg" in state.get(p, {}) else 0.0
                for k, p in self.model.named_parameters()}

    def deltas(self, weights: dict) -> dict:
        return {k: (p.detach() - weights[k]).cpu() for k, p in self.model.named_parameters()}

    def buffers(self) -> dict:
        return {k: b.detach().cpu().clone() for k, b in self.model.named_buffers()}


class Outputs:
    """The model's outputs in the trainer's own epochs, [(training, logits)]
    in the order it computes them, while a hook is on the model; none of an
    epoch that is being captured (a capture runs nothing)."""

    def __init__(self, model):
        self.seen = []
        self._handle = model.register_forward_hook(self._keep)

    def _keep(self, module, args, out):
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            return
        self.seen.append((module.training, out.detach().float().cpu()))

    def close(self) -> None:
        self._handle.remove()


def _reader(name: str):
    """A per-layer metric's reader, metrics/<name>.py: read(ctx) returns the
    number, or None where the trace holds nothing to read. ctx holds the
    trace (devtrace.Trace of the traced stretch), its epochs, the window's
    replay_ms outside it, build_s, the trainer's cfg, the epoch's work
    (workcount.Work items), the kernel names the cell's readers claim, and
    read(name), another reader's number (a metric split by the end-to-end
    metric it moves reads as the one it was split from)."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"port_bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Setup:
    """A cell's run up to its first steps: the manifest's files, the
    generated graph, the trainer's configuration, the initial parameters and
    the program set up on them."""

    def __init__(self, workload: str, seed: int, device: str,
                 graph_overrides: Optional[dict] = None,
                 cfg_overrides: Optional[dict] = None, manifest: Optional[dict] = None,
                 program: bool = True):
        self.manifest = manifest or load_json("BENCHMARK.json")
        self.cell, self.conf, traffic, self.limits = cell_files(self.manifest, workload)
        self.seed = run_seed(seed)
        self.dev = torch.device(device)
        self.graph = dict(self.conf["graph"], **(graph_overrides or {}))
        gen_args = {k: self.graph[k] for k in ("num_nodes", "num_features", "num_timesteps",
                                               "avg_degree", "labeled_frac", "illicit_frac",
                                               "signal")}
        # one fixed graph, as users train on the one Elliptic graph: the
        # seed changes the values (parameters, masks), not the work
        self.arrays = graphgen.generate(seed=int(self.graph["seed"]), **gen_args)
        edges = self.arrays["edge_index"].shape[1]
        if not graph_overrides and edges != int(self.conf["num_edges"]):
            raise RuntimeError(f"the graph has {edges} edges; the configuration states "
                               f"{self.conf['num_edges']}")
        self.cfg = trainer_config(self.conf, traffic, self.seed, device, cfg_overrides)
        self.ref_mod = ref_follow.model_module(self.conf["reference"])
        spec = self.ref_mod.param_spec(
            self.cfg, ref_follow.input_width(self.cfg, self.arrays["x"].shape[1]))
        self.weights = make_weights(spec, self.seed, self.dev)
        self.prog = (Program(self.cfg, self.arrays, self.graph, self.weights, self.dev)
                     if program else None)

    def first_steps(self) -> dict:
        """The steps the check follows, through the trainer's loop in the
        calls follow.CALLS gives: each step's loss and PR-AUC, the first
        step's logits (its training forward, then its eval forward), the
        first gradients, the running statistics after the first step and
        after the last, the change of the parameters."""
        rec = Recorder()
        outputs = Outputs(self.prog.model)
        try:
            for epochs in ref_follow.CALLS:
                self.prog.call(epochs, rec)
                if len(rec.rows) == 1:
                    grads = self.prog.first_gradients()
                    bn_1 = self.prog.buffers()
                    outputs.close()
        finally:
            outputs.close()
        (train_mode, logits), (eval_mode, eval_logits) = outputs.seen[:2]
        if not train_mode or eval_mode:
            raise RuntimeError("the trainer's epoch did not run its training forward, "
                               "then its eval forward")
        return {"loss": [r[1] for r in rec.rows], "pr_auc": [r[2] for r in rec.rows],
                "logits": logits, "eval_logits": eval_logits, "grad": grads,
                "bn_1": bn_1, "bn_3": self.prog.buffers(),
                "delta": self.prog.deltas(self.weights)}

    def reference(self, **kw) -> dict:
        """The reference's record of the same steps (reference/follow.py)."""
        return ref_follow.follow(self.cfg, self.arrays, self.weights, self.seed, self.dev,
                                 int(self.graph["t_train_end"]), int(self.graph["t_val_end"]),
                                 self.conf["reference"], **kw)

    def free_program(self) -> None:
        self.prog = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", start: Optional[float] = None,
             graph_overrides: Optional[dict] = None,
             cfg_overrides: Optional[dict] = None, fault: Optional[str] = None,
             manifest: Optional[dict] = None) -> dict:
    """One run of `workload`; returns the result's fields. `fault` plants a
    fault in the program for the tests that show the check catches it:
    'frozen' (Adam's step changes nothing) or 'half_batch' (the loss over
    every other train row)."""
    start = time.time() if start is None else start
    setup = Setup(workload, seed, device, graph_overrides, cfg_overrides, manifest)
    manifest, limits, cfg, dev = setup.manifest, setup.limits, setup.cfg, setup.dev
    prog = setup.prog
    with _planted(prog, fault):
        observed = setup.first_steps()
        # warm-up: two blocks, the second timed
        k = prog.k
        _, secs, _ = prog.call(2 * k, Recorder())
        epoch_s = float(np.median(secs[k:2 * k]))
        blocks = max(2, int(seconds / (epoch_s * k)))
        if trace:
            blocks = max(blocks, TRACE_FROM_BLOCK + TRACE_BLOCKS + 1)
        n_epochs = blocks * k
        win = Recorder()
        prof = _TraceHook(win, k, dev) if trace else None
        t_win = time.time()
        run, secs, info = prog.call(n_epochs, win)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.time() - t_win
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    n, edges, in_dim = prog.n, prog.edges, prog.in_dim
    build_s = prog.build_s
    del prog
    setup.free_program()
    gaps = ref_follow.compare(observed, setup.reference())
    checks = {k: {"value": float(gaps[k]), "limit": float(v)} for k, v in limits.items()}
    checks["epochs_missing"] = {"value": float(n_epochs - run), "limit": 0.0}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())

    out = {"correct": correct, "attempted": int(n_epochs), "failed": int(n_epochs - run)}

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    if trace:
        tr = prof.read()
        replay = [ms for i, ms in enumerate(info.get("replay_ms", []))
                  if not prof.first_block <= i < prof.first_block + TRACE_BLOCKS]
        # the hand-written kernels and aggregation ops of this cell's readers
        readers = {m["name"]: _reader(m["name"]) for m in mine(manifest["per_layer"])}
        claimed = sorted({p for r in readers.values() for p in getattr(r, "KERNELS", ())})
        ctx = SimpleNamespace(trace=tr, epochs=TRACE_BLOCKS * k, replay_ms=replay,
                              build_s=build_s, cfg=cfg, claimed=claimed,
                              work=setup.ref_mod.epoch_work(cfg, n, edges, in_dim))
        ctx.read = lambda name: _reader(name).read(ctx)
        metrics = {}
        for m in mine(manifest["per_layer"]):
            value = readers[m["name"]].read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        out["metrics"] = metrics
        out["breakdown"] = {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_gaps(10)}
        busy = {"busy_s": tr.busy_s, "window_s": tr.window_s}
    else:
        ms = np.asarray(secs, np.float64) * 1e3
        epoch_ms = wall * 1e3 / max(run, 1)
        # epoch_ms.gat is epoch_ms under a bound of its own: the card's two
        # speed states set GAT's spread, and would loosen the others'
        metrics = {"epoch_ms": epoch_ms, "epoch_ms.gat": epoch_ms,
                   "epoch_ms.p95": float(np.percentile(ms, 95)),
                   "setup_s": t_win - start}
        out["metrics"] = {m["name"]: {"value": float(metrics[m["name"]]), "unit": m["unit"]}
                          for m in mine(manifest["end_to_end"])}
        replay = info.get("replay_ms", [])
        blocks_ms = ms[::k]
        out["window"] = {"epochs": int(run), "k": int(k), "wall_s": wall,
                         "replay_ms": float(np.mean(replay)) if replay else None,
                         "first_block_s": float(secs[0] * k) if secs else None,
                         "epoch_ms_quantiles": [float(np.percentile(blocks_ms[1:], q))
                                                for q in (5, 25, 50, 75, 90, 95, 99)]
                         if len(blocks_ms) > 1 else None}
        busy = {}
    out["device"] = _device(dev, peak, busy)
    out["checks"] = checks
    return out


def _device(dev, peak: int, extra: dict) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0, **extra}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
            "memory_peak_bytes": int(peak), **extra}


class _TraceHook:
    """torch.profiler over TRACE_BLOCKS blocks of the window, started and
    stopped by the logger at block boundaries, after TRACE_FROM_BLOCK
    blocks (so after the capture)."""

    def __init__(self, rec: Recorder, k: int, dev):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.first_block = TRACE_FROM_BLOCK
        rec.hooks[TRACE_FROM_BLOCK * k] = self.prof.start
        rec.hooks[(TRACE_FROM_BLOCK + TRACE_BLOCKS) * k] = self.prof.stop

    def read(self) -> Trace:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            return Trace(path)
        finally:
            os.remove(path)


@contextlib.contextmanager
def _planted(prog: Program, fault: Optional[str]):
    """A fault planted under the timed path, for the tests of the check."""
    if fault is None:
        yield
        return
    if fault == "frozen":
        saved = prog.opt.step
        prog.opt.step = lambda *a, **kw: None
        try:
            yield
        finally:
            prog.opt.step = saved
        return
    if fault == "half_batch":
        mask = prog.inputs.train_mask
        rows = torch.nonzero(mask).flatten()
        mask[rows[1::2]] = 0.0
        yield
        return
    raise ValueError(f"unknown fault {fault!r}")


def main(args, start: float) -> int:
    manifest = load_json("BENCHMARK.json")
    cell = next((c for c in manifest["workloads"] if c["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"this cell needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, float(args.seconds), bool(args.trace),
                   "cuda", start, manifest=manifest)
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
