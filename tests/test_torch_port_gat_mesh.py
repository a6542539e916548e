"""GAT on a mesh through the packed route (kernels/packed_gat.py), in one
process on the CPU, where every launch of the GAT kernels takes its plain
version (kernels/gat_cuda.py):

  - the rectangular form of the four GAT kernels' plain versions: every
    rank's slice of the GSPMD row sharding (forward, the one-sweep
    backward, the destination sweep and its G2, the source sweep on the
    rank's transpose slice) gives the whole graph's rows; and every shard
    of the halo path, its table at once over the halo-extended rows (built
    here from the whole payload), gives the whole graph's attention and,
    summed back onto the rows, its payload cotangent, with either backward;
  - the launches split by width (`width_tiles`) in the rectangular form
    give what one launch gives;
  - the trainer at `mesh_devices: 1` (a world of one) on the halo path and
    on the GSPMD row sharding takes the packed route, never the plain
    attention, and trains as the single-device run does.

The multi-rank runs (each rank's rows against the JAX package, 2 and 4
gloo ranks) are in tests/test_torch_port_multihost.py; the kernels
themselves on the card in tests/test_torch_port_cuda.py.

Tolerances: f32 sums of the same terms in another order, rtol 1e-5, atol
1e-6; the trainer's per-epoch loss rtol 1e-4 and its PR-AUC metrics 2e-3
(tests/test_parallel.py), the plain formulation against the packed one."""
import csv
import os

import numpy as np
import pytest
import torch

from elliptic_gnn_tpu_torch.graph import build_graph
from elliptic_gnn_tpu_torch.kernels import bsda, gat_cuda, packed_gat
from elliptic_gnn_tpu_torch.parallel import gspmd_step, shardmap_step
from elliptic_gnn_tpu_torch.train import train_gnn
from tests import torch_port_ranks as ranks

CLOSE = dict(rtol=1e-5, atol=1e-6)
SLOPE = 0.2
WIDTHS = [(1, 2), (4, 8)]


@pytest.fixture(autouse=True, scope="module")
def _cpu_state():
    """Two intra-op threads for this module, as a gloo rank runs
    (parallel/multihost.py): the test workers share the host's cores, and
    at every core's worth of threads each this module's chunk einsums
    oversubscribe them many times. Then this process's first torch.exp of
    a softmax-sized tensor: in torch's CPU build that call may err by up to
    EXP_RTOL relative in some processes (a runtime quirk outside the port,
    tests/torch_exp_spread.py, bounded by
    tests/test_torch_port_multihost.py::test_torch_exp_spread_within_its_tolerance);
    the comparisons here are of the port's own sums."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    torch.exp(-torch.rand(6, 3, 128, 128, generator=torch.Generator().manual_seed(0)))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def band():
    """The band graph's 'gat' tables (depth 3: a spill) with the transpose."""
    ei, n = ranks.band_graph()
    return bsda.build_bsda_for_kind(ei, n, "gat", depth=3, a_dtype="int8", transpose=True)


def _rand(rows, cols, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((rows, cols)).astype(np.float32))


@pytest.mark.parametrize("h,ch", WIDTHS)
@pytest.mark.parametrize("n_dev", [2, 4])
def test_rank_slices_of_the_plain_kernels_match_whole_graph(band, n_dev, h, ch):
    """Every rank's rectangular launch (its destination chunks from payload
    row rank * n_loc, every row as a source) gives the whole graph's rows:
    the forward, with the slice's spill merged too (a rank's spill may have
    an empty bucket), the destination sweep's d a_dst and G2, the source
    sweep on its transpose slice over the whole G2; the one-sweep
    backward's cotangents summed over the ranks give the whole graph's."""
    g = bsda.pad_bsda_chunks(band, n_dev)
    n_rows = g.num_chunks * g.chunk
    width = gat_cuda.payload_width(h, ch)
    pay, gbar = _rand(n_rows, width, 1), _rand(n_rows, width, 2)
    out = gat_cuda.gat_fwd_plain(g, pay, h, ch, SLOPE, True)
    one = gat_cuda.gat_bwd_plain(g, gbar, pay, out, h, ch, SLOPE, True)
    dst, g2 = gat_cuda.gat_bwd_dst_fused_plain(g, gbar, pay, out, h, ch, SLOPE, True)
    src = gat_cuda.gat_bwd_src_plain(g.transpose, pay, g2, h, ch, SLOPE)
    merged = g.packed_gat_route()[1](pay, h, ch, SLOPE)
    n_loc = n_rows // n_dev
    summed = torch.zeros_like(one)
    for r in range(n_dev):
        rs = gspmd_step.row_sharded_bsda(g, n_dev, r)
        row0 = r * n_loc
        own = slice(row0, row0 + n_loc)
        got = gat_cuda.gat_fwd_plain(rs.fwd, pay, h, ch, SLOPE, True, dst_row0=row0)
        torch.testing.assert_close(got, out[own], **CLOSE)
        torch.testing.assert_close(
            packed_gat.attend_rows(packed_gat.DenseTables(rs.fwd, row0), pay, h, ch, SLOPE),
            merged[own], **CLOSE)
        ct = gat_cuda.gat_bwd_plain(rs.fwd, gbar[own], pay, got, h, ch, SLOPE, True,
                                    dst_row0=row0)
        assert not ct[: row0, -h:].any() and not ct[row0 + n_loc:, -h:].any()
        summed += ct
        ct_d, g2_r = gat_cuda.gat_bwd_dst_fused_plain(rs.fwd, gbar[own], pay, got, h, ch,
                                                      SLOPE, True, dst_row0=row0)
        torch.testing.assert_close(g2_r, g2[own], **CLOSE)
        torch.testing.assert_close(ct_d[own], dst[own], **CLOSE)
        ct_s = gat_cuda.gat_bwd_src_plain(rs.bwd, pay, g2, h, ch, SLOPE, dst_row0=row0)
        torch.testing.assert_close(ct_s[own], src[own], **CLOSE)
        assert not ct_s[: row0].any() and not ct_s[row0 + n_loc:].any()
    torch.testing.assert_close(summed, one, **CLOSE)


def _shard_ext(sg, pay, r, rows_ext):
    """Rank r's halo-extended payload rows, from the whole payload (the
    ring's neighbours' boundary rows; a world of one wraps round), and
    their row ids."""
    c = sg.chunk
    hc, n_loc = sg.halo_chunks * c, sg.a.shape[1] * c
    idx = (torch.arange(-hc, n_loc + hc) + r * n_loc) % pay.shape[0]
    ext = pay[idx]
    return torch.cat([ext, ext.new_zeros((rows_ext - ext.shape[0], ext.shape[1]))]), idx


@pytest.mark.parametrize("two_sweep", [False, True])
@pytest.mark.parametrize("h,ch", WIDTHS)
@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_shards_of_the_packed_route_match_whole_graph(band, monkeypatch, n_dev, h, ch,
                                                      two_sweep):
    """Every shard of the halo path through the packed route's dense
    tables (_gat_view: the whole shard table over its halo-extended rows;
    _transpose_view for the source sweep) and spill gives the whole
    graph's [val | m | s] rows, and the cotangent of sum(val * w) with
    respect to its rows, summed back onto the whole payload, the whole
    graph's; with either backward."""
    monkeypatch.setenv("EGNN_GAT_ONE_SWEEP", "0" if two_sweep else "1")
    g = bsda.pad_bsda_chunks(band, n_dev)
    n_rows = g.num_chunks * g.chunk
    width = gat_cuda.payload_width(h, ch)
    pay, w = _rand(n_rows, width, 3), _rand(n_rows, h * ch, 4)
    whole_in = pay.clone().requires_grad_(True)
    whole = g.packed_gat_route()[1](whole_in, h, ch, SLOPE)
    (whole[:, : h * ch] * w).sum().backward()
    sg = shardmap_step.partition_bsda(g, n_dev, use_kernel=True)
    grad = torch.zeros_like(pay)
    for r in range(n_dev):
        one = shardmap_step.shard_slice(sg, r)
        c = one.chunk
        hc, n_loc = one.halo_chunks * c, one.a.shape[1] * c
        rows_ext = one.b_ext_pad * c
        ext, idx = _shard_ext(one, pay, r, rows_ext)
        ext.requires_grad_(True)
        d = packed_gat.DenseTables(
            shardmap_step._gat_view(one), dst_row0=hc, g_t=shardmap_step._transpose_view(one),
            g2_rows=lambda g2: torch.nn.functional.pad(g2, (0, 0, hc, rows_ext - hc - n_loc)))
        out = packed_gat.attend_rows(d, ext, h, ch, SLOPE)
        own = slice(r * n_loc, (r + 1) * n_loc)
        torch.testing.assert_close(out[:, : h * ch], whole[own, : h * ch].detach(), **CLOSE)
        (out[:, : h * ch] * w[own]).sum().backward()
        grad.index_add_(0, idx, ext.grad[: idx.shape[0]])
        assert not ext.grad[idx.shape[0]:].any()
    torch.testing.assert_close(grad, whole_in.grad, **CLOSE)


def _plain_launches(g, dst_row0, g_t=None):
    """The four launches of gat_cuda's *_tiled functions through the
    rectangular plain versions."""
    return {
        "fwd": lambda p, h, ch, nm: gat_cuda.gat_fwd_plain(g, p, h, ch, SLOPE, nm, dst_row0),
        "bwd": lambda gb, p, o, h, ch, nm: gat_cuda.gat_bwd_plain(g, gb, p, o, h, ch, SLOPE,
                                                                   nm, dst_row0),
        "dst": lambda gb, p, o, h, ch, nm, ct: _into(
            ct, *gat_cuda.gat_bwd_dst_fused_plain(g, gb, p, o, h, ch, SLOPE, nm, dst_row0)),
        "src": lambda p, g2, h, ch, ct: gat_cuda.gat_bwd_src_plain(g_t, p, g2, h, ch, SLOPE,
                                                                   dst_row0),
    }


def _into(ct, part, g2):
    return (part if ct is None else ct + part), g2


@pytest.mark.parametrize("h,ch,limit", [(4, 8, 16), (2, 8, 6)])
def test_rectangular_launches_split_by_width(band, h, ch, limit):
    """The *_tiled functions on a rank's rectangular slice (n = 2, rank 1),
    every launch split at `limit` columns (whole heads, or column tiles of
    a head), give what one rectangular launch gives."""
    n_dev, r = 2, 1
    g = bsda.pad_bsda_chunks(band, n_dev)
    n_rows = g.num_chunks * g.chunk
    rs = gspmd_step.row_sharded_bsda(g, n_dev, r)
    row0 = r * rs.n_loc
    own = slice(row0, row0 + rs.n_loc)
    width = gat_cuda.payload_width(h, ch)
    assert len(gat_cuda.width_tiles(h, ch, limit)) > 1
    pay, gbar_all = _rand(n_rows, width, 5), _rand(n_rows, width, 6)
    gbar = gbar_all[own]
    launch = _plain_launches(rs.fwd, row0)
    out = launch["fwd"](pay, h, ch, True)
    torch.testing.assert_close(gat_cuda.gat_fwd_tiled(launch["fwd"], pay, h, ch, True, limit),
                               out, **CLOSE)
    torch.testing.assert_close(
        gat_cuda.gat_bwd_tiled(launch["bwd"], gbar, pay, out, h, ch, True, limit,
                               dst_row0=row0),
        launch["bwd"](gbar, pay, out, h, ch, True), **CLOSE)
    ct, g2 = gat_cuda.gat_bwd_dst_tiled(launch["dst"], gbar, pay, out, h, ch, True,
                                        max_width=limit, dst_row0=row0)
    want_ct, want_g2 = launch["dst"](gbar, pay, out, h, ch, True, None)
    torch.testing.assert_close(ct, want_ct, **CLOSE)
    torch.testing.assert_close(g2, want_g2, **CLOSE)
    # the source sweep over every row's G2 (the all-gather of the ranks')
    g2_all = gat_cuda.gat_bwd_dst_fused_plain(
        g, gbar_all, pay, gat_cuda.gat_fwd_plain(g, pay, h, ch, SLOPE, True), h, ch, SLOPE,
        True)[1]
    src = _plain_launches(rs.bwd, row0, rs.bwd)["src"]
    torch.testing.assert_close(gat_cuda.gat_bwd_src_tiled(src, pay, g2_all, h, ch, None, limit),
                               src(pay, g2_all, h, ch, None), **CLOSE)


@pytest.fixture(scope="module")
def processed(tmp_path_factory):
    root = tmp_path_factory.mktemp("data")
    cfg = {"seed": 4, "t_train_end": 6, "t_val_end": 8, "t_max": 10,
           "synthetic": True, "synthetic_nodes": 1500,
           "processed_dir": str(root / "processed"), "data_dir": str(root / "raw")}
    build_graph.main(cfg)
    return cfg["processed_dir"]


def _losses(out, run_name):
    with open(os.path.join(out, "gnn", run_name, "training_log.csv")) as fh:
        return np.array([float(row["train_loss"]) for row in csv.DictReader(fh)])


@pytest.mark.parametrize("two_sweep", [False, True])
@pytest.mark.parametrize("agg", ["shard_map", "bsda"])
def test_gat_mesh_one_takes_the_packed_route(processed, tmp_path, monkeypatch, agg,
                                             two_sweep):
    """gat at `mesh_devices: 1` through train_rank (a world of one) on the
    halo path (shard_map) and the GSPMD row sharding (bsda): every layer
    attends through the packed route and never through the plain
    attention; the per-epoch loss and the metrics as the single-device run
    (the plain formulation on the CPU)."""
    monkeypatch.setenv("EGNN_GAT_ONE_SWEEP", "0" if two_sweep else "1")
    cfg = {"seed": 0, "processed_dir": processed, "output_root": str(tmp_path),
           "device": "cpu", "arch": "gat", "hidden_dim": 16, "heads": 4, "layers": 2,
           "dropout": 0.0, "lr": 0.01, "weight_decay": 0.0, "max_epochs": 6,
           "patience": 6, "symmetrize_edges": True, "calibrate_temperature": False}
    one = train_gnn.main(dict(cfg, run_name="one"))
    route = {"shard_map": (shardmap_step, "sharded_gat_attend_packed", "sharded_gat_attend"),
             "bsda": (gspmd_step, "row_gat_attend_packed", "row_gat_attend")}[agg]
    mod, packed_name, plain_name = route
    calls = []
    real = getattr(mod, packed_name)
    monkeypatch.setattr(mod, packed_name, lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setattr(mod, plain_name, None)
    mesh = train_gnn.train_rank(dict(cfg, run_name="mesh", aggregation=agg))
    assert mesh["mesh_devices"] == 1 and mesh["epochs_run"] == one["epochs_run"]
    assert len(calls) >= 2 * mesh["epochs_run"]  # two layers an epoch, and evals
    np.testing.assert_allclose(_losses(str(tmp_path), "mesh"), _losses(str(tmp_path), "one"),
                               rtol=1e-4)
    for key in ("pr_auc_illicit", "best_val_pr_auc"):
        assert abs(mesh[key] - one[key]) < 2e-3, key
