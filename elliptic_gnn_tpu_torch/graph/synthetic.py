"""Synthetic Elliptic-like graph generator.

Copy of generate() in elliptic_gnn_tpu/graph/synthetic.py: both draw from
numpy's default_rng in the same order, so the same seed gives bit-identical
graphs in either package. Tests and benchmarks use this statistically
similar stand-in for the Elliptic CSVs: T timesteps, intra-timestep edges with
a heavy-tailed degree distribution, ~23% of nodes labeled, ~10% of labeled
nodes illicit, and class-conditional Gaussian features so that models can
actually learn (PR-AUC well above the base rate).
"""
from __future__ import annotations

import numpy as np

from .data import GraphData


def generate(
    num_nodes: int = 20000,
    num_features: int = 166,
    num_timesteps: int = 49,
    avg_degree: float = 1.15,
    labeled_frac: float = 0.23,
    illicit_frac: float = 0.10,
    signal: float = 1.2,
    seed: int = 0,
) -> GraphData:
    """Build a synthetic temporal transaction graph.

    Edges are directed and strictly intra-timestep (the Elliptic dataset
    guarantee asserted at dataset_elliptic.py:236-243). Node features carry a
    class-dependent mean shift on a random subset of dimensions plus noise
    that grows slightly with time, creating the temporal drift the reference's
    analysis tooling is built to surface.
    """
    rng = np.random.default_rng(seed)
    n, f, t_max = int(num_nodes), int(num_features), int(num_timesteps)

    # nodes per timestep: lognormal-ish sizes normalized to n, in time order
    sizes = rng.lognormal(mean=0.0, sigma=0.5, size=t_max)
    sizes = np.maximum((sizes / sizes.sum() * n).astype(np.int64), 2)
    while sizes.sum() > n:
        sizes[np.argmax(sizes)] -= 1
    while sizes.sum() < n:
        sizes[np.argmin(sizes)] += 1
    timestep = np.repeat(np.arange(1, t_max + 1), sizes).astype(np.int32)

    # labels: subset labeled; illicit rate decays mildly over time
    labeled = rng.random(n) < labeled_frac
    p_illicit = illicit_frac * (1.0 - 0.3 * (timestep - 1) / max(t_max - 1, 1))
    illicit = rng.random(n) < p_illicit
    y = np.where(labeled, np.where(illicit, 1, 0), -1).astype(np.int32)

    # features: class-conditional shift on a subset of dims + temporal drift
    x = rng.standard_normal((n, f)).astype(np.float32)
    informative = rng.choice(f, size=max(4, f // 8), replace=False)
    shift = rng.standard_normal(informative.size).astype(np.float32) * signal
    is_pos = (y == 1) | ((y == -1) & (rng.random(n) < p_illicit))  # latent class
    x[np.ix_(is_pos, informative)] += shift
    drift = 0.15 * (timestep.astype(np.float32) - 1) / max(t_max - 1, 1)
    x += drift[:, None] * rng.standard_normal((1, f)).astype(np.float32)

    # Intra-timestep edges mirroring the real Elliptic topology: the
    # transaction graph decomposes into many small connected components
    # (payment chains and fan-out trees, mostly 2-20 nodes) plus occasional
    # large components with hub transactions of bounded degree (low
    # hundreds) — NOT scale-free mega-hubs.
    srcs, dsts = [], []
    start = 0
    for sz in sizes:
        target_edges = int(round(avg_degree * sz))
        made = 0
        pos = 0
        while made < target_edges and pos < sz - 1:
            # component size: heavy-tailed but bounded
            u = rng.random()
            if u < 0.70:
                csz = int(rng.integers(2, 8))
            elif u < 0.95:
                csz = int(rng.integers(8, 40))
            else:
                csz = int(rng.integers(40, 400))
            csz = min(csz, sz - pos)
            if csz < 2:
                break
            comp = np.arange(start + pos, start + pos + csz)
            if csz >= 40 and rng.random() < 0.5:
                # hub component: one high-degree transaction fanning out
                # (real Elliptic has hubs with degree in the low hundreds)
                parents = np.zeros(csz - 1, dtype=np.int64)
                deep = rng.random(csz - 1) < 0.3  # some second-level chains
                parents[deep] = rng.integers(1, max(csz - 1, 2), int(deep.sum()))
                parents = np.minimum(parents, np.arange(1, csz) - 1)
                parents = np.maximum(parents, 0)
            else:
                # chain/fan-out tree: parent drawn from a recent window to
                # mimic payment flows
                parents = np.maximum(
                    0,
                    np.arange(1, csz)
                    - 1
                    - rng.geometric(p=0.35, size=csz - 1).astype(np.int64) + 1,
                )
            srcs.append(comp[parents])
            dsts.append(comp[1:])
            made += csz - 1
            # a few extra intra-component edges (cycles)
            extra = int(0.1 * csz)
            if extra and csz > 2:
                a = rng.integers(0, csz, extra)
                b = rng.integers(0, csz, extra)
                keep = a != b
                srcs.append(comp[a[keep]])
                dsts.append(comp[b[keep]])
                made += int(keep.sum())
            pos += csz
        start += sz
    if srcs:
        edge_index = np.stack(
            [np.concatenate(srcs), np.concatenate(dsts)]
        ).astype(np.int32)
    else:
        edge_index = np.zeros((2, 0), dtype=np.int32)

    return GraphData(x=x, y=y, timestep=timestep, edge_index=edge_index)


def hub_edges(num_nodes: int, hub_chunk: int = 1, empty_chunk: int = 3,
              hub_pairs: int = 3000, hub_row_sources: int = 300,
              seed: int = 0, chunk: int = 128, out_hub: bool = False) -> np.ndarray:
    """Edges [2, E] (source, destination) int64 of a directed graph, in its
    final numbering, that strains the per-chunk edge handling of the BSDA
    kernels: about two local in-edges a node, but `hub_pairs` random edges
    into the rows of chunk `hub_chunk` from that chunk and its two
    neighbours, `hub_row_sources` distinct sources into one of its rows, a
    tenth of the hub's edges doubled (multiplicity 2), and no edge at all
    into chunk `empty_chunk`.

    `out_hub` adds the same out of chunk `hub_chunk`, for the kernels that
    walk the reversed edges: one of its rows is the source of edges into
    `hub_row_sources` distinct destinations of the three chunks around it,
    and `hub_pairs` more random edges leave its rows for those chunks. The
    default leaves the graph as it was (the extra draws come last)."""
    rng = np.random.default_rng(seed)
    dst = np.repeat(np.arange(num_nodes), 2)
    src = np.clip(dst + rng.integers(-40, 41, dst.size), 0, num_nodes - 1)
    lo = max(hub_chunk - 1, 0) * chunk
    hi = min((hub_chunk + 2) * chunk, num_nodes)
    hub_dst = hub_chunk * chunk + rng.integers(0, chunk, hub_pairs)
    hub_src = rng.integers(lo, hi, hub_pairs)
    row_src = lo + rng.permutation(hi - lo)[:hub_row_sources]
    row_dst = np.full(row_src.size, hub_chunk * chunk + 5)
    twice = rng.integers(0, hub_pairs, hub_pairs // 10)
    src = np.concatenate([src, hub_src, row_src, hub_src[twice]])
    dst = np.concatenate([dst, hub_dst, row_dst, hub_dst[twice]])
    if out_hub:
        out_src = hub_chunk * chunk + rng.integers(0, chunk, hub_pairs)
        out_dst = rng.integers(lo, hi, hub_pairs)
        fan_dst = lo + rng.permutation(hi - lo)[:hub_row_sources]
        fan_src = np.full(fan_dst.size, hub_chunk * chunk + 9)
        src = np.concatenate([src, out_src, fan_src])
        dst = np.concatenate([dst, out_dst, fan_dst])
    keep = dst // chunk != empty_chunk
    return np.stack([src[keep], dst[keep]]).astype(np.int64)
