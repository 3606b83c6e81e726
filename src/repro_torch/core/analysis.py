"""Graph-topological analysis of grown networks (port of
`repro/core/analysis.py`): degree statistics, reciprocity, the synapse
length profile and a sampled clustering coefficient, over the
fixed-capacity edge list.  `summarize` is the report of
`examples/brain_sim.py --analyze`, for any search method.  Everything but
the clustering coefficient (host numpy, as in the reference) runs on the
edge table's device.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.synapses import SynapseState, in_degree, out_degree


def degree_statistics(edges: SynapseState, n: int) -> Dict[str, torch.Tensor]:
    out_d = out_degree(edges, n)
    in_d = in_degree(edges, n)
    out_f, in_f = out_d.to(torch.float32), in_d.to(torch.float32)
    return {
        "out_mean": out_f.mean(),
        "out_std": out_f.std(correction=0),
        "in_mean": in_f.mean(),
        "in_std": in_f.std(correction=0),
        "out_max": out_d.max(),
        "in_max": in_d.max(),
        "isolated": ((out_d + in_d) == 0).sum(dtype=torch.int32),
    }


def reciprocity(edges: SynapseState, n: int) -> torch.Tensor:
    """Fraction of valid directed edges whose reverse edge also exists
    (multiplicity collapsed), by a sorted membership test."""
    src, dst, valid = edges.src.long(), edges.dst.long(), edges.valid
    rkey = dst * n + src
    sorted_keys = torch.sort(torch.where(valid, src * n + dst, -1)).values
    idx = torch.clamp(torch.searchsorted(sorted_keys, rkey), max=sorted_keys.shape[0] - 1)
    has_recip = (sorted_keys[idx] == rkey) & valid
    denom = torch.clamp(valid.sum(dtype=torch.int32), min=1)
    return has_recip.sum(dtype=torch.int32) / denom


def connection_length_profile(edges: SynapseState, positions: torch.Tensor,
                              bins: int = 20, max_dist: float | None = None
                              ) -> Dict[str, torch.Tensor]:
    """Histogram of synapse lengths over [0, max_dist] (the last bin closed,
    as `jnp.histogram`), and their mean."""
    d = torch.linalg.vector_norm(positions[edges.src.long()] - positions[edges.dst.long()],
                                 dim=-1)
    d = torch.where(edges.valid, d, -1.0)
    if max_dist is None:
        max_dist = max(float(torch.where(edges.valid, d, 0.0).max()), 1e-6)
    # jnp.linspace(0, stop, bins + 1) as XLA:CPU computes it in float32:
    # (stop * float32(1/bins)) * i, then stop itself.
    stop = torch.tensor(max_dist, dtype=torch.float32, device=d.device)
    i = torch.arange(bins, dtype=torch.float32, device=d.device)
    bin_edges = torch.cat([(stop * np.float32(1.0 / bins)) * i, stop[None]])
    # Bin i holds [e_i, e_{i+1}); the last also holds e_bins; -1 lies outside.
    idx = torch.searchsorted(bin_edges, d, right=True) - 1
    idx = torch.where(d == bin_edges[-1], bins - 1, idx)
    inside = (idx >= 0) & (idx < bins)
    counts = torch.bincount(idx[inside], minlength=bins).to(torch.int32)
    total = torch.where(edges.valid, d, 0.0).sum()
    return {"bin_edges": bin_edges, "counts": counts,
            "mean_length": total / torch.clamp(edges.valid.sum(dtype=torch.int32), min=1)}


def clustering_coefficient(edges: SynapseState, n: int,
                           sample: int = 256, seed: int = 0) -> float:
    """Sampled undirected local clustering coefficient (host-side numpy;
    exact adjacency on the sampled nodes)."""
    valid = edges.valid.cpu().numpy()
    src = edges.src.cpu().numpy()[valid]
    dst = edges.dst.cpu().numpy()[valid]
    adj = [set() for _ in range(n)]
    for s, t in zip(src, dst):
        if s != t:
            adj[s].add(int(t))
            adj[t].add(int(s))
    nodes = np.random.default_rng(seed).permutation(n)[:sample]
    coeffs = []
    for v in nodes:
        nb = list(adj[v])
        k = len(nb)
        if k < 2:
            continue
        links = sum(1 for i in range(k) for j in range(i + 1, k) if nb[j] in adj[nb[i]])
        coeffs.append(2.0 * links / (k * (k - 1)))
    return float(np.mean(coeffs)) if coeffs else 0.0


def summarize(edges: SynapseState, positions: torch.Tensor) -> Dict:
    """One-call report: degrees, reciprocity, mean connection length and
    clustering coefficient, as Python numbers."""
    n = positions.shape[0]
    return {
        "degrees": {k: float(v) for k, v in degree_statistics(edges, n).items()},
        "reciprocity": float(reciprocity(edges, n)),
        "mean_connection_length": float(connection_length_profile(edges, positions)
                                        ["mean_length"]),
        "clustering_coefficient": clustering_coefficient(edges, n),
    }
