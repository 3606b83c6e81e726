"""Tensor parallelism over the model axis: what the layers compute their
blocks with when a step has installed a layout (`sharding.hints`).

The serving specs (`sharding.rules.param_spec_serve`) cut heads, ffn,
experts, vocab and SSM heads over the model axis, and the caches' sequence
(`cache_spec`).  A layer first asks which of its units (heads, columns,
experts) are the rank's (`split`: the rank's equal block where the model
axis divides their count, else all of them on every rank), then takes the
entries those units need from each leaf (`take`), by one rule:

* a leaf held as the rank's block whose entries are exactly the ones
  needed is used as it is;
* any other leaf held as a block (its cut falls inside a head, or across
  a concatenation: wk and wv at a KV-head count the model axis does not
  divide, in_proj across z | xBC | dt, conv_w across x | B | C) is
  gathered whole over the model axis where it is used (`lm.tp_gather`),
  and the entries are cut from it;
* a whole leaf gives the entries as views.

Products over a cut input dim (`row`: wo, the MLP's and out_proj's rows)
are summed over the model axis in float32 and rounded to the activation
dtype once, after the sum, as one device's matmul rounds once
(`lm.tp_reduce`).  A cache whose sequence is cut holds positions [start,
start + len) on each rank (`CacheBlock`, `seq_block`); decode attends over
it with a two-level softmax (`seq_softmax`).  Every collective goes
through the layout's model group (`launch.mesh`), so a `CountingGroup`
counts it; on a one-rank axis each is a copy, never skipped.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch.profiler import record_function

from repro_torch.sharding import hints, rules

Ranges = Sequence[Tuple[int, int]]


def group():
    """The model axis's group while a tensor-parallel layout is installed,
    else None (the single-device code runs)."""
    return hints.model_group()


def split(n: int, g) -> Tuple[int, int, bool]:
    """(lo, hi, split) of `n` units over the model axis: the rank's block and
    True where the axis divides n, else (0, n, False): every rank computes
    all of them and nothing is summed over the axis."""
    if n % g.size:
        return 0, n, False
    per = n // g.size
    return g.rank * per, (g.rank + 1) * per, True


def gather(g, x: torch.Tensor, dim: int) -> torch.Tensor:
    """Every rank's x concatenated along `dim` in rank order."""
    with record_function("lm.tp_gather"):
        return rules.gather_dim(g, x, dim)


def whole(g, x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """x whole along `dim` (n entries): as it is if whole, else the ranks'
    blocks gathered."""
    return x if x.shape[dim] == n else gather(g, x, dim)


def take(g, leaf: torch.Tensor, dim: int, ranges: Ranges, n: int) -> torch.Tensor:
    """The entries `ranges` ([lo, hi) pairs, concatenated) along `dim` of a
    leaf whose whole size there is n, held whole or as the rank's block
    (the module's docstring)."""
    have = leaf.shape[dim]
    if have != n:
        lo = g.rank * have
        if list(ranges) == [(lo, lo + have)]:
            return leaf
        leaf = gather(g, leaf, dim)
    parts = [leaf.narrow(dim, lo, hi - lo) for lo, hi in ranges]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def reduce(g, x: torch.Tensor) -> torch.Tensor:
    """The float32 sum over the model axis."""
    with record_function("lm.tp_reduce"):
        return g.reduce(x)


def partial(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w (w in x's dtype) as float32, not rounded to x's dtype.  bf16 on
    the card: the bf16 GEMM with a float32 output, which accumulates as one
    device's bf16 matmul does before its rounding; otherwise the product of
    the operands widened to float32 (exact products, float32 sums)."""
    w = w.to(x.dtype)
    if x.is_cuda and x.dtype == torch.bfloat16:
        out = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return out.reshape(tuple(x.shape[:-1]) + (w.shape[-1],))
    return x.float() @ w.float()


def row(g, x: torch.Tensor, w: torch.Tensor, ranges: Ranges, n: int, summed: bool
        ) -> torch.Tensor:
    """x @ w[ranges] with w's rows cut to the units x holds.  summed (the
    units are split over the model axis): each rank's float32 partial is
    summed over the axis, then rounded to x's dtype once; else the one
    device's product."""
    w = take(g, w, 0, ranges, n)
    if not summed:
        return x @ w.to(x.dtype)
    return reduce(g, partial(x, w)).to(x.dtype)


def all_to_all(g, x: torch.Tensor) -> torch.Tensor:
    with record_function("lm.tp_all_to_all"):
        return g.all_to_all(x)


# ---------------------------------------------------------------------------
# Caches cut along the sequence
# ---------------------------------------------------------------------------

class CacheBlock(dict):
    """One layer's cache on a layout: the rank's block of each leaf (a dict,
    as one device's cache is) and the whole shape of each (`whole`)."""

    def __init__(self, blocks: Dict[str, torch.Tensor], whole: Dict[str, Tuple[int, ...]]):
        super().__init__(blocks)
        self.whole = dict(whole)


def _whole_shape(cache, name: str) -> Tuple[int, ...]:
    if not isinstance(cache, CacheBlock):
        raise TypeError("a cache on a layout is made by launch.steps.make_cache(mesh, ...)")
    return cache.whole[name]


def seq_block(g, cache, name: str) -> Tuple[int, int, bool]:
    """(start, length, split) of the positions the rank's block of a
    (B, S, ...) cache leaf holds: the model axis cuts S where it divides it
    (`rules.cache_spec`), else every rank holds all S."""
    s = _whole_shape(cache, name)[1]
    lo, hi, cut = split(s, g)
    return lo, hi - lo, cut


def write_seq(cache, name: str, value: torch.Tensor, p0: int, start: int) -> None:
    """Write value, which covers positions [p0, p0 + T), where the rank's
    block (positions [start, start + len)) holds them."""
    buf = cache[name]
    lo, hi = max(p0, start), min(p0 + value.shape[1], start + buf.shape[1])
    if lo < hi:
        buf[:, lo - start:hi - start] = value[:, lo - p0:hi - p0].to(buf.dtype)


def seq_softmax(g, sc: torch.Tensor) -> torch.Tensor:
    """softmax over the last dim of float32 scores whose last dim is cut over
    the model axis (each rank its positions' block): the global max and sum
    of exponentials first (one gather of two floats a row, combined in rank
    order, so every rank holds the same bits), then exp(s - M) / L.  A block
    with every position masked (-1e30) has local max -1e30: its sum times
    exp(-1e30 - M) is exactly 0, and so are its weights."""
    m = sc.amax(dim=-1)
    l = torch.exp(sc - m[..., None]).sum(dim=-1)
    both = gather(g, torch.stack([m, l])[None], 0)          # (ranks, 2, ...)
    big = both[:, 0].amax(dim=0)
    total = (both[:, 1] * torch.exp(both[:, 0] - big)).sum(dim=0)
    return torch.exp(sc - big[..., None]) / total[..., None]


def positions_of(start: int, length: int, device) -> torch.Tensor:
    return start + torch.arange(length, device=device)


def grouped_kv(k: torch.Tensor, h0: int, h1: int, heads: int, kv_heads: int, k0: int = 0
               ) -> torch.Tensor:
    """The KV heads (dim 2 of k, which holds heads [k0, ...)) that query
    heads [h0, h1) read, laid out so that q's heads group over them as the
    attention's reshape (B, T, KV, G, D) groups them: a contiguous slice
    where the query heads take whole groups of one or more KV heads, else
    one KV head per query head."""
    g = heads // kv_heads
    idx = [h // g - k0 for h in range(h0, h1)]
    n = idx[-1] - idx[0] + 1
    per = (h1 - h0) // n
    if per * n == h1 - h0 and all(i == idx[0] + j // per for j, i in enumerate(idx)):
        return k.narrow(2, idx[0], n)
    return k[:, :, idx]
