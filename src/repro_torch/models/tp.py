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

Training (`launch.steps.make_train_step(mesh=, dp_over_model=False)`)
differentiates through these sites.  Every rank computes the same loss,
and each backward keeps one invariant: every rank's gradient of a tensor
is the whole gradient of the part of it the rank holds.  So a collective's
conjugate depends on what consumes its output:

* a sum whose output every rank uses alike (`reduce`, `row`'s sum): the
  identity (`_Reduce`, `_Row`);
* a gather whose output every rank uses alike (the MoE outputs, a leaf
  gathered where the axis does not divide the units): the rank's own
  block, no sum (`_Gather`, part=False);
* a gather whose output each rank uses for its own part of the work (MLA's
  c, wk and wv where the query heads are split and the KV heads are not,
  in_proj and conv_w across their concatenations): the sum over the axis
  of the ranks' partial gradients, each keeping its block, one
  reduce-scatter (part=True);
* a value whole over the axis entering the rank's own part of the work (x
  into a column-cut product, `column`; the MoE buffer narrowed to the
  rank's experts; the unembedding's input; a whole leaf narrowed to the
  rank's units, `take` with part=True; a sum every rank then uses for its
  own block, the gated norm's squares): identity forward, the float32
  sum over the axis backward (`_Enter`, `_Column`: Megatron's "f"), one
  per product, rounded once, as one device rounds each product's input
  gradient once and then adds them.

Where the axis does not divide the units (split False), every rank does
all the work alike and no sum is taken.  At one rank each sum is a copy,
and the step has one device's bits.
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


class _Gather(torch.autograd.Function):
    """Every rank's x concatenated along `dim`.  Backward: part=False (every
    rank uses the whole alike, so its gradient arrives whole and equal on
    every rank): the rank's own block; part=True (each rank uses it for its
    own part of the work, so the ranks' gradients are partials): the sum
    over the axis of every rank's gradient, the rank keeping its block (one
    reduce-scatter, in float32, rounded to x's dtype once)."""

    @staticmethod
    def forward(ctx, g, x, dim, part):
        ctx.g, ctx.dim, ctx.n, ctx.part = g, dim, x.shape[dim], part
        with record_function("lm.tp_gather"):
            return rules.gather_dim(g, x, dim)

    @staticmethod
    def backward(ctx, grad):
        g, dim, n = ctx.g, ctx.dim, ctx.n
        if not ctx.part:
            return None, grad.narrow(dim, g.rank * n, n), None, None
        with record_function("lm.tp_scatter"):
            rows = grad.unflatten(dim, (g.size, n)).movedim(dim, 0).float()
            return None, g.scatter_sum(rows).to(grad.dtype), None, None


class _Enter(torch.autograd.Function):
    """A value whole over the axis entering work that each rank does for its
    own part (Megatron's "f"): the identity forward; backward, the float32
    sum over the axis of every rank's partial gradient, rounded to the
    value's dtype once (`lm.tp_sum`)."""

    @staticmethod
    def forward(ctx, g, x):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        with record_function("lm.tp_sum"):
            return None, ctx.g.grad_sum(grad).to(grad.dtype)


class _Reduce(torch.autograd.Function):
    """The float32 sum over the axis of every rank's x (`lm.tp_reduce`).  Its
    output is used alike on every rank, so its gradient arrives whole on
    each, and that is each rank's partial's gradient: the identity."""

    @staticmethod
    def forward(ctx, g, x):
        ctx.dtype = x.dtype
        with record_function("lm.tp_reduce"):
            return g.reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return None, grad.to(ctx.dtype)


def _mat(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1])


class _Row(torch.autograd.Function):
    """x @ w summed over the axis (x: the rank's units, w: their rows): each
    rank's float32 partial (`partial`) summed, then rounded to x's dtype
    once.  Backward: one device's `MmBackward` of x @ w, the bf16 products
    grad @ w.T and x.T @ grad (the float32-output product has no
    derivative, and one device's backward never forms one)."""

    @staticmethod
    def forward(ctx, g, x, w):
        ctx.save_for_backward(x, w)
        return reduce(g, partial(x, w)).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        g2 = _mat(grad)
        return None, g2.mm(w.t()).reshape(x.shape), _mat(x).t().mm(g2)


class _Column(torch.autograd.Function):
    """x @ w with x whole over the axis and w the rank's columns: one
    device's product forward.  Backward: w's gradient x.T @ grad as one
    device's; x's the float32-output product grad @ w.T (`partial`), summed
    over the axis in float32 and rounded to x's dtype once (one device
    rounds each product's input gradient once, then adds them)."""

    @staticmethod
    def forward(ctx, g, x, w):
        ctx.g = g
        ctx.save_for_backward(x, w)
        return _mat(x).mm(w).reshape(tuple(x.shape[:-1]) + (w.shape[-1],))

    @staticmethod
    def backward(ctx, grad):
        x, w = ctx.saved_tensors
        g2 = _mat(grad)
        dx = partial(g2, w.t())
        with record_function("lm.tp_sum"):
            dx = ctx.g.grad_sum(dx).to(x.dtype)
        return None, dx.reshape(x.shape), _mat(x).t().mm(g2)


def gather(g, x: torch.Tensor, dim: int, part: bool = False) -> torch.Tensor:
    """Every rank's x concatenated along `dim` in rank order (`_Gather`:
    part says whether each rank then uses it for its own part of the
    work)."""
    return _Gather.apply(g, x, dim, part)


def whole(g, x: torch.Tensor, dim: int, n: int, part: bool = False) -> torch.Tensor:
    """x whole along `dim` (n entries): as it is if whole, else the ranks'
    blocks gathered."""
    return x if x.shape[dim] == n else gather(g, x, dim, part)


def enter(g, x: torch.Tensor) -> torch.Tensor:
    """x, whose gradient is summed over the axis in the backward (`_Enter`)."""
    return _Enter.apply(g, x)


def take(g, leaf: torch.Tensor, dim: int, ranges: Ranges, n: int, part: bool = False
         ) -> torch.Tensor:
    """The entries `ranges` ([lo, hi) pairs, concatenated) along `dim` of a
    leaf whose whole size there is n, held whole or as the rank's block
    (the module's docstring).  part: the caller uses the entries for the
    rank's own part of the work (its units split over the axis), so each
    rank's gradient of them is a partial, and the leaf's gradient is
    summed over the axis here: a gathered block by the gather's
    reduce-scatter, a whole leaf by `enter`.  The rank's own block used as
    it is needs no sum: no other rank uses it."""
    have = leaf.shape[dim]
    if have != n:
        lo = g.rank * have
        if list(ranges) == [(lo, lo + have)]:
            return leaf
        leaf = gather(g, leaf, dim, part)
    elif part:
        leaf = enter(g, leaf)
    parts = [leaf.narrow(dim, lo, hi - lo) for lo, hi in ranges]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def reduce(g, x: torch.Tensor) -> torch.Tensor:
    """The float32 sum over the model axis (`_Reduce`)."""
    return _Reduce.apply(g, x)


def partial(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w (w in x's dtype) as float32, not rounded to x's dtype.  bf16 on
    the card: the bf16 GEMM with a float32 output, which accumulates as one
    device's bf16 matmul does before its rounding; otherwise the product of
    the operands widened to float32 (exact products, float32 sums)."""
    w = w.to(x.dtype)
    if x.is_cuda and x.dtype == torch.bfloat16:
        out = torch.mm(_mat(x), w, out_dtype=torch.float32)
        return out.reshape(tuple(x.shape[:-1]) + (w.shape[-1],))
    return x.float() @ w.float()


def column(g, x: torch.Tensor, w: torch.Tensor, part: bool) -> torch.Tensor:
    """x @ w for x whole over the model axis.  part: w is the rank's columns,
    or its output is used for the rank's own part of the work, so x's
    gradient from this product is a partial, summed over the axis
    (`_Column`); else one device's product."""
    w = w.to(x.dtype)
    return _Column.apply(g, x, w) if part else x @ w


def row(g, x: torch.Tensor, w: torch.Tensor, ranges: Ranges, n: int, summed: bool
        ) -> torch.Tensor:
    """x @ w[ranges] with w's rows cut to the units x holds.  summed (the
    units are split over the model axis): each rank's float32 partial is
    summed over the axis, then rounded to x's dtype once (`_Row`); else
    the one device's product."""
    w = take(g, w, 0, ranges, n, summed).to(x.dtype)
    if not summed:
        return x @ w
    return _Row.apply(g, x, w)


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
