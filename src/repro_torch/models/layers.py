"""Primitive layers: norms, embeddings, rotary position embeddings, linear
(port of `repro.models.layers`).

A layer that owns parameters is an `nn.Module` whose parameters carry the
reference's leaf names (`scale`, `table`, `w`, `b`), so a model's
`state_dict` keys are the reference tree's paths (`repro_torch.convert`).
The apply functions take tensors.  bf16 parameters and activations, with
norms, softmax, RoPE angles and the unembedding in float32, as in the
reference.  Parameters are trainable; `rms_norm`, `embed`, `linear`,
`unembed` and RoPE take autograd's gradients, and `silu` has its own
backward (the reference's rounding).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

PARAM_DTYPE = torch.bfloat16
ACT_DTYPE = torch.bfloat16

# A leaf is drawn in float32 at most this many elements at a time (a block
# of leading rows), so a 32 GB bf16 expert stack never has a float32 twin.
_DRAW_ELEMENTS = 1 << 26


def he_init(shape: Sequence[int], gen: Optional[torch.Generator], device,
            fan_in: Optional[int] = None, dtype=PARAM_DTYPE) -> nn.Parameter:
    """N(0, 1/fan_in) (fan_in defaults to shape[0], as in the reference),
    drawn in float32 from `gen` and cast to `dtype`.  With gen=None the
    parameter is left uninitialised (the converter fills it)."""
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    if gen is not None:
        std = 1.0 / math.sqrt(fan_in or shape[0])
        row = math.prod(shape[1:])
        step = max(1, _DRAW_ELEMENTS // max(row, 1))
        for i in range(0, shape[0], step):
            j = min(shape[0], i + step)
            draw = torch.randn((j - i,) + tuple(shape[1:]), generator=gen,
                               dtype=torch.float32, device=device)
            out[i:j] = (draw * std).to(dtype)
    return nn.Parameter(out)


def const_init(shape: Sequence[int], value: float, device,
               dtype=PARAM_DTYPE) -> nn.Parameter:
    return nn.Parameter(torch.full(tuple(shape), value, dtype=dtype, device=device))


# -- SiLU -------------------------------------------------------------------

def _logistic(x: torch.Tensor) -> torch.Tensor:
    return torch.reciprocal(torch.exp(-x) + 1)


class _SiLU(torch.autograd.Function):
    """JAX differentiates `x * logistic(x)` with logistic's own rule,
    ans * (1 - ans), on the rounded logistic `ans`: the cotangent is
    g * ans + (g * x) * (ans * (1 - ans)), each step rounded to x's dtype.
    Autograd through the forward's four steps would differentiate the
    expansion instead."""

    @staticmethod
    def forward(ctx, x):
        ans = _logistic(x)
        ctx.save_for_backward(x, ans)
        return x * ans

    @staticmethod
    def backward(ctx, g):
        x, ans = ctx.saved_tensors
        return g * ans + (g * x) * (ans * (1 - ans))


def silu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) as the reference computes it: `jax.nn.silu`'s logistic
    is expanded to 1 / (1 + exp(-x)) by XLA, each step rounded to x's dtype
    (torch's fused `F.silu` rounds once, and differs from it in a third of
    bf16 outputs)."""
    return _SiLU.apply(x)


# -- RMSNorm ----------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, device):
        super().__init__()
        self.scale = const_init((d,), 1.0, device)

    def forward(self, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        return rms_norm(x, self.scale, eps)


# -- Embedding ----------------------------------------------------------------

class Embedding(nn.Module):
    def __init__(self, vocab: int, d: int, gen, device):
        super().__init__()
        self.table = he_init((vocab, d), gen, device, fan_in=d)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    # Indexing's backward sorts the tokens before it sums their rows, so the
    # card gives the table's gradient the same bits on every run.
    return table[tokens].to(ACT_DTYPE)


def embed_split(g, table: torch.Tensor, tokens: torch.Tensor, vocab: int) -> torch.Tensor:
    """`embed` on a layout whose model axis cuts the table's vocab rows: each
    rank looks up the tokens its rows hold, writes zeros for the others, and
    the sum over the axis has one term other than zero per element, so it is
    exact (`models.tp`).  Where the axis does not divide the vocab the table
    is whole and this is `embed`."""
    from repro_torch.models import tp
    v0, v1, split = tp.split(vocab, g)
    rows = tp.take(g, table, 0, [(v0, v1)], vocab, split)
    if not split:
        return embed(rows, tokens)
    inside = (tokens >= v0) & (tokens < v1)
    local = embed(rows, (tokens - v0).clamp(0, v1 - v0 - 1))
    return tp.reduce(g, torch.where(inside[..., None], local, 0)).to(ACT_DTYPE)


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    # f32 logits for a stable softmax/cross-entropy.
    return x.float() @ table.float().T


# -- Linear -------------------------------------------------------------------

class Linear(nn.Module):
    def __init__(self, d_in: int, d_out: int, gen, device, bias: bool = False):
        super().__init__()
        self.w = he_init((d_in, d_out), gen, device)
        if bias:
            self.b = const_init((d_out,), 0.0, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.w, getattr(self, "b", None))


def linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


# -- Rotary position embeddings ----------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: broadcastable to (..., seq)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)         # (hd/2,)
    angles = positions[..., None].float() * freqs                  # (..., seq, hd/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
