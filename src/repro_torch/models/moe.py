"""Mixture-of-Experts layer: top-k routing with capacity-based sparse dispatch
(port of `repro.models.moe`).

* Dispatch is sort-free and row-local: each assignment's rank within its
  expert is a cumulative count of one-hots over the row's flattened (S*k)
  assignment order; an expert takes its first `capacity` assignments, the
  rest go to an overflow bin at `E * C` that is sliced off.  Expert FFNs
  run as batched einsums over the (B, E, C, d) buffer, so FLOPs follow the
  capacity, not E x tokens.
* Experts use SwiGLU; shared experts are a plain dense SwiGLU of width
  n_shared * moe_d_ff applied to every token.
* Router softmax and gate renormalisation run in float32.
* Top-k: a stable descending sort, so on a tie the lower expert index
  comes first, as `jax.lax.top_k` puts it.
* Gradients reach the router (through the gates), the experts and the
  shared experts; `load_balancing_loss` is there for a training loop.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn
from torch.profiler import record_function

from repro_torch.models import layers as L
from repro_torch.models import tp
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import hints


class SwiGLU(nn.Module):
    def __init__(self, d: int, f: int, gen, device):
        super().__init__()
        self.wi = L.he_init((d, f), gen, device)
        self.wg = L.he_init((d, f), gen, device)
        self.wo = L.he_init((f, d), gen, device, fan_in=f)


def swiglu(p: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    h = L.silu(x @ p.wg.to(x.dtype)) * (x @ p.wi.to(x.dtype))
    return h @ p.wo.to(x.dtype)


def mlp_apply(p: SwiGLU, x: torch.Tensor, width: int) -> torch.Tensor:
    """A dense layer's SwiGLU of `width` hidden units.  On a layout: wi and
    wg column-cut, wo row-cut over the model axis (the rank's hidden
    units), one float32 sum over the axis."""
    g = tp.group()
    if g is None:
        return swiglu(p, x)
    f0, f1, split = tp.split(width, g)
    cols = [(f0, f1)]
    h = L.silu(tp.column(g, x, tp.take(g, p.wg, 1, cols, width, split), split)) \
        * tp.column(g, x, tp.take(g, p.wi, 1, cols, width, split), split)
    return tp.row(g, h, p.wo, cols, width, split)


class MoE(nn.Module):
    def __init__(self, cfg: ModelConfig, gen, device):
        super().__init__()
        e, d, f = cfg.num_experts, cfg.d_model, cfg.moe_d_ff
        self.router = L.he_init((d, e), gen, device, dtype=torch.float32)
        self.wi = L.he_init((e, d, f), gen, device)
        self.wg = L.he_init((e, d, f), gen, device)
        self.wo = L.he_init((e, f, d), gen, device, fan_in=f)
        if cfg.num_shared_experts:
            self.shared = SwiGLU(d, f * cfg.num_shared_experts, gen, device)


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    c = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(8, (c + 7) // 8 * 8)


def route(p: MoE, x: torch.Tensor, cfg: ModelConfig):
    """Router in float32: (gate (B,S,k) renormalised, expert (B,S,k) int64,
    probs (B,S,E))."""
    probs = torch.softmax(x.float() @ p.router, dim=-1)            # (B, S, E)
    gate, expert = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert = gate[..., :cfg.top_k], expert[..., :cfg.top_k]
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    return gate, expert, probs


class Dispatch(NamedTuple):
    rank: torch.Tensor            # (B, S*k) int32: rank within the expert
    keep: torch.Tensor            # (B, S*k) bool: rank < capacity
    slot: torch.Tensor            # (B, S*k) int64: e * C + rank, or E * C (overflow)


def dispatch(expert: torch.Tensor, num_experts: int, cap: int) -> Dispatch:
    """The integer dispatch of (B, S, k) expert choices into (E, C) slots."""
    b, s, k = expert.shape
    e = num_experts
    flat_e = expert.reshape(b, s * k)
    one_hot = (flat_e[..., None] == torch.arange(e, device=expert.device)).to(torch.int32)
    rank = torch.gather(torch.cumsum(one_hot, dim=1, dtype=torch.int32) - 1, 2,
                        flat_e[..., None])[..., 0]                  # (B, S*k)
    keep = rank < cap
    # Kept slots are distinct (ranks count up within an expert); every
    # dropped assignment lands in the overflow column E * C.
    return Dispatch(rank, keep, torch.where(keep, flat_e * cap + rank, e * cap))


def moe_apply(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d).  Row-local dispatch (capacity per row).

    The (B, E, C, d) buffer is built by writing each kept assignment's token
    to its slot (kept slots are distinct, so an index_put without
    accumulation is exact; dropped ones all land in the overflow column,
    sliced off, whichever of them wins it), which holds what the
    reference's gather through its slot->token map holds.  Its backward
    gathers, and the combine reads the outputs through a zero overflow
    row: every kept slot's gradient comes from one assignment, so neither
    backward depends on the order of an atomic accumulation."""
    with record_function("lm.moe"):
        b, s, d = x.shape
        e, k = cfg.num_experts, cfg.top_k
        cap = _capacity(s, cfg)
        gate, expert, _ = route(p, x, cfg)
        dsp = dispatch(expert, e, cap)

        grp = tp.group()
        e0, e1, split = (0, e, False) if grp is None else tp.split(e, grp)
        # The buffer is narrowed to the rank's experts: x's gradient through
        # it is the rank's partial, summed over the model axis.
        x_in = tp.enter(grp, x) if split else x
        rows = torch.arange(b, device=x.device)[:, None]
        x_k = x_in[:, :, None, :].expand(b, s, k, d).reshape(b, s * k, d)
        hidden = torch.index_put(x.new_zeros((b, e * cap + 1, d)), (rows, dsp.slot), x_k)
        hidden = hidden[:, :e * cap].reshape(b, e, cap, d)             # (B, E, C, d)
        hidden = hints.hint_moe_buffer(hidden, e)
        wi, wg, wo = p.wi, p.wg, p.wo
        if grp is not None:
            wi, wg, wo = (tp.take(grp, w, 0, [(e0, e1)], e, split) for w in (wi, wg, wo))

        g = L.silu(torch.einsum('becd,edf->becf', hidden, wg.to(x.dtype)))
        u = torch.einsum('becd,edf->becf', hidden, wi.to(x.dtype))
        y = hints.hint_moe_buffer(torch.einsum('becf,efd->becd', g * u, wo.to(x.dtype)), e)
        if split:
            y = tp.gather(grp, y, 1)                                   # every expert's outputs
        y = y.reshape(b, e * cap, d)

        # combine: each token gathers its k expert outputs (zero if dropped)
        y_pad = torch.cat([y, y.new_zeros((b, 1, d))], dim=1)
        picked = y_pad[rows, dsp.slot].reshape(b, s, k, d)
        out = hints.hint_batch(torch.einsum('bskd,bsk->bsd', picked, gate.to(x.dtype)))
        if cfg.num_shared_experts:
            out = out + swiglu(p.shared, x)
        return out


def load_balancing_loss(router_probs: torch.Tensor, expert_idx: torch.Tensor,
                        e: int) -> torch.Tensor:
    """Switch-style aux loss over (T, E) router probabilities and (T, k)
    choices: e * sum(mean probability x share of first choices).  Exposed
    for a training loop; `loss_fn` does not call it, as the reference's
    does not.  On a tensor-parallel layout every rank routes every token
    with the whole router, so its inputs, and it, are whole on every rank
    and its gradient needs no sum over the model axis."""
    me = router_probs.mean(dim=0)
    ce = torch.nn.functional.one_hot(expert_idx[:, 0], e).to(router_probs.dtype).mean(dim=0)
    return e * torch.sum(me * ce)
