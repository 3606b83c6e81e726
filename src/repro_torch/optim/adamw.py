"""AdamW with warmup-cosine schedule and global-norm clipping (port of
`repro.optim.adamw`).

Moments are float32 whatever the parameter dtype; the optional float32
master copy (`master_weights=True`) makes bf16 training drift-free.  The
optimizer state holds dicts keyed by the model's parameter names (the
reference tree's paths, `repro_torch.convert`), so it mirrors the
parameters leaf for leaf.

`update` writes its results into the tensors it is given (the parameters,
mu, nu and master) and returns them, as a jitted reference step with
donated buffers does: two copies of the float32 state do not fit beside a
3-billion-parameter model on one card.  Copy a state first
(`launch.steps.clone_state`) to keep it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]
_UPDATE_ELEMENTS = 1 << 26     # elements of a leaf updated at once


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    master_weights: bool = True


class OptState(NamedTuple):
    mu: Params
    nu: Params
    master: Optional[Params]      # float32 copy when master_weights
    count: torch.Tensor           # 0-d int32


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at `step` (a tensor), in float32 as the reference."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) \
        * 0.5 * (1.0 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def init(params: Params, cfg: OptConfig) -> OptState:
    dev = next(iter(params.values())).device
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=dev)
             for k, p in params.items()}
    master = {k: p.detach().to(torch.float32, copy=True) for k, p in params.items()} \
        if cfg.master_weights else None
    return OptState(mu=zeros, nu={k: z.clone() for k, z in zeros.items()}, master=master,
                    count=torch.zeros((), dtype=torch.int32, device=dev))


def _ref_order(name: str) -> Tuple[Tuple[str, ...], int]:
    """A parameter name's reference leaf path and its row in that leaf (0 for
    a leaf that is not stacked)."""
    from repro_torch.models.model import ref_path
    keys, row = ref_path(name)
    return keys, row or 0


def leaf_order(names) -> list:
    """Names in the reference's leaf order: its flattening sorts dict keys
    at every level, and a stacked leaf's rows follow one another."""
    return sorted(names, key=_ref_order)


def square_sums(tree: Params) -> Params:
    """The sum of squares of every leaf, in float32."""
    return {k: torch.sum(torch.square(v.to(torch.float32))) for k, v in tree.items()}


def norm_of(sums: Params) -> torch.Tensor:
    """sqrt of per-leaf sums of squares added in the reference's leaf order."""
    total = None
    for k in leaf_order(sums):
        total = sums[k] if total is None else total + sums[k]
    return torch.sqrt(total)


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in float32; the per-leaf sums
    are added in the reference's leaf order."""
    return norm_of(square_sums(tree))


def _decay_mask(name: str) -> bool:
    """No weight decay on norms, biases and scalars, by the reference's rule
    on `str(DictKey)` of the leaf, "['<leaf>']": it matches `scale`, `bias`,
    `a_log`, `d_skip`, `dt_bias`, and `b'`, a leaf name ending in b (`b`,
    `conv_b`; not `bq`, `bk`, `bv`, which are decayed)."""
    leaf = f"[{name.split('.')[-1]!r}]"
    return not any(s in leaf for s in ("scale", "b'", "bias", "a_log", "d_skip", "dt_bias"))


@torch.no_grad()
def update(grads: Params, state: OptState, params: Params, cfg: OptConfig,
           gnorm: Optional[torch.Tensor] = None) -> Tuple[Params, OptState]:
    """Returns (new_params, new_state), written into `params` and `state`'s
    tensors (see the module's docstring).  gnorm: the gradients' global norm
    when they are one rank's blocks of a layout (its step reduces it over
    the ranks); None computes it from `grads`."""
    count = state.count + 1
    gnorm = global_norm(grads) if gnorm is None else gnorm
    scale = torch.clamp(cfg.grad_clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, count)

    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - torch.pow(b1, count.to(torch.float32))
    c2 = 1.0 - torch.pow(b2, count.to(torch.float32))

    ref = state.master if cfg.master_weights else params
    for k in leaf_order(params):
        decay = bool(cfg.weight_decay) and _decay_mask(k)
        g_k = grads[k].reshape(-1)
        mu, nu, r, p = (t.view(-1) for t in (state.mu[k], state.nu[k], ref[k], params[k]))
        master = state.master[k].view(-1) if cfg.master_weights else None
        # Elementwise, so a slice at a time (bit for bit the whole leaf's
        # result): a vocab table's float32 temporaries stay small.
        for i in range(0, p.numel(), _UPDATE_ELEMENTS):
            sl = slice(i, i + _UPDATE_ELEMENTS)
            g = g_k[sl].to(torch.float32) * scale
            m = b1 * mu[sl] + (1 - b1) * g
            v = b2 * nu[sl] + (1 - b2) * g * g
            step_ = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
            pf = r[sl].to(torch.float32)
            if decay:
                step_ = step_ + cfg.weight_decay * pf
            new = pf - lr * step_
            mu[sl] = m
            nu[sl] = v
            if master is not None:
                master[sl] = new
            p[sl] = new.to(p.dtype)
    return params, OptState(mu=state.mu, nu=state.nu, master=state.master, count=count)
