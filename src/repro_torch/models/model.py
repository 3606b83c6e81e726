"""Model assembly: config -> init / train / prefill / decode
(port of `repro.models.model`).

The reference scans stacked (L, ...) layer parameters; here each stack is an
`nn.ModuleList` of per-layer modules (the converter splits the stacked
leaves, `repro_torch.convert`) and a Python loop runs it.  Caches follow the
same layout: {stack name: [per-layer cache dict]}, updated in place by
prefill and decode and returned.

Family wiring
-------------
dense / vlm / audio : [attn + SwiGLU] x L
moe                 : `moe_layer_step`-sized super-layers, last sub-layer MoE
                      (llama4: step 2 -> dense,MoE pairs; deepseek: step 1 with
                      `first_dense_layers` dense prefix)
ssm                 : [mamba2] x L
hybrid (zamba2)     : [mamba2] x L with ONE shared attention+MLP block applied
                      after every `shared_attn_every`-th layer (weights shared
                      across sites, a KV cache per site)
audio (hubert)      : encoder (bidirectional), input = precomputed frame
                      embeddings (frontend stub), no decode path

The reference's sharding anchors (`repro.sharding.hints`) do nothing without
a mesh; the single-device port calls nothing in their place.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from repro_torch import device as _device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import moe as E
from repro_torch.models.config import ModelConfig

Caches = Dict[str, List[Dict[str, torch.Tensor]]]
STACKS = ("layers", "dense_prefix", "dense_inter")   # the reference's stacked subtrees


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

class DenseLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, d_ff: int, gen, device):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, device)
        self.attn = A.attention_init(cfg, gen, device)
        self.ln2 = L.RMSNorm(cfg.d_model, device)
        self.mlp = E.SwiGLU(cfg.d_model, d_ff, gen, device)


class MoELayer(nn.Module):
    def __init__(self, cfg: ModelConfig, gen, device):
        super().__init__()
        self.ln1 = L.RMSNorm(cfg.d_model, device)
        self.attn = A.attention_init(cfg, gen, device)
        self.ln2 = L.RMSNorm(cfg.d_model, device)
        self.moe = E.MoE(cfg, gen, device)


class MambaLayer(nn.Module):
    def __init__(self, cfg: ModelConfig, gen, device):
        super().__init__()
        self.ln = L.RMSNorm(cfg.d_model, device)
        self.mixer = M.Mamba2(cfg, gen, device)


def _dense_layer_apply(p: DenseLayer, x, cfg, cache=None, cache_pos=None):
    h, cache = A.attention_apply(p.attn, p.ln1(x, cfg.norm_eps), cfg, cache, cache_pos)
    x = x + h
    x = x + E.swiglu(p.mlp, p.ln2(x, cfg.norm_eps))
    return x, cache


def _moe_layer_apply(p: MoELayer, x, cfg, cache=None, cache_pos=None):
    h, cache = A.attention_apply(p.attn, p.ln1(x, cfg.norm_eps), cfg, cache, cache_pos)
    x = x + h
    x = x + E.moe_apply(p.moe, p.ln2(x, cfg.norm_eps), cfg)
    return x, cache


def _mamba_layer_apply(p: MambaLayer, x, cfg, cache=None, cache_pos=None):
    h, cache = M.mamba2_apply(p.mixer, p.ln(x, cfg.norm_eps), cfg, cache, cache_pos)
    return x + h, cache


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def _super_layers(cfg: ModelConfig) -> int:
    rest = cfg.num_layers - cfg.first_dense_layers
    if rest % cfg.moe_layer_step:
        raise ValueError(f"{cfg.name}: {rest} layers after the dense prefix are not whole "
                         f"super-layers of {cfg.moe_layer_step}")
    return rest // cfg.moe_layer_step


class LMModel(nn.Module):
    """The parameter tree of one config.  gen=None leaves the parameters
    uninitialised (`repro_torch.convert` fills them)."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator], device):
        super().__init__()
        self.cfg = cfg
        self.final_norm = L.RMSNorm(cfg.d_model, device)
        if cfg.family == "audio":
            self.frontend = L.Linear(cfg.frontend_dim, cfg.d_model, gen, device)
        else:
            self.embed = L.Embedding(cfg.vocab_size, cfg.d_model, gen, device)
        if not cfg.tie_embeddings:
            self.head = L.Linear(cfg.d_model, cfg.vocab_size, gen, device)

        stack = lambda n, make: nn.ModuleList(make() for _ in range(n))
        dense = lambda: DenseLayer(cfg, cfg.d_ff, gen, device)
        if cfg.family in ("dense", "vlm", "audio"):
            self.layers = stack(cfg.num_layers, dense)
        elif cfg.family == "moe":
            n_super = _super_layers(cfg)
            if cfg.first_dense_layers:
                self.dense_prefix = stack(cfg.first_dense_layers, dense)
            if cfg.moe_layer_step > 1:
                self.dense_inter = stack(n_super * (cfg.moe_layer_step - 1), dense)
            self.layers = stack(n_super, lambda: MoELayer(cfg, gen, device))
        elif cfg.family in ("ssm", "hybrid"):
            self.layers = stack(cfg.num_layers, lambda: MambaLayer(cfg, gen, device))
            if cfg.family == "hybrid":
                self.shared_attn = dense()
        else:
            raise ValueError(cfg.family)


def init_params(cfg: ModelConfig, seed: int, device: str | torch.device = "cuda") -> LMModel:
    """The port's own random init: every leaf drawn from one `torch.Generator`
    seeded with `seed` on `device` (its values are not the reference's
    threefry draws; shapes, dtypes and per-leaf standard deviations are)."""
    dev = _device.resolve(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return LMModel(cfg, gen, dev)


def make_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device: str | torch.device = "cuda") -> Caches:
    """Decode caches, one dict per layer of each stack (the reference's
    stacked leaves split along their leading axis)."""
    dev = _device.resolve(device)
    attn = lambda n: [A.attention_make_cache(cfg, batch, max_seq, dev) for _ in range(n)]
    if cfg.family in ("dense", "vlm"):
        return {"layers": attn(cfg.num_layers)}
    if cfg.family == "moe":
        n_super = _super_layers(cfg)
        out = {"layers": attn(n_super)}
        if cfg.first_dense_layers:
            out["dense_prefix"] = attn(cfg.first_dense_layers)
        if cfg.moe_layer_step > 1:
            out["dense_inter"] = attn(n_super * (cfg.moe_layer_step - 1))
        return out
    if cfg.family in ("ssm", "hybrid"):
        out = {"layers": [M.mamba2_make_cache(cfg, batch, dev) for _ in range(cfg.num_layers)]}
        if cfg.family == "hybrid":
            out["shared_attn"] = attn(cfg.num_layers // cfg.shared_attn_every)
        return out
    raise ValueError(f"{cfg.family} has no decode cache")


def _run(apply_fn, layers, x, cfg, caches, cache_pos):
    for i, lp in enumerate(layers):
        x, _ = apply_fn(lp, x, cfg, caches[i] if caches is not None else None, cache_pos)
    return x


def _hybrid_stack(model: LMModel, x, cfg, caches=None, cache_pos=None):
    """Mamba layers with the shared attention block after every k-th layer:
    layer i (i % k == k - 1) is followed by site i // k, with its own cache."""
    k = cfg.shared_attn_every
    for i, lp in enumerate(model.layers):
        x, _ = _mamba_layer_apply(lp, x, cfg, caches["layers"][i] if caches else None,
                                  cache_pos)
        if i % k == k - 1:
            site = caches["shared_attn"][i // k] if caches else None
            x, _ = _dense_layer_apply(model.shared_attn, x, cfg, site, cache_pos)
    return x


def backbone(model: LMModel, x: torch.Tensor, caches: Optional[Caches] = None,
             cache_pos: Optional[int] = None) -> torch.Tensor:
    """Hidden-states trunk shared by train/prefill/decode."""
    cfg = model.cfg
    c = (lambda name: caches[name]) if caches is not None else (lambda name: None)
    if cfg.family in ("dense", "vlm", "audio"):
        x = _run(_dense_layer_apply, model.layers, x, cfg, c("layers"), cache_pos)
    elif cfg.family == "moe":
        if cfg.first_dense_layers:
            x = _run(_dense_layer_apply, model.dense_prefix, x, cfg, c("dense_prefix"),
                     cache_pos)
        step = cfg.moe_layer_step
        for s, mp in enumerate(model.layers):
            # super-layer: (step-1) dense layers then one MoE layer
            for j in range(s * (step - 1), (s + 1) * (step - 1)):
                dc = caches["dense_inter"][j] if caches is not None else None
                x, _ = _dense_layer_apply(model.dense_inter[j], x, cfg, dc, cache_pos)
            mc = caches["layers"][s] if caches is not None else None
            x, _ = _moe_layer_apply(mp, x, cfg, mc, cache_pos)
    elif cfg.family == "ssm":
        x = _run(_mamba_layer_apply, model.layers, x, cfg, c("layers"), cache_pos)
    elif cfg.family == "hybrid":
        x = _hybrid_stack(model, x, cfg, caches, cache_pos)
    else:
        raise ValueError(cfg.family)
    return model.final_norm(x, cfg.norm_eps)


def _logits(model: LMModel, x: torch.Tensor) -> torch.Tensor:
    with record_function("lm.logits"):
        if model.cfg.tie_embeddings:
            return L.unembed(model.embed.table, x)
        return x.float() @ model.head.w.float()


def embed_inputs(model: LMModel, inputs: torch.Tensor) -> torch.Tensor:
    if model.cfg.family == "audio":
        return model.frontend(inputs.to(L.ACT_DTYPE))
    return L.embed(model.embed.table, inputs)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def forward_train(model: LMModel, inputs: torch.Tensor) -> torch.Tensor:
    """-> f32 logits (B, S, V).  The encoder's serve path and the reference
    the decode path is held against."""
    return _logits(model, backbone(model, embed_inputs(model, inputs)))


def forward_prefill(model: LMModel, inputs: torch.Tensor, caches: Caches
                    ) -> Tuple[torch.Tensor, Caches]:
    """Fill the caches with the prompt; return last-position logits (B, 1, V)."""
    with record_function("lm.prefill"):
        x = backbone(model, embed_inputs(model, inputs), caches)
        return _logits(model, x[:, -1:, :]), caches


def forward_decode(model: LMModel, token: torch.Tensor, caches: Caches, cache_pos: int
                   ) -> Tuple[torch.Tensor, Caches]:
    """One decode step.  token: (B, 1) integer (or (B, 1, F) features);
    cache_pos: the position it is written at."""
    with record_function("lm.decode"):
        x = backbone(model, embed_inputs(model, token), caches, int(cache_pos))
        return _logits(model, x), caches
