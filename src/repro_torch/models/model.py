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

Layouts: the reference's activation anchors (`sharding.hints`) are called
at its sites; with no layout installed they are the identity and every
layer runs its single-device code.  Under a layout the serving steps
(`launch.steps.make_prefill_step(mesh=)`, `make_decode_step(mesh=)`)
install, each module holds the rank's blocks of its weights and each layer
computes its blocks over the model axis (`models.tp`): the embedding and
the logits by vocab rows, attention by heads (the caches by sequence
blocks), the MLP by hidden units, MoE by experts, Mamba2 by SSM heads.

Units: the training forward enters `unit(*modules)`, a context-manager
factory, around each unit's use of its weights: the embedding (or the
frontend), each entry of a layer stack, each MoE super-layer, the hybrid's
shared block at each site, and the unembedding (the tied table or the
head).  By default it does nothing; the FSDP train step
(`launch.steps.make_train_step(mesh=)`) gathers the unit's weight blocks
there and drops them after.  A remat unit's recomputation enters it again.

Training: `forward_train(remat=True)` recomputes each layer in the
backward (`torch.utils.checkpoint`, the reference's per-layer
`jax.checkpoint(nothing_saveable)`: each scanned layer, each MoE
super-layer, each hybrid body, recomputed under the layout the forward
ran under); `loss_fn` is the mean cross-entropy, vocab-parallel
(`_VocabCrossEntropy`) where the tensor-parallel train step
(`launch.steps.make_train_step(mesh=, dp_over_model=False)`) cuts the
logits' vocab over the model axis; the layers' collectives carry their
backward (`models.tp`).
Prefill and decode run under `torch.inference_mode()`: serving builds no
autograd graph.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from repro_torch import device as _device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import moe as E
from repro_torch.models import tp
from repro_torch.models.config import ModelConfig
from repro_torch.sharding import hints

Caches = Dict[str, List[Dict[str, torch.Tensor]]]
STACKS = ("layers", "dense_prefix", "dense_inter")   # the reference's stacked subtrees


def ref_path(name: str) -> Tuple[Tuple[str, ...], Optional[int]]:
    """A parameter name's reference leaf path and its row in that leaf (None
    for a leaf that is not stacked): the stacked groups carry the layer
    index as their second component ("layers.3.attn.wq" is row 3 of
    ("layers", "attn", "wq"))."""
    parts = name.split(".")
    if len(parts) > 2 and parts[0] in STACKS and parts[1].isdigit():
        return (parts[0],) + tuple(parts[2:]), int(parts[1])
    return tuple(parts), None


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
    x = hints.hint_batch(x)
    h, cache = A.attention_apply(p.attn, p.ln1(x, cfg.norm_eps), cfg, cache, cache_pos)
    x = x + h
    x = x + E.mlp_apply(p.mlp, p.ln2(x, cfg.norm_eps), cfg.d_ff)
    return x, cache


def _moe_layer_apply(p: MoELayer, x, cfg, cache=None, cache_pos=None):
    x = hints.hint_batch(x)
    h, cache = A.attention_apply(p.attn, p.ln1(x, cfg.norm_eps), cfg, cache, cache_pos)
    x = x + h
    x = x + E.moe_apply(p.moe, p.ln2(x, cfg.norm_eps), cfg)
    return x, cache


def _mamba_layer_apply(p: MambaLayer, x, cfg, cache=None, cache_pos=None):
    x = hints.hint_batch(x)
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


Unit = Callable[..., contextlib.AbstractContextManager]


def _no_unit(*modules) -> contextlib.AbstractContextManager:
    """The single-device unit: the weights are the modules' own."""
    return contextlib.nullcontext()


def _unit(body, x, remat: bool):
    """One remat unit: `body(x) -> x`, recomputed in the backward if remat.
    The recomputation runs under the layout the forward ran under
    (`sharding.hints`, which is per thread: autograd runs a card's backward
    on a thread of its own)."""
    if not remat:
        return body(x)
    installed = hints.installed()
    return checkpoint(body, x, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), hints.layout(*installed)))


def _run(apply_fn, layers, x, cfg, caches, cache_pos, remat=False, unit: Unit = _no_unit):
    for i, lp in enumerate(layers):
        cache = caches[i] if caches is not None else None

        def body(h, lp=lp, cache=cache):
            with unit(lp):
                return apply_fn(lp, h, cfg, cache, cache_pos)[0]
        x = _unit(body, x, remat and caches is None)
    return x


def _hybrid_stack(model: LMModel, x, cfg, caches=None, cache_pos=None, remat=False,
                  unit: Unit = _no_unit):
    """Mamba layers with the shared attention block after every k-th layer:
    layer i (i % k == k - 1) is followed by site i // k, with its own cache."""
    k = cfg.shared_attn_every

    def body(h, i):
        with unit(model.layers[i]):
            h, _ = _mamba_layer_apply(model.layers[i], h, cfg,
                                      caches["layers"][i] if caches else None, cache_pos)
        if i % k == k - 1:
            site = caches["shared_attn"][i // k] if caches else None
            with unit(model.shared_attn):
                h, _ = _dense_layer_apply(model.shared_attn, h, cfg, site, cache_pos)
        return h

    for i in range(len(model.layers)):
        x = _unit(lambda h, i=i: body(h, i), x, remat and caches is None)
    return x


def backbone(model: LMModel, x: torch.Tensor, caches: Optional[Caches] = None,
             cache_pos: Optional[int] = None, remat: bool = False,
             unit: Unit = _no_unit) -> torch.Tensor:
    """Hidden-states trunk shared by train/prefill/decode.  remat (training
    only, no caches): only the units' inputs are kept for the backward."""
    cfg = model.cfg
    c = (lambda name: caches[name]) if caches is not None else (lambda name: None)
    if cfg.family in ("dense", "vlm", "audio"):
        x = _run(_dense_layer_apply, model.layers, x, cfg, c("layers"), cache_pos, remat, unit)
    elif cfg.family == "moe":
        if cfg.first_dense_layers:
            x = _run(_dense_layer_apply, model.dense_prefix, x, cfg, c("dense_prefix"),
                     cache_pos, remat, unit)
        step = cfg.moe_layer_step

        def super_layer(h, s):
            # (step-1) dense layers then one MoE layer
            inter = range(s * (step - 1), (s + 1) * (step - 1))
            with unit(*(model.dense_inter[j] for j in inter), model.layers[s]):
                for j in inter:
                    dc = caches["dense_inter"][j] if caches is not None else None
                    h, _ = _dense_layer_apply(model.dense_inter[j], h, cfg, dc, cache_pos)
                mc = caches["layers"][s] if caches is not None else None
                h, _ = _moe_layer_apply(model.layers[s], h, cfg, mc, cache_pos)
            return h

        for s in range(len(model.layers)):
            x = _unit(lambda h, s=s: super_layer(h, s), x, remat and caches is None)
    elif cfg.family == "ssm":
        x = _run(_mamba_layer_apply, model.layers, x, cfg, c("layers"), cache_pos, remat, unit)
    elif cfg.family == "hybrid":
        x = _hybrid_stack(model, x, cfg, caches, cache_pos, remat, unit)
    else:
        raise ValueError(cfg.family)
    return model.final_norm(x, cfg.norm_eps)


def _logits(model: LMModel, x: torch.Tensor, unit: Unit = _no_unit) -> torch.Tensor:
    """f32 logits; on a layout the rank's vocab block (the tied table's rows
    or the head's columns: no collective in the forward; x's gradient, a
    partial of the rank's block, is summed over the model axis)."""
    cfg, g = model.cfg, tp.group()
    x = hints.hint_batch(x)
    v0, v1, split = (0, cfg.vocab_size, False) if g is None else tp.split(cfg.vocab_size, g)
    vocab = lambda leaf, dim: leaf if g is None else tp.take(
        g, leaf, dim, [(v0, v1)], cfg.vocab_size, split)
    with record_function("lm.logits"):
        xf = x.float()
        if split:
            xf = tp.enter(g, xf)
        if cfg.tie_embeddings:
            with unit(model.embed):
                out = L.unembed(vocab(model.embed.table, 0), xf)
        else:
            with unit(model.head):
                out = xf @ vocab(model.head.w, 1).float()
        return hints.hint_logits(out, cfg.vocab_size)


def embed_inputs(model: LMModel, inputs: torch.Tensor, unit: Unit = _no_unit) -> torch.Tensor:
    """On a layout: the table's vocab rows summed over the model axis
    (`layers.embed_split`), or the frontend whole (its columns, cut over the
    model axis, are gathered: the activation is whole over it)."""
    cfg, g = model.cfg, tp.group()
    if cfg.family == "audio":
        with unit(model.frontend):
            feats = inputs.to(L.ACT_DTYPE)
            if g is None:
                x = model.frontend(feats)
            else:
                x = L.linear(feats, tp.take(g, model.frontend.w, 1, [(0, cfg.d_model)],
                                            cfg.d_model))
    else:
        with unit(model.embed):
            x = L.embed(model.embed.table, inputs) if g is None else \
                L.embed_split(g, model.embed.table, inputs, cfg.vocab_size)
    return hints.hint_batch(x)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def forward_train(model: LMModel, inputs: torch.Tensor, remat: bool = False,
                  unit: Unit = _no_unit) -> torch.Tensor:
    """-> f32 logits (B, S, V).  The training forward, the encoder's serve
    path and the reference the decode path is held against.  unit: entered
    around each unit's use of its weights (the module's docstring)."""
    x = backbone(model, embed_inputs(model, inputs, unit), remat=remat, unit=unit)
    return _logits(model, x, unit)


_LOSS_ROWS = 1024      # rows of logits whose softmax temporaries exist at once


def _row_lse(flat: torch.Tensor) -> torch.Tensor:
    """logsumexp of each row of (N, V) logits, `_LOSS_ROWS` rows at a time."""
    return torch.cat([torch.logsumexp(flat[i:i + _LOSS_ROWS], dim=-1)
                      for i in range(0, flat.shape[0], _LOSS_ROWS)])


def _xent_grad(logits: torch.Tensor, lab: torch.Tensor, lse: torch.Tensor, w: torch.Tensor,
               at_label: torch.Tensor) -> torch.Tensor:
    """The cross-entropy's gradient exp(logits - lse) * w, less `at_label` at
    each row's label column, written `_LOSS_ROWS` rows at a time into one
    buffer of the logits' shape."""
    flat = logits.reshape(-1, logits.shape[-1])
    grad = torch.empty_like(flat)
    for i in range(0, flat.shape[0], _LOSS_ROWS):
        torch.mul(torch.exp(flat[i:i + _LOSS_ROWS] - lse[i:i + _LOSS_ROWS, None]), w,
                  out=grad[i:i + _LOSS_ROWS])
    rows = torch.arange(flat.shape[0], device=flat.device)
    grad[rows, lab[:, 0]] = grad[rows, lab[:, 0]] - at_label   # one label a row: no accumulation
    return grad.reshape(logits.shape)


class _MeanCrossEntropy(torch.autograd.Function):
    """mean(logsumexp(logits) - gold) over every (B, S) row.  The gold logit
    is taken with a gather: the reference's iota-mask sum adds zeros to that
    one value, so both give the same bits.  Temporaries are `_LOSS_ROWS`
    rows at a time, and the backward writes its (B, S, V) gradient into one
    buffer: no copy of the logits' size beyond the logits and their
    gradient (qwen2-0.5b at 4 x 4096: 9.96 GB each)."""

    @staticmethod
    def forward(ctx, logits, labels):
        flat = logits.reshape(-1, logits.shape[-1])
        lse = _row_lse(flat)
        lab = labels.reshape(-1, 1).long()
        gold = torch.gather(flat, 1, lab)[:, 0]
        ctx.save_for_backward(logits, lab, lse)
        return torch.mean(lse - gold)

    @staticmethod
    def backward(ctx, g):
        logits, lab, lse = ctx.saved_tensors
        w = g / lab.shape[0]
        return _xent_grad(logits, lab, lse, w, w), None


class _VocabCrossEntropy(torch.autograd.Function):
    """`_MeanCrossEntropy` of logits whose vocab is cut over the model axis
    (each rank holds the columns [v0, v0 + V/m)).  Each rank's logsumexp
    of its block is gathered over the axis (one float a row) and combined
    as max + log(sum exp(lse_r - max)); the gold logit comes from the rank
    whose block holds the label and is summed over the axis (one term other
    than zero: exact).  The backward writes exp(block - lse) * w into the
    block's one gradient buffer, less w at the label on its owner.  No
    second tensor of the logits' size.  At one rank the combined lse is
    lse + log(1): one device's bits."""

    @staticmethod
    def forward(ctx, logits, labels, g, v0):
        flat = logits.reshape(-1, logits.shape[-1])
        every = tp.gather(g, _row_lse(flat)[None], 0)                # (ranks, rows)
        big = every.amax(dim=0)
        lse = big + torch.log(torch.exp(every - big).sum(dim=0))
        lab = labels.reshape(-1, 1).long() - v0
        inside = (lab >= 0) & (lab < flat.shape[1])
        lab = lab.clamp(0, flat.shape[1] - 1)
        gold = tp.reduce(g, torch.where(inside, torch.gather(flat, 1, lab), 0.0)[:, 0])
        ctx.save_for_backward(logits, lab, inside, lse)
        return torch.mean(lse - gold)

    @staticmethod
    def backward(ctx, g):
        logits, lab, inside, lse = ctx.saved_tensors
        w = g / lab.shape[0]
        return _xent_grad(logits, lab, lse, w, torch.where(inside[:, 0], w, 0.0)), \
            None, None, None


def loss_fn(model: LMModel, inputs: torch.Tensor, labels: torch.Tensor,
            remat: bool = False, unit: Unit = _no_unit) -> torch.Tensor:
    """Mean next-token cross-entropy of `labels` (B, S) under the logits
    (vocab-parallel where a tensor-parallel layout cuts the vocab)."""
    logits = forward_train(model, inputs, remat=remat, unit=unit)
    g = tp.group()
    with record_function("lm.xent"):
        if g is not None:
            v0, _, split = tp.split(model.cfg.vocab_size, g)
            if split:
                return _VocabCrossEntropy.apply(logits, labels, g, v0)
        return _MeanCrossEntropy.apply(logits, labels)


@torch.inference_mode()
def forward_prefill(model: LMModel, inputs: torch.Tensor, caches: Caches
                    ) -> Tuple[torch.Tensor, Caches]:
    """Fill the caches with the prompt; return last-position logits (B, 1, V).
    Under a layout (`sharding.hints`): the rank's blocks of the caches and
    of the logits, and the installed unit gathers fsdp-cut weights."""
    unit = hints.get_unit() or _no_unit
    with record_function("lm.prefill"):
        x = backbone(model, embed_inputs(model, inputs, unit), caches, unit=unit)
        return _logits(model, x[:, -1:, :], unit), caches


@torch.inference_mode()
def forward_decode(model: LMModel, token: torch.Tensor, caches: Caches, cache_pos: int
                   ) -> Tuple[torch.Tensor, Caches]:
    """One decode step.  token: (B, 1) integer (or (B, 1, F) features);
    cache_pos: the position it is written at."""
    unit = hints.get_unit() or _no_unit
    with record_function("lm.decode"):
        x = backbone(model, embed_inputs(model, token, unit), caches, int(cache_pos), unit=unit)
        return _logits(model, x, unit), caches
