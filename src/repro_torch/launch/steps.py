"""Train / prefill / decode step factories and the LM layout's shardings
(port of `repro.launch.steps`).

`input_specs` gives each model input of a shape cell as a shape and a dtype;
`make_train_step` returns the function a trainer calls, `make_prefill_step`
and `make_decode_step` the ones a server calls (under inference mode).

A `TrainState`'s params are the model's own parameters (`init_train_state`,
`bind`), and a train step updates them and the optimizer state in place
(`optim.adamw`); `clone_state` copies a state to keep it.

Over a layout (`launch.mesh.make_host_mesh`): the `abstract_*` trees are
meta-device tensors (shapes and dtypes, no storage), and the `*_shardings`
are spec trees (`sharding.rules`), as the reference's are
`NamedSharding` trees.  `make_train_step(mesh=)` is the FSDP (ZeRO-3)
step over the fsdp axes: each rank holds its blocks of params, mu, nu and
master (`shard_state`, `runtime.failures.reshard`), gathers each unit's
weights just before the unit runs (again in a remat unit's
recomputation) and drops them after, reduce-scatters each unit's
gradients in the gather's backward, reduces what the spec leaves whole
over the other axes, and runs AdamW on its blocks.  With
`dp_over_model=True` the model axis carries batch blocks and the layers
run their single-device code; with `dp_over_model=False` (the reference's
tensor-parallel posture, at any model-axis size) the weights stay in
`rules.param_spec`'s blocks, cut over the fsdp axes on one dim and over
the model axis on another, the batch is whole over model, and the layers
compute the rank's blocks (`models.tp`), whose collectives carry their
conjugates in the backward.

`make_prefill_step(cfg, mesh=)` and `make_decode_step(cfg, mesh=)` serve
over a layout, as the reference's do: each rank holds its blocks of the
weights as `param_shardings(mesh, cfg, serve=True)` places them
(`shard_params`: tensor parallel over the model axis and whole over the
fsdp axes, or, where the weights whole over fsdp exceed the budget, the
training specs, whose fsdp blocks each unit gathers while it runs), its
blocks of the caches (`make_cache`: batch over fsdp, sequence, SSM heads
or conv channels over model) and of the batch (`shard_batch`), and
returns its block of the logits (`logits_shardings`: vocab over model;
`gather_logits` puts them together).  The steps install the layout in
`sharding.hints` while they run; the layers compute their blocks
(`models.tp`).
"""
from __future__ import annotations

import contextlib
import math
import weakref
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.profiler import record_function

from repro_torch.models import model as M
from repro_torch.models import tp
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.optim import adamw
from repro_torch.sharding import hints, rules

META = torch.device("meta")


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]   # name -> the model's parameter
    opt: adamw.OptState
    step: torch.Tensor                # 0-d int32


class Spec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Spec]:
    """Shape and dtype of every model input of this cell."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":    # one new token against a seq_len cache
        return {"token": Spec((b, 1), torch.int32), "cache_pos": Spec((), torch.int32)}
    if cfg.family == "audio":
        specs = {"inputs": Spec((b, s, cfg.frontend_dim), torch.float32)}
    else:
        specs = {"inputs": Spec((b, s), torch.int32)}
    if shape.kind == "train":
        specs["labels"] = Spec((b, s), torch.int32)
    return specs


def init_train_state(model: M.LMModel, opt_cfg: adamw.OptConfig) -> TrainState:
    params = dict(model.named_parameters())
    dev = next(iter(params.values())).device
    return TrainState(params=params, opt=adamw.init(params, opt_cfg),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def clone_state(state: TrainState) -> TrainState:
    """Every tensor of the state copied (the params as plain tensors; `bind`
    puts them back into a model)."""
    copy = lambda tree: None if tree is None else {k: v.detach().clone()
                                                   for k, v in tree.items()}
    o = state.opt
    return TrainState(params=copy(state.params),
                      opt=adamw.OptState(copy(o.mu), copy(o.nu), copy(o.master),
                                         o.count.clone()),
                      step=state.step.clone())


@torch.no_grad()
def bind(model: M.LMModel, state: TrainState) -> TrainState:
    """`state` with its params copied into `model`'s parameters (a restored
    or cloned state), and its params now those parameters."""
    params = dict(model.named_parameters())
    if set(params) != set(state.params):
        raise KeyError(f"bind: {sorted(set(params) ^ set(state.params))} not in both")
    for k, p in params.items():
        if state.params[k] is not p:
            p.copy_(state.params[k])
    return state._replace(params=params)


# ---------------------------------------------------------------------------
# Abstract trees and the layout's spec trees
# ---------------------------------------------------------------------------

def abstract_params(cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Every parameter by name, as a meta tensor (no storage)."""
    return dict(M.LMModel(cfg, None, META).named_parameters())


def abstract_train_state(cfg: ModelConfig, opt_cfg: adamw.OptConfig) -> TrainState:
    return init_train_state(M.LMModel(cfg, None, META), opt_cfg)


def abstract_caches(cfg: ModelConfig, batch: int, max_seq: int) -> M.Caches:
    return M.make_cache(cfg, batch, max_seq, META)


def use_dp_over_model(cfg: ModelConfig, mesh, batch: int,
                      hbm_budget_bytes: float = 10e9) -> bool:
    """True when training should run pure DP (the model axis carries batch
    blocks): the train state (bf16 params + float32 mu, nu, master = 14 B a
    parameter) fits a rank at fsdp-only ZeRO sharding, and the global batch
    divides the whole layout."""
    if batch % math.prod(mesh.shape.values()):
        return False
    n = sum(p.numel() for p in abstract_params(cfg).values())
    fsdp = math.prod(mesh.shape[a] for a in rules.fsdp_axes(mesh))
    return n * 14.0 / fsdp <= hbm_budget_bytes


def state_shardings(mesh, cfg: ModelConfig, opt_cfg: adamw.OptConfig,
                    dp_over_model: bool = False) -> TrainState:
    spec_fn = rules.param_spec_dp if dp_over_model else rules.param_spec
    return rules.tree_specs(mesh, abstract_train_state(cfg, opt_cfg), spec_fn)


def param_shardings(mesh, cfg: ModelConfig, serve: bool = False,
                    hbm_budget_bytes: float = 10e9) -> Dict[str, tuple]:
    """Training: ZeRO/FSDP specs.  Serving (serve=True): tensor-parallel-only
    specs when the weights, whole over the fsdp axes, fit
    `hbm_budget_bytes` a rank; otherwise the training specs (llama4-400b)."""
    params = abstract_params(cfg)
    if serve:
        total = sum(p.numel() * 2 for p in params.values())
        if total / mesh.shape.get(rules.MODEL, 1) <= hbm_budget_bytes:
            return rules.tree_specs(mesh, params, rules.param_spec_serve)
    return rules.tree_specs(mesh, params, rules.param_spec)


def cache_shardings(mesh, cfg: ModelConfig, batch: int, max_seq: int):
    return rules.tree_specs(mesh, abstract_caches(cfg, batch, max_seq), rules.cache_spec)


def logits_shardings(mesh, cfg: ModelConfig, batch: int) -> tuple:
    """(B, 1, V) decode logits: batch over fsdp, vocab over model."""
    return logits_spec(mesh, (batch, 1, cfg.vocab_size))


def logits_spec(mesh, shape) -> tuple:
    """The spec of logits of whole `shape` (B, ..., V): batch over fsdp,
    vocab over model (`hints.hint_logits`'s layout)."""
    b_axes = rules.batch_spec(mesh, shape[0])[0]
    return rules._spec(mesh, shape, (b_axes,) + (None,) * (len(shape) - 2) + (rules.MODEL,))


def batch_shardings(mesh, specs: Dict[str, Spec], include_model: bool = False
                    ) -> Dict[str, tuple]:
    """The spec of each input (anything with a shape).  include_model: the
    DP-over-model posture's batch, over every axis it divides (where the
    reference's activation anchors put it)."""
    return {k: () if len(v.shape) == 0 else rules.data_spec(mesh, v.shape, include_model)
            for k, v in specs.items()}


def shard_batch(mesh, batch: Dict[str, torch.Tensor], dp_over_model: bool = False
                ) -> Dict[str, torch.Tensor]:
    """This rank's block of a global batch, on the layout's device."""
    specs = batch_shardings(mesh, batch, dp_over_model)
    return {k: rules.shard_leaf(specs[k], v, mesh.coords).to(mesh.device)
            for k, v in batch.items()}


def shard_state(mesh, state: TrainState, dp_over_model: bool = False) -> TrainState:
    """This rank's blocks of a whole train state, each a tensor of its own on
    the layout's device (`runtime.failures.reshard`)."""
    from repro_torch.runtime.failures import reshard
    spec_fn = rules.param_spec_dp if dp_over_model else rules.param_spec
    return reshard(state, mesh, lambda path, leaf: spec_fn(mesh, path, leaf))


def state_bytes_per_rank(mesh, cfg: ModelConfig, opt_cfg: adamw.OptConfig,
                         dp_over_model: bool = False) -> int:
    """Bytes of one rank's blocks of params, mu, nu and master, by the specs."""
    st = abstract_train_state(cfg, opt_cfg)
    specs = state_shardings(mesh, cfg, opt_cfg, dp_over_model)
    total = 0
    for tree, tspecs in ((st.params, specs.params), (st.opt.mu, specs.opt.mu),
                         (st.opt.nu, specs.opt.nu), (st.opt.master, specs.opt.master)):
        for k, x in (tree or {}).items():
            total += math.prod(rules.block_shape(tspecs[k], x.shape, mesh)) * x.element_size()
    return total


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.OptConfig, remat: bool = True,
                    mesh=None, dp_over_model: bool = False):
    """train_step(model, state, batch) -> (state, metrics): the loss and its
    gradients, one AdamW update; metrics `loss`, `grad_norm` and `lr` at the
    new count, as the reference's (0-d tensors on the device).

    mesh: an `LMGroups` layout.  Then the step is this rank's part of the
    FSDP step (`_FSDPStep`) in the posture `dp_over_model` names (True: the
    model axis carries batch blocks; False: tensor parallel over it):
    `state` holds the rank's blocks as `state_shardings(mesh, cfg, opt_cfg,
    dp_over_model)` places them, `batch` is the rank's block of the global
    batch (`shard_batch(mesh, batch, dp_over_model)`; under the
    tensor-parallel posture the global batch must divide the fsdp axes),
    and `model` is a model of `cfg` whose parameters the step does not
    read (a meta-device one, `M.LMModel(cfg, None, "meta")`): each unit's
    gathered weights are put in it while the unit runs."""
    if mesh is not None:
        return _FSDPStep(cfg, opt_cfg, remat, mesh, dp_over_model)

    def train_step(model: M.LMModel, state: TrainState, batch) -> Tuple[TrainState, Dict]:
        with record_function("lm.train_step"):
            names = list(state.params)
            with record_function("lm.loss"):
                loss = M.loss_fn(model, batch["inputs"], batch["labels"], remat=remat)
            with record_function("lm.backward"):
                grads = dict(zip(names, torch.autograd.grad(
                    loss, [state.params[k] for k in names])))
            with record_function("lm.optim"):
                params, opt = adamw.update(grads, state.opt, state.params, opt_cfg)
                metrics = {"loss": loss.detach(), "grad_norm": adamw.global_norm(grads),
                           "lr": adamw.schedule(opt_cfg, opt.count)}
            return TrainState(params=params, opt=opt, step=state.step + 1), metrics
    return train_step


def make_prefill_step(cfg: ModelConfig, mesh=None):
    """prefill_step(model, caches, batch) -> (logits (B, 1, V), caches).
    mesh: an `LMGroups` layout; then `model` holds the rank's blocks
    (`shard_params`), `caches` its blocks (`make_cache`), `batch` its rows
    (`shard_batch`), and the logits are its block (`logits_shardings`)."""
    serving = _Serving(cfg, mesh)
    if cfg.is_encoder:
        # Encoder-only archs have no decode, hence no cache: "prefill" is the
        # full bidirectional forward (the serving operation for hubert).
        @torch.inference_mode()
        def encode_step(params, batch):
            with serving(params) as unit:
                return M.forward_train(params, batch["inputs"], unit=unit)
        return encode_step

    @torch.inference_mode()
    def prefill_step(params, caches, batch):
        with serving(params):
            return M.forward_prefill(params, batch["inputs"], caches)
    return prefill_step


def make_decode_step(cfg: ModelConfig, mesh=None):
    """serve_step(model, caches, batch) -> (logits (B, 1, V), caches); mesh
    as `make_prefill_step`."""
    serving = _Serving(cfg, mesh)

    @torch.inference_mode()
    def serve_step(params, caches, batch):
        with serving(params):
            return M.forward_decode(params, batch["token"], caches, batch["cache_pos"])
    return serve_step


# ---------------------------------------------------------------------------
# Serving over a layout
# ---------------------------------------------------------------------------

def _slots(model: M.LMModel) -> Dict[str, Tuple[torch.nn.Module, str]]:
    """Each parameter's name -> (its module, its attribute)."""
    out = {}
    for prefix, m in model.named_modules():
        for attr in m._parameters:
            out[f"{prefix}.{attr}" if prefix else attr] = (m, attr)
    return out


def shard_params(mesh, cfg: ModelConfig, model: M.LMModel, hbm_budget_bytes: float = 10e9
                 ) -> M.LMModel:
    """A model of `cfg` holding this rank's blocks of `model`'s weights as
    `param_shardings(mesh, cfg, serve=True, hbm_budget_bytes)` places them,
    on the layout's device: a block smaller than its leaf is a tensor of its
    own (the whole leaf can be dropped), a whole one is the leaf itself (no
    copy: a one-rank layout holds the model it was given)."""
    specs = param_shardings(mesh, cfg, serve=True, hbm_budget_bytes=hbm_budget_bytes)
    out = M.LMModel(cfg, None, META)
    slots = _slots(out)
    for name, p in model.named_parameters():
        blk = rules.shard_leaf(specs[name], p.detach(), mesh.coords)
        if blk.numel() < p.numel():
            blk = blk.clone()
        mod, attr = slots[name]
        mod._parameters[attr] = torch.nn.Parameter(blk.to(mesh.device), requires_grad=False)
    return out


def make_cache(mesh, cfg: ModelConfig, batch: int, max_seq: int) -> M.Caches:
    """This rank's blocks of the decode caches of `batch` rows and `max_seq`
    positions, as `cache_shardings` places them, allocated directly (zeros on
    the layout's device; no whole cache is made)."""
    abstract = abstract_caches(cfg, batch, max_seq)
    specs = cache_shardings(mesh, cfg, batch, max_seq)
    return {grp: [tp.CacheBlock(
        {k: torch.zeros(rules.block_shape(specs[grp][i][k], v.shape, mesh), dtype=v.dtype,
                        device=mesh.device) for k, v in layer.items()},
        {k: tuple(v.shape) for k, v in layer.items()}) for i, layer in enumerate(layers)]
        for grp, layers in abstract.items()}


def gather_logits(mesh, cfg: ModelConfig, logits: torch.Tensor, batch: int) -> torch.Tensor:
    """The whole logits of a global batch of `batch` rows on every rank, from
    every rank's block (collective)."""
    shape = (batch,) + tuple(logits.shape[1:-1]) + (cfg.vocab_size,)
    return rules.unshard_leaf(logits_spec(mesh, shape), logits, mesh.group)


class _Serving:
    """What a serving step installs while it runs: the layout in
    `sharding.hints` and, for a model held in the training specs' blocks,
    the unit that gathers each unit's fsdp-cut weights (under inference
    mode: no backward).  Each block's posture is read from its shape."""

    def __init__(self, cfg: ModelConfig, mesh):
        self.cfg, self.mesh = cfg, mesh
        self.units = weakref.WeakKeyDictionary()

    def _unit(self, model: M.LMModel):
        mesh, whole = self.mesh, abstract_params(self.cfg)
        serve = rules.tree_specs(mesh, whole, rules.param_spec_serve)
        train = rules.tree_specs(mesh, whole, rules.param_spec)
        cut = {}
        for name, p in model.named_parameters():
            w = whole[name]
            if tuple(p.shape) == rules.block_shape(serve[name], w.shape, mesh):
                continue
            if tuple(p.shape) != rules.block_shape(train[name], w.shape, mesh):
                raise ValueError(f"{name}: {tuple(p.shape)} is a block of neither posture of "
                                 f"param_shardings(serve=True) on {mesh.shape}")
            cut[name] = _leaf_plan(mesh, name, w)
        if not cut:
            return None
        return _gathering_unit(mesh, cut, model, dict(model.named_parameters()), _slots(model))

    @contextlib.contextmanager
    def __call__(self, model: M.LMModel):
        unit = None
        if self.mesh is not None:
            if model not in self.units:
                self.units[model] = self._unit(model)
            unit = self.units[model]
        with hints.layout(self.mesh, unit=unit):
            yield unit or M._no_unit


# ---------------------------------------------------------------------------
# The FSDP train step over a layout's fsdp axes
# ---------------------------------------------------------------------------

class _Leaf(NamedTuple):
    """How the FSDP step holds one parameter."""
    dim: Optional[int]            # the dim cut over `axes` (None: whole over them)
    axes: Tuple[str, ...]         # the fsdp axes that cut it (gathered per unit)
    rest: Tuple[str, ...]         # the axes its gradient is summed over
    copies: Tuple[str, ...] = ()  # the axes whose ranks hold copies of its block
    model_dim: Optional[int] = None   # the dim cut over the model axis (a TP block)


def _leaf_plan(mesh, name: str, leaf: torch.Tensor, tensor_parallel: bool = False) -> _Leaf:
    """The DP posture (`rules.param_spec_dp`): one dim cut over the fsdp
    axes, the gradient summed over every other axis (the model axis carries
    batch blocks).  The tensor-parallel posture (`rules.param_spec`): a dim
    cut over the fsdp axes and another over the model axis, left as the
    rank's block for the layers (`models.tp.take`); the gradient summed
    over the fsdp axes that do not cut it, never over the model axis (the
    layers' backward sums over it where a rank's gradient is a partial)."""
    spec = (rules.param_spec if tensor_parallel else rules.param_spec_dp)(mesh, (name,), leaf)
    cuts = [(d, rules.entry_axes(e)) for d, e in enumerate(spec) if e is not None]
    model = [d for d, axes in cuts if rules.MODEL in axes]
    fsdp = [(d, axes) for d, axes in cuts if rules.MODEL not in axes]
    if len(fsdp) > 1 or len(model) > 1 or any(
            axes != (rules.MODEL,) for _, axes in cuts if rules.MODEL in axes):
        raise ValueError(f"{name}: a spec cuts one dim over the fsdp axes and one over the "
                         f"model axis, not {spec}")
    dim, axes = fsdp[0] if fsdp else (None, ())
    cut = set(axes) | ({rules.MODEL} if model else set())
    copies = tuple(a for a in mesh.axes if a not in cut)
    rest = tuple(a for a in copies if not (tensor_parallel and a == rules.MODEL))
    return _Leaf(dim, axes, rest, copies, model[0] if model else None)


class _GatherUnit(torch.autograd.Function):
    """One unit's weights whole from every rank's blocks: one gather of the
    blocks packed as bytes (widest dtype first, so every block stays
    aligned).  The backward reduce-scatters the gradients, one collective
    per dtype: each rank gets the sum over the group of its block.  Ranges
    `lm.gather` and `lm.scatter` hold the packing, the collective and the
    unpacking of each."""

    @staticmethod
    def forward(ctx, group, dims, *blocks):
        ctx.group, ctx.dims = group, dims
        ctx.blocks = [(b.dtype, b.shape) for b in blocks]
        with record_function("lm.gather"):
            parts = [b.detach().contiguous().view(-1).view(torch.uint8) for b in blocks]
            n = sum(p.numel() for p in parts)
            parts.append(parts[0].new_zeros(-n % 8))        # each rank's row stays 8-aligned
            rows = group.gather(torch.cat(parts)).view(group.size, -1)
            out, off = [], 0
            for dim, b in zip(dims, blocks):
                nb = b.numel() * b.element_size()
                got = rows[:, off:off + nb].view(b.dtype).reshape((group.size,) + tuple(b.shape))
                out.append(torch.cat(got.unbind(0), dim=dim))
                off += nb
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        group, size = ctx.group, ctx.group.size
        out: List[Optional[torch.Tensor]] = [None] * len(grads)
        with record_function("lm.scatter"):
            for dtype in dict.fromkeys(dt for dt, _ in ctx.blocks):
                idx = [i for i, (dt, _) in enumerate(ctx.blocks) if dt == dtype]
                rows = [grads[i].unflatten(ctx.dims[i], (size, -1)).movedim(ctx.dims[i], 0)
                        .reshape(size, -1) for i in idx]
                summed = group.scatter_sum(torch.cat(rows, 1))
                for i, part in zip(idx, summed.split([r.shape[1] for r in rows])):
                    out[i] = part.view(ctx.blocks[i][1])
        return (None, None, *out)


def _gathering_unit(mesh, plan: Dict[str, _Leaf], model: M.LMModel,
                    blocks: Dict[str, torch.Tensor], slots):
    """The `unit` context of `models.model` for `blocks`: entering a unit
    gathers the whole weights of its modules' leaves that `plan` cuts, in
    one collective per group of axes (`_GatherUnit`), and puts them in the
    model while the unit runs."""
    names = {id(m): [n for n, _ in m.named_parameters(prefix=prefix)]
             for prefix, m in model.named_modules()}

    @contextlib.contextmanager
    def unit(*modules):
        groups: Dict[Tuple[str, ...], List[str]] = {}
        for m in modules:
            for n in names[id(m)]:
                if n in plan and plan[n].dim is not None:
                    groups.setdefault(plan[n].axes, []).append(n)
        whole = {}
        for axes, ns in groups.items():
            ns = sorted(ns, key=lambda n: -blocks[n].element_size())
            outs = _GatherUnit.apply(mesh.group(axes), tuple(plan[n].dim for n in ns),
                                     *(blocks[n] for n in ns))
            whole.update(zip(ns, outs))
        with _bound(slots, whole):
            yield
    return unit


@contextlib.contextmanager
def _bound(slots: Dict[str, Tuple[torch.nn.Module, str]], tensors: Dict[str, torch.Tensor]):
    """The model's parameters named in `tensors` replaced by them while the
    block runs (a meta-device model's placeholders put back after)."""
    saved = {k: slots[k][0]._parameters[slots[k][1]] for k in tensors}
    try:
        for k, t in tensors.items():
            slots[k][0]._parameters[slots[k][1]] = t
        yield
    finally:
        for k, p in saved.items():
            slots[k][0]._parameters[slots[k][1]] = p


class _FSDPStep:
    """`make_train_step(mesh=)`: this rank's part of the FSDP train step, in
    one of the reference's two postures.

    * Units (`models.model`): entering one gathers the whole weights of its
      leaves' fsdp blocks in one collective over their axes' group
      (`_GatherUnit`) and puts them in the model; leaving drops them.
      Under remat the recomputation gathers again.
    * DP over model (dp_over_model=True, `rules.param_spec_dp`): the batch
      is cut over every axis, the weights over the fsdp axes only; the
      layers run their single-device code on the gathered weights, and
      each rank backpropagates its local mean loss weighted by 1 / world.
    * Tensor parallel (dp_over_model=False, `rules.param_spec`, at any size
      of the model axis): the batch is cut over the fsdp axes and is whole
      over model; a leaf may be cut over the fsdp axes on one dim and over
      model on another, and the gathered weights are the rank's model
      blocks, which the layers compute with (`models.tp`, installed by
      `hints.layout`).  Every model rank computes the same loss, weighted
      by 1 / (the number of batch blocks, the fsdp axes' product), and the
      backward of the layers' collectives leaves on every rank the whole
      gradient of the part of each leaf it holds: a leaf whole over model
      but used by each rank for its own part (wk and wv where model
      divides the query heads but not the KV heads, the in_proj entries a
      rank narrows, the norms of its heads) is summed over model in
      `models.tp.take`'s backward.  The step never sums over model.
    * Gradients: a cut leaf's is reduce-scattered over its fsdp axes by the
      gather's backward, then every leaf's is summed over `_Leaf.rest`
      (one merge per group and dtype): the axes that hold copies of it,
      less model in the tensor-parallel posture.
    * The optimizer runs on the blocks.  The global norm: each leaf's local
      sum of squares, counted only on the ranks at coordinate 0 of every
      axis that holds copies of its block (a leaf cut over model on every
      model rank, a leaf whole over it on model rank 0), one merge over the
      world of the vector of those sums (and the local loss, counted once
      per batch block), then the sum in the reference's leaf order
      (`adamw.norm_of`): at one rank, the single-device step's bits."""

    def __init__(self, cfg: ModelConfig, opt_cfg: adamw.OptConfig, remat: bool, mesh,
                 dp_over_model: bool):
        self.cfg, self.opt_cfg, self.remat, self.mesh = cfg, opt_cfg, remat, mesh
        self.tp = not dp_over_model
        self.plan = {k: _leaf_plan(mesh, k, p, self.tp) for k, p in abstract_params(cfg).items()}
        self.order = adamw.leaf_order(self.plan)
        self.counted = {k: not any(mesh.coords[a][0] for a in lf.copies)
                        for k, lf in self.plan.items()}
        # the batch blocks: every rank's under DP, the fsdp axes' under TP
        self.blocks = math.prod(mesh.shape[a] for a in rules.fsdp_axes(mesh)) if self.tp \
            else mesh.size
        self.loss_counted = not (self.tp and mesh.coords.get(rules.MODEL, (0, 1))[0])

    def _sum_rest(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Every leaf's gradient summed over its `rest` axes: one merge per
        (group, dtype)."""
        buckets: Dict[tuple, List[str]] = {}
        for k in self.order:
            buckets.setdefault((self.plan[k].rest, grads[k].dtype), []).append(k)
        out = dict(grads)
        for (rest, _), ks in buckets.items():
            group = self.mesh.group(rest)
            if group is None:
                continue
            summed = group.merge(torch.cat([grads[k].reshape(-1) for k in ks]))
            for k, part in zip(ks, summed.split([grads[k].numel() for k in ks])):
                out[k] = part.view(grads[k].shape)
        return out

    def __call__(self, model: M.LMModel, state: TrainState, batch) -> Tuple[TrainState, Dict]:
        mesh = self.mesh
        with record_function("lm.train_step"):
            blocks = state.params
            for p in blocks.values():
                p.requires_grad_(True)
            slots = _slots(model)
            unit = _gathering_unit(mesh, self.plan, model, blocks, slots)
            whole = {k: blocks[k] for k, lf in self.plan.items() if lf.dim is None}
            names = list(blocks)
            # DP: the anchors are the identity and the layers run their
            # single-device code on the gathered weights.  TP: the layers
            # compute the rank's blocks over the model group.
            posture = hints.layout(mesh, dp_over_model=True) if not self.tp else \
                hints.layout(mesh, dp_over_model=False, unit=unit)
            with posture, _bound(slots, whole):
                with record_function("lm.loss"):
                    local = M.loss_fn(model, batch["inputs"], batch["labels"],
                                      remat=self.remat, unit=unit)
                with record_function("lm.backward"):
                    weight = torch.full((), 1.0 / self.blocks, dtype=local.dtype,
                                        device=local.device)
                    grads = dict(zip(names, torch.autograd.grad(
                        local, [blocks[k] for k in names], weight)))
            with record_function("lm.reduce"):
                grads = self._sum_rest(grads)
                sums = adamw.square_sums({k: grads[k] for k in self.order if self.counted[k]})
                zero = torch.zeros((), dtype=torch.float32, device=local.device)
                total = mesh.world.merge(torch.stack(
                    [local.detach() if self.loss_counted else zero]
                    + [sums.get(k, zero) for k in self.order]))
                loss = total[0] / self.blocks
                gnorm = adamw.norm_of(dict(zip(self.order, total[1:])))
            with record_function("lm.optim"):
                params, opt = adamw.update(grads, state.opt, blocks, self.opt_cfg, gnorm=gnorm)
                metrics = {"loss": loss, "grad_norm": gnorm,
                           "lr": adamw.schedule(self.opt_cfg, opt.count)}
            return TrainState(params=params, opt=opt, step=state.step + 1), metrics
