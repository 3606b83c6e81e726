"""Shared pieces of the tensor-parallel training tests
(`tests/test_torch_lm_tp_train*.py`): the job each gloo rank runs, the
single-device step it is held against, and the collectives over the model
axis the design predicts.  No JAX here: the spawned ranks import this
module.  The comparisons and their tolerances are the FSDP step's
(`tests/test_torch_lm_mesh_gloo.py`)."""
import dataclasses
import math
from typing import Optional

import torch

from repro_torch import configs, convert
from repro_torch.checkpoint.manager import restore_pytree, save_pytree
from repro_torch.data.pipeline import make_batch
from repro_torch.launch import steps
from repro_torch.launch.distributed import held_bytes
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.runtime import failures
from repro_torch.sharding import rules
from test_torch_lm_mesh_gloo import B, DATA, OPT, S, STEPS, GradTap, float32_state, numpy_state

ARCHS = ["qwen2-0.5b", "deepseek-v2-lite-16b", "zamba2-7b"]

# Reduced configs whose head (and expert) counts a model axis of 4 does not
# divide: every rank computes every head (and expert) and uses the gathered
# weights alike.  deepseek's MLA then cuts c's rank r over the axis while
# the heads are whole on every rank.
VARIANTS = {
    "qwen2-0.5b/h2": ("qwen2-0.5b", dict(num_heads=2, num_kv_heads=1, head_dim=32)),
    "deepseek-v2-lite-16b/h2": ("deepseek-v2-lite-16b",
                                dict(num_heads=2, num_kv_heads=2, num_experts=6)),
}


def config(name):
    """The reduced config of an arch or of a `VARIANTS` name; MoE at
    capacity 8, where no assignment overflows."""
    arch, extra = VARIANTS.get(name, (name, {}))
    cfg = dataclasses.replace(configs.get(arch).reduced(), **extra)
    return dataclasses.replace(cfg, capacity_factor=8.0) if cfg.num_experts else cfg


@dataclasses.dataclass
class TPJob:
    """`steps` tensor-parallel steps (`make_train_step(mesh=,
    dp_over_model=False)`) from `first` on this rank's layout, in float32:
    per step the census, the gradients gathered whole and the whole state
    on rank 0's host.  restore_from: start from that directory's whole
    state, resharded by the tensor-parallel specs; save_to: save the final
    whole state there from rank 0's host."""
    name: str
    steps: int = STEPS
    first: int = 0
    restore_from: Optional[str] = None
    save_to: Optional[str] = None

    def run(self, layout, device) -> dict:
        cfg = config(self.name)
        _, whole = float32_state(cfg)
        if self.restore_from is not None:
            whole, _ = restore_pytree(whole, self.restore_from)
        counting = layout.counting()
        specs = steps.state_shardings(layout, cfg, OPT)
        state = failures.reshard(whole, counting,
                                 lambda path, leaf: rules.param_spec(layout, path, leaf))
        parts = (state.params, state.opt.mu, state.opt.nu, state.opt.master)
        out = dict(held=layout.world.gather_objects(held_bytes(parts)), steps=[])
        step_fn = steps.make_train_step(cfg, OPT, remat=True, mesh=counting)
        skeleton = M.LMModel(cfg, None, "meta")
        for i in range(self.first, self.first + self.steps):
            batch = steps.shard_batch(counting, make_batch(cfg, DATA, i, B, S, device))
            counting.reset_counts()
            with GradTap() as tap:
                state, metrics = step_fn(skeleton, state, batch)
            counts = counting.counts()
            grads = rules.unshard_tree(specs.params, tap.grads[0], group_of=counting.group)
            host = rules.gather_tree_to_host(specs, state, group_of=counting.group,
                                            coords=counting.coords)
            out["steps"].append(dict(counts=counts, grads={k: v.numpy() for k, v in grads.items()},
                                     state=None if host is None else numpy_state(host),
                                     **{k: float(v) for k, v in metrics.items()}))
        if host is not None and self.save_to is not None:
            save_pytree(host, self.save_to, self.first + self.steps)
        return out


@dataclasses.dataclass
class RoundTripJob:
    """A bf16 whole state as numpy (a checkpoint's host tree) resharded onto
    the layout by the tensor-parallel specs (blocks cut two ways) and
    brought back to rank 0's host."""
    arch: str

    def run(self, layout, device) -> dict:
        L.ACT_DTYPE = torch.bfloat16
        cfg = configs.get(self.arch).reduced()
        whole = steps.init_train_state(M.init_params(cfg, 1, "cpu"), OPT)
        host = steps.TrainState(
            params={k: convert._to_numpy(v) for k, v in whole.params.items()},
            opt=adamw.OptState(*({k: convert._to_numpy(v) for k, v in t.items()}
                                 for t in whole.opt[:3]), convert._to_numpy(whole.opt.count)),
            step=convert._to_numpy(whole.step))
        specs = steps.state_shardings(layout, cfg, OPT)
        placed = failures.reshard(host, layout,
                                  lambda path, leaf: rules.param_spec(layout, path, leaf))
        held = held_bytes((placed.params, placed.opt.mu, placed.opt.nu, placed.opt.master))
        back = rules.gather_tree_to_host(specs, placed, group_of=layout.group,
                                        coords=layout.coords)
        same = None
        if back is not None:
            pairs = [(whole.params, back.params)] + list(zip(whole.opt[:3], back.opt[:3]))
            same = all(torch.equal(a[k].detach().reshape(-1).view(torch.uint8),
                                   b[k].reshape(-1).view(torch.uint8))
                       for a, b in pairs for k in a)
            same = same and int(back.opt.count) == 0 and int(back.step) == 0
        two_cut = sum(sum(e is not None for e in s) == 2 for s in specs.params.values())
        return dict(held=layout.world.gather_objects(held), same=same, two_cut=two_cut)


def single_device(name, i, start=None):
    """Step `i` of the single-device float32 step from `start` (a whole state
    as `numpy_state` gives it; None: the fresh one): the metrics, the
    gradients and the state after it."""
    cfg = config(name)
    model, state = float32_state(cfg)
    if start is not None:
        # copies: the step writes mu, nu and master in place
        t = {part: {k: torch.tensor(v) for k, v in tree.items()}
             for part, tree in start.items()}
        count = torch.tensor(i, dtype=torch.int32)
        state = steps.bind(model, steps.TrainState(
            t["params"], adamw.OptState(t["mu"], t["nu"], t["master"], count), count))
    with GradTap() as tap:
        state, metrics = steps.make_train_step(cfg, OPT, remat=True)(
            model, state, make_batch(cfg, DATA, i, B, S, "cpu"))
    return dict(grads={k: v.numpy() for k, v in tap.grads[0].items()},
                state=numpy_state(state), **{k: float(v) for k, v in metrics.items()})


def refs_of(name, res):
    """The single-device step from the state each of the layout's steps
    started from (the fresh one, then the layout's own)."""
    starts = [None] + [s["state"] for s in res["steps"][:-1]]
    return [single_device(name, i, start) for i, start in enumerate(starts)]


def held_state(cfg, sizes, rank) -> int:
    """Bytes of a rank's float32 blocks of params, mu, nu and master."""
    from repro_torch.launch import mesh
    lay = mesh.shape_layout(sizes, rank)
    return sum(4 * 4 * math.prod(rules.block_shape(rules.param_spec(lay, (k,), v), v.shape, lay))
               for k, v in steps.abstract_params(cfg).items())


# ---------------------------------------------------------------------------
# The collectives over the model axis one step makes, from the shapes
# ---------------------------------------------------------------------------

class Count:
    """Calls a step makes over the model axis: in the forward (`gather`,
    `reduce`, run again in remat's recomputation where they sit in a layer)
    and in the backward (`grad_sum`, the sums of partial gradients, and
    `scatter_sum`, the reduce-scatters of gathers used for the rank's own
    part)."""

    def __init__(self, m: int):
        self.m = m
        self.gather = self.reduce = self.grad_sum = self.scatter_sum = 0

    def held(self, n: int) -> bool:
        """A dim of n entries is held as blocks other than the whole."""
        return self.m > 1 and n % self.m == 0

    def take(self, n: int, own: bool, part: bool, whole: bool = False) -> None:
        """`tp.take` of a leaf whose dim has n entries; own: the entries are
        the rank's aligned block of them; whole: the specs never cut the
        leaf (norm scales, conv_b)."""
        held = self.held(n) and not whole
        if held and own:
            return
        if held:
            self.gather += 1
            self.scatter_sum += part
        else:
            self.grad_sum += part

    def column(self, part: bool) -> None:
        self.grad_sum += part


def _gqa(c: Count, cfg) -> None:
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    split = h % c.m == 0
    kv_split = split and kv % c.m == 0
    for _ in range(1 + cfg.qkv_bias):                     # wq (bq)
        c.take(h * hd, split, split)
    for _ in range(2 + 2 * cfg.qkv_bias):                 # wk, wv (bk, bv)
        c.take(kv * hd, kv_split, split)
    for _ in range(3):
        c.column(split)
    for _ in range(2 * cfg.qk_norm):                      # q_norm, k_norm
        c.take(hd, False, split, whole=True)
    c.take(h * hd, split, split)                          # wo's rows
    c.reduce += split


def _mla(c: Count, cfg) -> None:
    h, r, rd, nq = cfg.num_heads, cfg.kv_lora_rank, cfg.rope_head_dim, 128 + cfg.rope_head_dim
    split = h % c.m == 0
    c.take(h * nq, split, split)                          # wq
    c.column(split)
    if not c.held(r):
        c.take(r, False, split)                           # w_dkv whole
    c.column(split or c.held(r))
    if c.held(r):                                         # c's blocks of r
        c.gather += 1
        c.scatter_sum += split
    c.take(r, False, split, whole=True)                   # c_norm
    c.take(rd, False, split)                              # w_kr
    c.column(split)
    c.take(h, split, split)                               # w_uk
    c.take(h, split, split)                               # w_uv
    c.take(h * 128, split, split)                         # wo's rows
    c.reduce += split


def _mlp(c: Count, width: int) -> None:
    split = width % c.m == 0
    for _ in range(2):                                    # wg, wi
        c.take(width, split, split)
        c.column(split)
    c.take(width, split, split)                           # wo's rows
    c.reduce += split


def _moe(c: Count, cfg) -> None:
    split = cfg.num_experts % c.m == 0
    c.grad_sum += split                                   # the buffer's input
    for _ in range(3):
        c.take(cfg.num_experts, split, split)
    c.gather += split                                     # every expert's outputs


def _mamba(c: Count, cfg) -> None:
    d_inner = cfg.ssm_expand * cfg.d_model
    heads, n = d_inner // cfg.ssm_head_dim, cfg.ssm_state
    split = heads % c.m == 0
    c.take(2 * d_inner + 2 * n + heads, False, split)     # in_proj across z | xBC | dt
    c.column(split)
    for _ in range(3):                                    # dt_bias, a_log, d_skip
        c.take(heads, split, split)
    c.take(d_inner + 2 * n, False, split)                 # conv_w
    c.take(d_inner + 2 * n, False, split, whole=True)     # conv_b
    c.reduce += split                                     # the gated norm's squares
    c.grad_sum += split
    c.take(d_inner, split, split, whole=True)             # norm.scale
    c.take(d_inner, split, split)                         # out_proj's rows
    c.reduce += split


def layer_counts(cfg, m: int, kind: str) -> Count:
    c = Count(m)
    if kind == "mamba":
        _mamba(c, cfg)
        return c
    (_mla if cfg.use_mla else _gqa)(c, cfg)
    if kind == "moe":
        _moe(c, cfg)                  # the shared experts are whole over model: no collective
    else:
        _mlp(c, cfg.d_ff)
    return c


def predicted(cfg, sizes, remat: bool = True) -> dict:
    """Calls of each collective over the model axis in one tensor-parallel
    train step at `sizes` (data, model), from the config's shapes: the
    layers' forward collectives twice under remat, their backward sums
    once; the embedding's sum, the unembedding's input sum and the
    cross-entropy's gather and sum once."""
    from _torch_lm_tp import layer_kinds
    m = sizes[-1]
    out = dict(gather=0, reduce=0, grad_sum=0, scatter_sum=0)
    for kind in layer_kinds(cfg):
        c = layer_counts(cfg, m, kind)
        out["gather"] += (1 + remat) * c.gather
        out["reduce"] += (1 + remat) * c.reduce
        out["grad_sum"] += c.grad_sum
        out["scatter_sum"] += c.scatter_sum
    v, c = cfg.vocab_size, Count(m)
    split_v = v % m == 0
    if cfg.family == "audio":
        c.take(cfg.d_model, False, False)                 # the frontend's columns
    else:
        c.take(v, split_v, split_v)                       # embed_split's rows
        c.reduce += split_v
    c.take(v, split_v, split_v)                           # the unembedding's rows
    c.column(split_v)                                     # its input
    c.gather += split_v                                   # the cross-entropy's lse
    c.reduce += split_v                                   # and its gold logit
    for k in out:
        out[k] += getattr(c, k)
    return out
