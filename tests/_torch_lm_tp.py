"""Shared pieces of the serving-over-a-layout tests (`tests/test_torch_lm_tp*.py`):
the job each gloo rank runs, the single-device reference it is held
against, the collectives the design predicts, and the comparison.  No JAX
here: the spawned ranks import this module."""
import dataclasses
import math

import numpy as np
import torch

from repro_torch import configs
from repro_torch.launch import dryrun, lm_serve, mesh, steps
from repro_torch.launch.distributed import held_bytes
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.config import ShapeConfig
from repro_torch.sharding import rules

ARCHS = sorted(configs.ARCHS)
TOL = 1e-5                  # of each leaf's largest magnitude (float32 sums in another order)
PROMPT, DECODES = 9, 6      # a prefill of 9 tokens, then 6 decode steps (positions 9..14)


@dataclasses.dataclass(frozen=True)
class Case:
    """One serving run: `batch` rows, caches of `max_seq` positions (16: the
    model axis divides it, and the decode steps write the last rank's block;
    15: it does not, and the caches stay whole over the sequence), and the
    budget that picks the serving posture (a tiny one forces the training
    specs: fsdp-cut weights gathered unit by unit)."""
    arch: str
    batch: int = 4
    max_seq: int = 16
    budget: float = 10e9

    @property
    def name(self) -> str:
        extra = "" if self.max_seq == 16 else f"-seq{self.max_seq}"
        return self.arch + extra + ("-fsdp" if self.budget < 1e6 else "")


def config(arch):
    """The reduced config; MoE at capacity 8, where no assignment overflows."""
    cfg = configs.get(arch).reduced()
    return dataclasses.replace(cfg, capacity_factor=8.0) if cfg.num_experts else cfg


def float32_model(cfg):
    L.ACT_DTYPE = torch.float32
    return M.init_params(cfg, 0, "cpu").float()


def inputs(cfg, case: Case) -> torch.Tensor:
    """Token ids (B, PROMPT + DECODES): the prompt, then the decode steps'
    tokens (teacher forcing); frame features (B, PROMPT, F) for audio."""
    rng = np.random.default_rng(3)
    if cfg.family == "audio":
        return torch.from_numpy(rng.normal(size=(case.batch, PROMPT, cfg.frontend_dim))
                                .astype(np.float32))
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (case.batch, PROMPT + DECODES))
                            .astype(np.int32))


def run_case(layout, case: Case) -> dict:
    """The case on this rank of `layout` (collective): the logits of each
    step gathered whole, the caches brought to rank 0's host, the census of
    the prefill and of the first decode step, the bytes each rank holds."""
    cfg = config(case.arch)
    lay = layout.counting()
    model = steps.shard_params(lay, cfg, float32_model(cfg), case.budget)
    x = inputs(cfg, case)
    out = dict(held_params=lay.world.gather_objects(held_bytes(dict(model.named_parameters()))),
               logits=[], census={})
    if cfg.is_encoder:
        step = steps.make_prefill_step(cfg, lay)
        lay.reset_counts()
        logits = step(model, steps.shard_batch(lay, {"inputs": x}))
        out["census"]["encode"] = lay.counts()
        out["logits"].append(steps.gather_logits(lay, cfg, logits, case.batch).numpy())
        return out
    caches = steps.make_cache(lay, cfg, case.batch, case.max_seq)
    out["held_caches"] = lay.world.gather_objects(held_bytes(caches))
    prefill, decode = steps.make_prefill_step(cfg, lay), steps.make_decode_step(cfg, lay)
    toks = steps.shard_batch(lay, {"t": x})["t"]
    lay.reset_counts()
    logits, caches = prefill(model, caches, {"inputs": toks[:, :PROMPT]})
    out["census"]["prefill"] = lay.counts()
    out["logits"].append(steps.gather_logits(lay, cfg, logits, case.batch).numpy())
    for i in range(DECODES):
        pos = PROMPT + i
        lay.reset_counts()
        logits, caches = decode(model, caches, {"token": toks[:, pos:pos + 1], "cache_pos": pos})
        out["census"].setdefault("decode", lay.counts())
        out["logits"].append(steps.gather_logits(lay, cfg, logits, case.batch).numpy())
    specs = steps.cache_shardings(lay, cfg, case.batch, case.max_seq)
    host = rules.gather_tree_to_host(specs, caches, group_of=lay.group, coords=lay.coords)
    out["caches"] = None if host is None else rules.tree_map(lambda t: t.numpy(), host)
    return out


def single_device(case: Case) -> dict:
    """The same case through the single-device steps."""
    act = L.ACT_DTYPE
    try:
        cfg = config(case.arch)
        model, x = float32_model(cfg), inputs(cfg, case)
        if cfg.is_encoder:
            return dict(logits=[steps.make_prefill_step(cfg)(model, {"inputs": x}).numpy()])
        caches = M.make_cache(cfg, case.batch, case.max_seq, "cpu")
        logits, caches = steps.make_prefill_step(cfg)(model, caches, {"inputs": x[:, :PROMPT]})
        out = [logits.numpy()]
        decode = steps.make_decode_step(cfg)
        for i in range(DECODES):
            pos = PROMPT + i
            logits, caches = decode(model, caches, {"token": x[:, pos:pos + 1], "cache_pos": pos})
            out.append(logits.numpy())
        return dict(logits=out, caches=rules.tree_map(lambda t: t.numpy(), caches))
    finally:
        L.ACT_DTYPE = act


@dataclasses.dataclass
class ServeJob:
    """Every case on the layout, in float32."""
    cases: tuple

    def run(self, layout, device) -> dict:
        return {case: run_case(layout, case) for case in self.cases}


@dataclasses.dataclass
class GenerateJob:
    """`lm_serve.generate(mesh=)`, greedy and sampled (bf16, the serving
    dtype), from the demo's seeded model and prompts."""
    arch: str

    def run(self, layout, device) -> dict:
        L.ACT_DTYPE = torch.bfloat16
        cfg = lm_serve.config(self.arch)
        model, prompts = lm_serve.seeded(cfg, 4, 12, "cpu")
        blocks = steps.shard_params(layout, cfg, model)
        return {t: lm_serve.generate(blocks, prompts, 6, t, lm_serve._draws("cpu"),
                                     layout).tokens for t in (0.0, 0.8)}


def close(got, want, what: str) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= TOL * scale, f"{what}: {err} > {TOL} x {scale}"


def check_case(res: dict, ref: dict, what: str) -> None:
    """Logits of every step and every cache leaf within TOL."""
    assert len(res["logits"]) == len(ref["logits"])
    for i, (g, w) in enumerate(zip(res["logits"], ref["logits"])):
        close(g, w, f"{what} step {i} logits")
    if "caches" in ref:
        for grp, layers in ref["caches"].items():
            for i, layer in enumerate(layers):
                for k, v in layer.items():
                    close(res["caches"][grp][i][k], v, f"{what} cache {grp}.{i}.{k}")


# ---------------------------------------------------------------------------
# What the design predicts
# ---------------------------------------------------------------------------

def held_params(cfg, sizes, rank: int, budget: float = 10e9) -> int:
    """Bytes of a rank's float32 blocks by `param_shardings(serve=True)`."""
    lay = mesh.shape_layout(sizes, rank)
    specs = steps.param_shardings(lay, cfg, serve=True, hbm_budget_bytes=budget)
    return sum(4 * math.prod(rules.block_shape(specs[k], v.shape, lay))
               for k, v in steps.abstract_params(cfg).items())


def held_caches(cfg, sizes, rank: int, batch: int, max_seq: int) -> int:
    """Bytes of a rank's float32 cache blocks by `cache_shardings`."""
    lay = mesh.shape_layout(sizes, rank)
    specs = steps.cache_shardings(lay, cfg, batch, max_seq)
    act = L.ACT_DTYPE
    try:
        L.ACT_DTYPE = torch.float32
        abstract = steps.abstract_caches(cfg, batch, max_seq)
    finally:
        L.ACT_DTYPE = act
    return sum(v.element_size() * math.prod(rules.block_shape(specs[g][i][k], v.shape, lay))
               for g, layers in abstract.items() for i, layer in enumerate(layers)
               for k, v in layer.items())


def _cut(n: int, m: int) -> bool:
    """A leaf dim of n entries is held as blocks other than the whole."""
    return m > 1 and n % m == 0


def _attention(cfg, m: int, phase: str, seq_cut: bool):
    """(gathers, reduces, all-to-alls) over the model axis of one attention."""
    heads, kv = cfg.num_heads, cfg.num_kv_heads
    split = heads % m == 0
    decode = phase == "decode"
    if cfg.use_mla:
        nq = 128 + cfg.rope_head_dim
        g = (not split) * (_cut(heads * nq, m) + _cut(heads * 128, m))   # wq, wo mid-head
        g += _cut(cfg.kv_lora_rank, m) + _cut(cfg.rope_head_dim, m)      # c, w_kr
        g += decode * seq_cut * (split + 1)                               # every head's q, softmax
        return g, split + decode * seq_cut, 0
    hd = cfg.resolved_head_dim
    kv_split = split and kv % m == 0
    bias = 1 + cfg.qkv_bias
    g = (not split) * (bias + 1) * _cut(heads * hd, m)                   # wq (bq), wo
    g += (not kv_split) * 2 * bias * _cut(kv * hd, m)                    # wk, wv (bk, bv)
    a = 0
    if phase == "prefill":
        a, g = kv_split * seq_cut, g + kv_split * (not seq_cut)
    if decode:
        g += kv_split + seq_cut * (split + 1)
    return g, split + decode * seq_cut, a


def _mamba(cfg, m: int, phase: str):
    d_inner = cfg.ssm_expand * cfg.d_model
    heads, n = d_inner // cfg.ssm_head_dim, cfg.ssm_state
    split = heads % m == 0
    conv = d_inner + 2 * n
    g = _cut(2 * d_inner + 2 * n + heads, m) + _cut(conv, m)             # in_proj, conv_w
    g += (not split) * _cut(d_inner, m) + (phase == "decode") * _cut(conv, m)
    return g, 2 * split, 0


def layer_kinds(cfg) -> list:
    """The layers a forward runs, in order: "dense", "moe" or "mamba"."""
    if cfg.family in ("dense", "vlm", "audio"):
        return ["dense"] * cfg.num_layers
    if cfg.family == "moe":
        n_super = (cfg.num_layers - cfg.first_dense_layers) // cfg.moe_layer_step
        return ["dense"] * cfg.first_dense_layers \
            + (["dense"] * (cfg.moe_layer_step - 1) + ["moe"]) * n_super
    k = cfg.shared_attn_every
    out = []
    for i in range(cfg.num_layers):
        out.append("mamba")
        if cfg.family == "hybrid" and i % k == k - 1:
            out.append("dense")
    return out


def units(cfg) -> int:
    """The units a forward enters (the embedding, each layer or MoE
    super-layer or shared-block site, the logits)."""
    if cfg.family == "moe":
        n_super = (cfg.num_layers - cfg.first_dense_layers) // cfg.moe_layer_step
        return 2 + cfg.first_dense_layers + n_super
    return 2 + len(layer_kinds(cfg))


def predicted(cfg, sizes, case: Case, phase: str) -> dict:
    """Calls of each collective a step makes on each group, by the design:
    over the model axis the gathers of the leaves cut inside a head or
    across a concatenation, of every head's q and the softmax's max and
    sum in decode, of MLA's c, of the MoE outputs and of the conv state;
    one float32 sum a row-cut product, the gated norm's and the
    embedding's; one all-to-all a GQA prefill whose KV heads and sequence
    are cut; over the fsdp axes, one gather a unit under the training
    specs."""
    data, m = sizes
    seq_cut = case.max_seq % m == 0
    g = r = a = 0
    if cfg.family == "audio":
        g += _cut(cfg.d_model, m)
    else:
        r += cfg.vocab_size % m == 0
    for kind in layer_kinds(cfg):
        if kind == "mamba":
            dg, dr, da = _mamba(cfg, m, phase)
        else:
            dg, dr, da = _attention(cfg, m, phase, seq_cut)
            if kind == "moe":
                dg += cfg.num_experts % m == 0
            else:
                dr += cfg.d_ff % m == 0
        g, r, a = g + dg, r + dr, a + da
    fsdp = units(cfg) if case.budget < 1e6 and data > 1 else 0
    return {"model": {"gather": g, "reduce": r, "all_to_all": a}, "data": {"gather": fsdp}}


def check_census(res: dict, cfg, sizes, case: Case) -> None:
    for phase, counts in res["census"].items():
        want = predicted(cfg, sizes, case, phase)
        got = {grp: {k: counts[grp][k]["calls"] for k in want[grp]} for grp in want}
        assert got == want, (case.name, phase, got, want)
        assert all(c["calls"] == 0 for grp, cs in counts.items() if grp not in want
                   for c in cs.values()), (case.name, phase, counts)
        assert counts["model"]["merge"]["calls"] == counts["model"]["scatter_sum"]["calls"] == 0


def meta_census(cfg, sizes, kind: str, batch: int, seq: int, dp_over_model: bool = False,
                cache_len=None, budget: float = 10e9) -> dict:
    """The census by group (`LMGroups.counts()`) of one step of `kind` at
    rank 0 of a layout of `sizes`, traced on meta tensors by the dry run
    (`launch.dryrun.trace_cell`) in float32, as the gloo jobs run it:
    `batch` rows of `seq` tokens (decode: caches of `seq` positions)."""
    row = dryrun.trace_cell(cfg, ShapeConfig(kind, seq, batch, kind), sizes, dp_over_model,
                            cache_len=cache_len, budget=budget, dtype=torch.float32)
    return row["collectives"]["groups"]


def check_meta_census(res: dict, cfg, sizes, case: Case) -> None:
    """Each step's census on the layout (rank 0's) equals the dry run's."""
    for phase, counts in res["census"].items():
        if phase == "decode":
            want = meta_census(cfg, sizes, "decode", case.batch, case.max_seq,
                               budget=case.budget)
        else:
            want = meta_census(cfg, sizes, "prefill", case.batch, PROMPT,
                               cache_len=case.max_seq, budget=case.budget)
        assert counts == want, (case.name, phase, counts, want)
