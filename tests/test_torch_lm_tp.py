"""Serving over a layout, in this process (the CPU): the anchors, the
gathers the layers take at the production layouts, and a one-rank gloo
layout against one device.

1. `sharding.hints`: with no layout, and under the DP-over-model posture,
   every anchor returns its input itself, so every single-device and FSDP
   path is untouched; under a tensor-parallel layout `hint_logits` and
   `hint_moe_buffer` give the rank's block of a whole value, pass a block
   through and refuse anything else; `layout` restores the previous one.
2. The gathered leaves at 16 x 16 and 2 x 16 x 16 (rank 0 of
   `mesh.meta_layout`, every group's collectives answered with meta tensors
   of the right shapes): a prefill and a decode step of all ten configs at
   full width, depth cut to one layer of each kind, on meta tensors, and
   the weights each layer gathers over the model axis recorded.  They are
   exactly the leaves whose cut falls inside a head or across a
   concatenation, as the table below lists them; llama4-400b takes the
   training specs there (its weights exceed the budget whole over fsdp).
3. A one-rank gloo layout: all ten reduced configs, prefill and six decode
   steps in float32 against one device at 1e-5 (tests/_torch_lm_tp.py),
   the census of each step as the design predicts (every collective of the
   tensor-parallel code runs as a copy: no shortcut at one rank), and the
   held bytes; a cache not made on the layout and weights that are a block
   of neither posture are refused; a tensor-parallel train step runs and
   restores the layout.
"""
import dataclasses

import pytest
import torch
import torch.distributed as dist

from _torch_lm_tp import (ARCHS, Case, check_case, check_census, held_caches, held_params,
                          run_case, single_device)
from repro_torch import configs
from repro_torch.launch import mesh, steps
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import tp
from repro_torch.optim import adamw
from repro_torch.sharding import hints, rules


# ---------------------------------------------------------------------------
# 1. The anchors
# ---------------------------------------------------------------------------

def test_anchors_are_the_identity_without_a_layout():
    x = torch.randn(2, 3, 8, 4)
    assert hints.get_mesh() is None and tp.group() is None
    assert hints.hint_batch(x) is x
    assert hints.hint_logits(x, 4) is x
    assert hints.hint_moe_buffer(x, 3) is x
    with hints.layout(mesh.shape_layout((1, 4), 2), dp_over_model=True):
        assert tp.group() is None and hints.dp_over_model()
        assert hints.hint_logits(x, 4) is x and hints.hint_moe_buffer(x, 3) is x
    assert hints.get_mesh() is None and not hints.dp_over_model()


def test_anchors_cut_a_whole_value_to_the_rank_block():
    lay = mesh.shape_layout((2, 4), 6)                  # data 1, model 2 of 4
    x = torch.arange(2 * 8 * 4 * 3).reshape(2, 8, 4, 3)
    with hints.layout(lay):
        assert hints.get_mesh() is lay and tp.group().rank == 2
        assert torch.equal(hints.hint_moe_buffer(x, 8), x[:, 4:6])
        block = x[:, 4:6]
        assert hints.hint_moe_buffer(block, 8) is block
        assert hints.hint_logits(x, 3) is x            # 4 does not divide a vocab of 3
        assert torch.equal(hints.hint_logits(x.transpose(1, 3), 8), x.transpose(1, 3)[..., 4:6])
        with pytest.raises(ValueError, match="neither the whole"):
            hints.hint_moe_buffer(x[:, :3], 8)
        assert hints.hint_batch(x) is x
    assert hints.get_mesh() is None


# ---------------------------------------------------------------------------
# 2. The gathered leaves at the production layouts
# ---------------------------------------------------------------------------

DEPTH = {"deepseek-v2-lite-16b": 2, "llama4-maverick-400b-a17b": 2, "zamba2-7b": 6}

# Per config, the leaves (name less its stack and index) whose blocks a
# layer gathers over a model axis of 16: a cut inside a head (qwen2-0.5b's
# 14 query and 2 KV heads, llama4's 40 and 8; the KV heads of the GQA
# configs with fewer than 16), across RoPE's halves (MLA's w_kr), across z | xBC | dt (in_proj) or
# x | B | C (conv_w), or where the activation must stay whole over the
# model axis (the audio frontend's d_model columns).
GATHERED = {
    "chameleon-34b": {"attn.wk", "attn.wv"},
    "deepseek-v2-lite-16b": {"attn.w_kr"},
    "hubert-xlarge": {"frontend.w"},
    "internlm2-1.8b": {"attn.wk", "attn.wv"},
    "llama4-maverick-400b-a17b": {"attn.wq", "attn.wk", "attn.wv", "attn.wo"},
    "mamba2-1.3b": {"mixer.in_proj", "mixer.conv_w"},
    "qwen2-0.5b": {"attn.wq", "attn.bq", "attn.wk", "attn.bk", "attn.wv", "attn.bv", "attn.wo"},
    "qwen3-8b": {"attn.wk", "attn.wv"},
    "yi-6b": {"attn.wk", "attn.wv"},
    "zamba2-7b": {"mixer.in_proj", "mixer.conv_w"},
}


def by_rule(cfg, m):
    """The same table from the design's rule: a leaf cut over the model axis
    whose block is not the entries its layer's units need."""
    out = set()
    cut = lambda n: n % m == 0
    h, kv = cfg.num_heads, cfg.num_kv_heads
    if cfg.family == "audio" and cut(cfg.d_model):
        out.add("frontend.w")
    if cfg.family in ("ssm", "hybrid"):
        d_inner = cfg.ssm_expand * cfg.d_model
        hs, n = d_inner // cfg.ssm_head_dim, cfg.ssm_state
        out |= {"mixer.in_proj"} if cut(2 * d_inner + 2 * n + hs) else set()
        out |= {"mixer.conv_w"} if cut(d_inner + 2 * n) else set()
        out |= {"mixer.out_proj"} if cut(d_inner) and not cut(hs) else set()
    if cfg.family == "ssm":
        return out
    if cfg.use_mla:
        out |= {"attn.w_kr"} if cut(cfg.rope_head_dim) else set()
        out |= {"attn.wq", "attn.wo"} if not cut(h) and cut(h * 128) else set()
        return out
    hd, bias = cfg.resolved_head_dim, ("b",) if cfg.qkv_bias else ()
    if not cut(h) and cut(h * hd):
        out |= {f"attn.{p}q" for p in ("w",) + bias} | {"attn.wo"}
    if not (cut(h) and cut(kv)) and cut(kv * hd):
        out |= {f"attn.{p}{c}" for p in ("w",) + bias for c in "kv"}
    return out


def short(name):
    parts = name.split(".")
    if parts[0] in M.STACKS:
        parts = parts[2:]
    elif parts[0] == "shared_attn":
        parts = parts[1:]
    return ".".join(parts)


@pytest.mark.parametrize("sizes", [(16, 16), (2, 16, 16)], ids=["16x16", "2x16x16"])
def test_gathered_leaves_at_production_layouts(sizes, monkeypatch):
    lay = mesh.meta_layout(sizes)
    batch = 32 if len(sizes) == 3 else 16                  # a row a rank of the fsdp axes
    names, gathered, posture = {}, {}, {}
    take, bound = tp.take, steps._bound

    def recording_take(g, leaf, dim, ranges, n, part=False):
        if leaf.shape[dim] != n and list(ranges) != [(g.rank * leaf.shape[dim],
                                                      (g.rank + 1) * leaf.shape[dim])]:
            gathered[arch].add(short(names[id(leaf)]))
        return take(g, leaf, dim, ranges, n, part)

    def recording_bound(slots, tensors):
        names.update({id(t): k for k, t in tensors.items()})
        return bound(slots, tensors)

    monkeypatch.setattr(tp, "take", recording_take)
    monkeypatch.setattr(steps, "_bound", recording_bound)
    for arch in ARCHS:
        gathered[arch] = set()
        base = configs.get(arch)
        cfg = dataclasses.replace(base, num_layers=DEPTH.get(arch, 1))
        serve = steps.param_shardings(lay, base, serve=True)
        posture[arch] = serve == rules.tree_specs(lay, steps.abstract_params(base),
                                                  rules.param_spec_serve)
        # the posture of the whole config, the weights of the cut one
        blocks = steps.shard_params(lay, cfg, M.LMModel(cfg, None, "meta"),
                                    1e30 if posture[arch] else 0.0)
        names.update({id(p): k for k, p in blocks.named_parameters()})
        if cfg.is_encoder:
            steps.make_prefill_step(cfg, lay)(
                blocks, {"inputs": torch.empty((1, 8, cfg.frontend_dim), device="meta")})
        else:
            caches = steps.make_cache(lay, cfg, batch, 16)
            toks = torch.empty((batch // lay.shape["data"] // lay.shape.get("pod", 1), 9),
                               dtype=torch.int32, device="meta")
            steps.make_prefill_step(cfg, lay)(blocks, caches, {"inputs": toks[:, :8]})
            steps.make_decode_step(cfg, lay)(blocks, caches, {"token": toks[:, 8:],
                                                              "cache_pos": 8})
        assert gathered[arch] == GATHERED[arch] == by_rule(base, 16), arch
    assert [a for a, serving in posture.items() if not serving] == \
        ["llama4-maverick-400b-a17b"]


# ---------------------------------------------------------------------------
# 3. A one-rank gloo layout in this process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path_factory.mktemp('rdv')}/f",
                            rank=0, world_size=1)
    act = L.ACT_DTYPE
    try:
        yield mesh.make_host_mesh(1, 1)
    finally:
        L.ACT_DTYPE = act
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_layout_matches_single_device(one_rank, arch):
    case = Case(arch)
    res = run_case(one_rank, case)
    check_case(res, single_device(case), f"1x1 {arch}")
    cfg = configs.get(arch).reduced()
    check_census(res, cfg, (1, 1), case)
    calls = sum(c["calls"] for phase in res["census"].values()
                for c in phase["model"].values())
    assert calls > 0                      # the tensor-parallel code ran its collectives
    assert res["held_params"][0]["tensors"] == held_params(cfg, (1, 1), 0)
    if "held_caches" in res:
        assert res["held_caches"][0]["tensors"] == held_caches(cfg, (1, 1), 0, 4, 16)


def test_layout_refuses_what_it_cannot_place(one_rank):
    cfg = configs.get("qwen2-0.5b").reduced()
    model = M.init_params(cfg, 0, "cpu")
    toks = torch.zeros((2, 4), dtype=torch.int32)
    prefill = steps.make_prefill_step(cfg, one_rank)
    with pytest.raises(TypeError, match="make_cache"):
        prefill(model, M.make_cache(cfg, 2, 8, "cpu"), {"inputs": toks})
    two = mesh.shape_layout((1, 2))
    with pytest.raises(ValueError, match="neither posture"):
        steps.make_prefill_step(cfg, two)(model, steps.make_cache(two, cfg, 2, 8),
                                          {"inputs": toks})
    assert hints.get_mesh() is None                      # the step restored the layout


def test_tensor_parallel_training_still_raises(one_rank):
    """Tensor-parallel training no longer raises: a step of the posture on
    the one-rank layout runs, gives a finite loss and grad norm, and leaves
    the layout it found installed (none) after it."""
    cfg, opt = configs.get("qwen2-0.5b").reduced(), adamw.OptConfig()
    L.ACT_DTYPE = torch.float32
    model = M.init_params(cfg, 0, "cpu").float()
    state = steps.shard_state(one_rank, steps.init_train_state(model, opt))
    step = steps.make_train_step(cfg, opt, mesh=one_rank, dp_over_model=False)
    batch = {"inputs": torch.zeros((2, 8), dtype=torch.int32),
             "labels": torch.ones((2, 8), dtype=torch.int32)}
    assert hints.get_mesh() is None
    state, metrics = step(M.LMModel(cfg, None, "meta"), state, steps.shard_batch(one_rank, batch))
    assert hints.get_mesh() is None and int(state.step) == 1
    assert torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"])
