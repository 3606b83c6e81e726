"""The LM serving path of the port: the tree converters (`repro_torch.convert`,
JAX -> port -> numpy bit for bit), the step factories
(`repro_torch.launch.steps`) and the flow of `repro_torch.launch.lm_serve`."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import model as JM
from repro_torch import convert
from repro_torch.launch import lm_serve, steps
from repro_torch.models import model as TM

from _torch_lm import ARCH_NAMES, inputs, jax_and_port, reduced


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_trees_round_trip_bit_for_bit(name):
    """Parameters, and caches filled with seeded values, cross JAX -> port ->
    numpy unchanged (bf16 as its bits), with the reference tree's layout."""
    cfg = reduced(name)
    params, model = jax_and_port(cfg)
    want = jax.tree.map(np.asarray, params)
    got = convert.lm_params_to_numpy(model)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))
    if not cfg.supports_decode:
        return
    rng = np.random.default_rng(0)
    cache = jax.tree.map(lambda a: np.asarray(jnp.asarray(rng.normal(size=a.shape), a.dtype)),
                         JM.make_cache(cfg, 2, 8))
    back = convert.lm_cache_to_numpy(convert.lm_cache_from_jax(cache, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(cache)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(cache)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_converter_refuses_a_tree_of_another_config():
    params, _ = jax_and_port(reduced("yi-6b"))
    tree = jax.tree.map(np.asarray, params)
    with pytest.raises(KeyError):
        convert.lm_params_from_jax(tree, reduced("qwen2-0.5b"), "cpu")      # biases, no head
    with pytest.raises(ValueError, match="is \\(64,\\)"):
        convert.lm_params_from_jax(tree, jax_configs.get("yi-6b").reduced(d_model=32), "cpu")


@pytest.mark.parametrize("name", ["hubert-xlarge", "qwen2-0.5b", "zamba2-7b"])
def test_steps_are_the_model_entry_points(name):
    cfg = reduced(name)
    model = TM.init_params(cfg, 0, "cpu")
    toks = torch.from_numpy(inputs(cfg, 2, 12))
    prefill = steps.make_prefill_step(cfg)
    if cfg.is_encoder:
        assert torch.equal(prefill(model, {"inputs": toks}), TM.forward_train(model, toks))
        return
    a = TM.make_cache(cfg, 2, 13, "cpu")
    la, a = prefill(model, a, {"inputs": toks[:, :11]})
    b = TM.make_cache(cfg, 2, 13, "cpu")
    lb, b = TM.forward_prefill(model, toks[:, :11], b)
    assert torch.equal(la, lb)
    batch = {"token": toks[:, 11:], "cache_pos": torch.tensor(11, dtype=torch.int32)}
    la, a = steps.make_decode_step(cfg)(model, a, batch)
    lb, b = TM.forward_decode(model, toks[:, 11:], b, 11)
    assert torch.equal(la, lb) and la.shape == (2, 1, cfg.vocab_size)


def test_generate_greedy_and_sampled():
    """The serving flow on the CPU: greedy tokens are the argmax of each
    step's logits, run by hand; sampling from a seeded generator repeats."""
    cfg = reduced("deepseek-v2-lite-16b", capacity_factor=8.0)
    model = TM.init_params(cfg, 0, "cpu")
    prompts = torch.from_numpy(inputs(cfg, 3, 10))
    res = lm_serve.generate(model, prompts, 5)
    assert res.tokens.shape == (3, 5) and res.tokens.dtype == torch.int32
    assert len(res.step_ms) == 4 and res.prefill_ms > 0 and res.first_token_ms > 0
    assert res.all_finite
    caches = TM.make_cache(cfg, 3, 15, "cpu")
    lg, caches = TM.forward_prefill(model, prompts, caches)
    tok = lg[:, -1].argmax(-1, keepdim=True).int()
    want = [tok]
    for pos in range(10, 14):
        lg, caches = TM.forward_decode(model, tok, caches, pos)
        tok = lg[:, 0].argmax(-1, keepdim=True).int()
        want.append(tok)
    assert torch.equal(res.tokens, torch.cat(want, dim=1))
    # score: the same steps on the generated continuation
    seq = torch.cat([prompts, res.tokens[:, :-1]], dim=1)
    for got, tok in zip(lm_serve.score(model, seq, 10), res.tokens.T):
        assert torch.equal(got.argmax(-1).int(), tok)
    draw = lambda: lm_serve.generate(model, prompts, 5, 0.8,
                                     torch.Generator().manual_seed(4)).tokens
    assert torch.equal(draw(), draw())
    with pytest.raises(ValueError, match="Generator"):
        lm_serve.generate(model, prompts, 5, 0.8)
    with pytest.raises(ValueError, match="encoder-only"):
        lm_serve.generate(TM.init_params(reduced("hubert-xlarge"), 0, "cpu"), prompts, 2)


def test_lm_serve_main_on_the_cpu(capsys):
    lm_serve.main(["--arch", "mamba2-1.3b", "--batch", "2", "--prompt-len", "8",
                   "--tokens", "4", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "prefill: batch=2 len=8" in out and "decode: 4 tokens x 2 seqs" in out


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA card")


def test_entry_points_default_to_cuda_and_raise_without_it(no_card):
    cfg = reduced("yi-6b")
    with pytest.raises(RuntimeError, match="cuda"):
        TM.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="cuda"):
        TM.make_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.lm_params_from_jax({}, cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        convert.lm_cache_from_jax({})
    with pytest.raises(RuntimeError, match="cuda"):
        lm_serve.main(["--arch", "yi-6b"])


@pytest.mark.parametrize("name", [n for n in ARCH_NAMES if n != "hubert-xlarge"])
def test_decode_matches_train_in_float32_at_depth(name, monkeypatch):
    """The cache path without bf16's rounding: six layers, parameters and
    activations in float32 (no MoE overflow), prefill and 8 decode steps
    against forward_train within 1e-4 in log-softmax.  In bf16 the gap
    grows with depth (a near-tied route flips, and its token's change
    spreads), in the reference as in the port."""
    from repro_torch.models import layers
    monkeypatch.setattr(layers, "ACT_DTYPE", torch.float32)
    cfg = jax_configs.get(name).reduced(layers=6)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.top_k + 1)
    model = TM.init_params(cfg, 0, "cpu").float()
    toks = torch.from_numpy(inputs(cfg, 2, 48))
    full = TM.forward_train(model, toks).double()
    for j, lg in enumerate(lm_serve.score(model, toks, 40)):
        d = torch.log_softmax(lg.double(), -1) - torch.log_softmax(full[:, 39 + j], -1)
        assert float(d.abs().max()) < 1e-4, (j, float(d.abs().max()))


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "hubert-xlarge", "qwen2-0.5b",
                                  "zamba2-7b"])
def test_serving_builds_no_graph(name):
    """The parameters are trainable, yet prefill, decode, the serving steps
    and `lm_serve.generate`/`score` run under `torch.inference_mode()`: the
    logits and tokens they return are inference tensors with no `grad_fn`,
    and the caches (the caller's, written in place) record no graph."""
    cfg = reduced(name)
    model = TM.init_params(cfg, 0, "cpu")
    assert all(p.requires_grad for p in model.parameters())
    toks = torch.from_numpy(inputs(cfg, 2, 12))
    no_graph = lambda t: t.grad_fn is None and not t.requires_grad
    if cfg.is_encoder:
        out = steps.make_prefill_step(cfg)(model, {"inputs": toks})
        assert out.is_inference() and no_graph(out)
        return
    lg0, caches = TM.forward_prefill(model, toks[:, :11], TM.make_cache(cfg, 2, 13, "cpu"))
    lg1, caches = TM.forward_decode(model, toks[:, 11:], caches, 11)
    assert all(no_graph(t) for t in jax.tree.leaves(caches))
    lg2, _ = steps.make_prefill_step(cfg)(model, TM.make_cache(cfg, 2, 13, "cpu"),
                                          {"inputs": toks[:, :11]})
    outs = [lg0, lg1, lg2, lm_serve.generate(model, toks[:, :11], 2).tokens]
    outs += lm_serve.score(model, toks, 10)
    assert all(t.is_inference() and no_graph(t) for t in outs)
