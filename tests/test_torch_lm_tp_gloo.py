"""Serving over a 2 x 2 layout (data x model) in four spawned gloo ranks
(`run_ranks(..., lm=(2, 2))`), in float32: `make_prefill_step(cfg, mesh=)`,
then six `make_decode_step(cfg, mesh=)` steps, against the single-device
steps from the same weights and tokens.

1. All ten reduced configs (the encoder through its encode step), caches
   of 16 positions (the model axis cuts the sequence; the decode steps
   write the last rank's block), plus qwen2-0.5b (GQA), deepseek-v2-lite
   (MLA + MoE) and zamba2-7b (Mamba2 + shared attention) at 15 positions
   (the caches stay whole over the sequence) and under a budget that forces
   the training specs (each unit's fsdp blocks gathered while it runs):
   the logits of every step gathered whole, and every cache leaf brought to
   rank 0's host, within 1e-5 of each leaf's largest magnitude.
2. Each rank holds exactly its blocks: the weights' bytes by
   `param_shardings(serve=True)` (both postures) and the caches' by
   `cache_shardings`.
3. The census of a prefill and of a decode step, call for call, as the
   design predicts from the config (`_torch_lm_tp.predicted`), and, call
   for call and byte for byte, as the dry run traces the same steps on
   meta tensors (`launch.dryrun.trace_cell`).
4. `lm_serve.generate(mesh=)`, greedy and sampled, gives one device's
   tokens.

One `run_ranks` call: a 120 s wall-clock limit, a 60 s collective timeout.
"""
import math

import pytest
import torch

from _torch_lm_tp import (ARCHS, Case, GenerateJob, ServeJob, check_case, check_census,
                          check_meta_census, config, held_caches, held_params, single_device)
from repro_torch.launch import lm_serve, steps
from repro_torch.launch.distributed import run_ranks
from repro_torch.models import layers as L

SIZES = (2, 2)
EDGE = ["qwen2-0.5b", "deepseek-v2-lite-16b", "zamba2-7b"]
CASES = tuple([Case(a) for a in ARCHS] + [Case(a, max_seq=15) for a in EDGE]
              + [Case(a, budget=1.0) for a in EDGE])


@pytest.fixture(scope="module")
def runs():
    act = L.ACT_DTYPE
    try:
        serve, gen = run_ranks(math.prod(SIZES), [ServeJob(CASES), GenerateJob("yi-6b")],
                               "cpu", 120.0, 60.0, None, SIZES)
    finally:
        L.ACT_DTYPE = act
    return dict(serve=serve, generate=gen)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_serving_matches_single_device(runs, case):
    check_case(runs["serve"][case], single_device(case), f"2x2 {case.name}")


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_held_bytes_equal_spec_arithmetic(runs, case):
    res, cfg = runs["serve"][case], config(case.arch)
    for r, h in enumerate(res["held_params"]):
        want = held_params(cfg, SIZES, r, case.budget)
        assert h["tensors"] == want and h["storages"] == want, (r, h, want)
    n = sum(4 * v.numel() for v in steps.abstract_params(cfg).values())
    assert res["held_params"][0]["tensors"] < n                 # not the whole model
    for r, h in enumerate(res.get("held_caches", [])):
        want = held_caches(cfg, SIZES, r, case.batch, case.max_seq)
        assert h["tensors"] == want and h["storages"] == want, (r, h, want)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_census_as_designed(runs, case):
    check_census(runs["serve"][case], config(case.arch), SIZES, case)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
def test_census_equals_the_dry_run(runs, case):
    check_meta_census(runs["serve"][case], config(case.arch), SIZES, case)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_generate_on_the_layout_equals_one_device(runs, temperature):
    cfg = lm_serve.config("yi-6b")
    model, prompts = lm_serve.seeded(cfg, 4, 12, "cpu")
    want = lm_serve.generate(model, prompts, 6, temperature, lm_serve._draws("cpu")).tokens
    assert torch.equal(runs["generate"][temperature], want)
