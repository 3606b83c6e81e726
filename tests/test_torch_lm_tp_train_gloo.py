"""The tensor-parallel train step (`make_train_step(mesh=,
dp_over_model=False)`) over a 2 x 2 gloo layout in spawned CPU processes:
the batch over data, whole over model; each leaf in `rules.param_spec`'s
blocks, cut over data on one dim and over model on another.

1. Reduced qwen2-0.5b (GQA with qkv bias, tied), deepseek-v2-lite-16b (MLA,
   MoE, a dense prefix) and zamba2-7b (Mamba2 with the shared attention
   block), two steps each in float32 with remat, against the
   single-device port's step on the same global batches: the loss, the
   grad norm, every gradient leaf (gathered from the ranks' blocks before
   the update) and the state after each step (mu and nu within 1e-5 of
   each leaf's largest magnitude; params and master within what mu and
   nu's tolerance allows AdamW's direction to move, `check_state(count=)`).
2. Each rank holds exactly its blocks of params, mu, nu and master
   (`state_bytes_per_rank(dp_over_model=False)`), each in a storage of its
   own.
3. The census of one step: over the model axis, call for call, what the
   config's shapes give (`_torch_lm_tp_train.predicted`); over the data
   axis, one gather a unit in the forward and one a layer unit in remat's
   recomputation, of the bytes the specs give those units' blocks; and
   every group's, call for call and byte for byte, as the dry run traces
   the same step on meta tensors (`launch.dryrun.trace_cell`).
4. `reshard` of a bf16 host tree onto 2 x 2 by the tensor-parallel specs
   (blocks cut two ways) and onto 2 x 1, then `gather_tree_to_host`, gives
   back the same bits.
5. The elastic restart: qwen2 trained two steps at 2 x 2, its whole state
   saved from rank 0's host, restored and resharded onto
   `plan_elastic_mesh(2, 1)`'s layout in the same posture, one more step,
   against the single-device step from that state.

Two `run_ranks` calls (a 120 s limit, a 60 s collective timeout each).
"""
import concurrent.futures
import math

import pytest

from _torch_lm_tp import meta_census
from _torch_lm_tp_train import (ARCHS, RoundTripJob, TPJob, config, predicted, refs_of,
                                single_device)
from repro_torch.launch import mesh, steps
from repro_torch.launch.distributed import run_ranks
from repro_torch.models import layers as L
from repro_torch.runtime import failures
from repro_torch.sharding import rules
from test_torch_lm_mesh_gloo import B, OPT, S, STEPS, check_state, check_step, units

SIZES = (2, 2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    saved = str(tmp_path_factory.mktemp("elastic"))
    act = L.ACT_DTYPE
    try:
        four = run_ranks(4, [TPJob(a, save_to=saved if a == ARCHS[0] else None) for a in ARCHS]
                         + [RoundTripJob(ARCHS[1])], "cpu", 120.0, 60.0, None, SIZES)
        survivors = failures.plan_elastic_mesh(2, 1)        # (data, model) of 2 ranks
        assert survivors == (2, 1)
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            two = pool.submit(run_ranks, 2, [TPJob(ARCHS[0], steps=1, first=STEPS,
                                                   restore_from=saved), RoundTripJob(ARCHS[2])],
                              "cpu", 120.0, 60.0, None, survivors)
            refs = {a: refs_of(a, r) for a, r in zip(ARCHS, four)}
            elastic_ref = single_device(ARCHS[0], STEPS, four[0]["steps"][-1]["state"])
            two = two.result()
    finally:
        L.ACT_DTYPE = act
    return dict(results=dict(zip(ARCHS, four)), refs=refs, round_trip=[four[-1], two[-1]],
                elastic=two[0], elastic_ref=elastic_ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_step_matches_single_device(runs, arch):
    res, ref = runs["results"][arch], runs["refs"][arch]
    for i in range(STEPS):
        check_step(res["steps"][i], ref[i], f"2x2 {arch} step {i}")
        check_state(res["steps"][i]["state"], ref[i]["state"], f"2x2 {arch} step {i}",
                    ref[i]["lr"], count=i + 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_held_bytes_equal_spec_arithmetic(runs, arch):
    """The params are float32 here: `state_bytes_per_rank` counts them in
    their own dtype (bf16 but the router and the SSM's a_log, d_skip and
    dt_bias), so the held bytes are its count plus 2 B an element of each
    bf16 leaf's block."""
    cfg = config(arch)
    held = runs["results"][arch]["held"]
    assert len(held) == math.prod(SIZES)
    for r, h in enumerate(held):
        lay = mesh.shape_layout(SIZES, r)
        widened = sum((4 - v.element_size()) * math.prod(
            rules.block_shape(rules.param_spec(lay, (k,), v), v.shape, lay))
            for k, v in steps.abstract_params(cfg).items())
        want = steps.state_bytes_per_rank(lay, cfg, OPT, dp_over_model=False) + widened
        assert h["tensors"] == h["storages"] == want, (r, h, want)
    n = sum(v.numel() for v in steps.abstract_params(cfg).values())
    assert held[0]["tensors"] < 16 * n // 2             # less than half the state


def tp_unit_bytes(cfg, prefixes):
    """The bytes one gather of a unit moves over the data axis (float32):
    the axis's size times one rank's blocks (cut two ways) of the unit's
    fsdp-cut leaves, padded to 8 bytes."""
    lay = mesh.shape_layout(SIZES)
    own = 0
    for k, v in steps.abstract_params(cfg).items():
        if any(k.startswith(p + ".") for p in prefixes):
            spec = rules.param_spec(lay, (k,), v)
            if any(e not in (None, rules.MODEL) for e in spec):
                own += 4 * math.prod(rules.block_shape(spec, v.shape, lay))
    return SIZES[0] * (own + (-own % 8))


@pytest.mark.parametrize("arch", ARCHS)
def test_census_as_the_shapes_give_it(runs, arch):
    cfg = config(arch)
    forward, recompute = units(cfg)
    for step in runs["results"][arch]["steps"]:
        model = {k: step["counts"]["model"][k]["calls"]
                 for k in ("gather", "reduce", "grad_sum", "scatter_sum")}
        assert model == predicted(cfg, SIZES), (arch, model)
        assert step["counts"]["model"]["merge"]["calls"] == 0
        data = step["counts"]["data"]
        assert data["gather"]["calls"] == len(forward) + len(recompute)
        assert data["gather"]["bytes"] == sum(tp_unit_bytes(cfg, u) for u in forward + recompute)
        assert data["scatter_sum"]["calls"] >= len(forward)
        assert step["counts"]["data+model"]["merge"]["calls"] == 1     # the loss and the norm


@pytest.mark.parametrize("arch", ARCHS)
def test_census_equals_the_dry_run(runs, arch):
    want = meta_census(config(arch), SIZES, "train", B, S)
    for step in runs["results"][arch]["steps"]:
        assert step["counts"] == want, arch


def test_reshard_round_trip_same_bits(runs):
    for res, sizes, arch in zip(runs["round_trip"], [SIZES, (2, 1)], [ARCHS[1], ARCHS[2]]):
        assert res["same"] is True
        assert res["two_cut"] > 0            # leaves cut over data and over model
        cfg = config(arch)
        for r, h in enumerate(res["held"]):
            want = steps.state_bytes_per_rank(mesh.shape_layout(sizes, r), cfg, OPT)
            assert h["tensors"] == h["storages"] == want, (sizes, r, h, want)


def test_elastic_restart_matches_single_device(runs):
    """Two steps at 2 x 2, then the survivors' (2, 1) layout from the saved
    state: the third step and the state after it as the single-device step
    from the same state."""
    res, ref = runs["elastic"], runs["elastic_ref"]
    check_step(res["steps"][0], ref, "elastic step")
    check_state(res["steps"][0]["state"], ref["state"], "elastic", ref["lr"], count=STEPS + 1)
