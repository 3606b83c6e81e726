"""The tensor-parallel train step over 1 x 2 and 1 x 4 gloo layouts (the
model axis alone) in spawned CPU processes, in float32 with remat, against
the single-device step (as tests/test_torch_lm_tp_train_gloo.py does at
2 x 2).  These layouts reach the conjugates that turn an error into a
factor of the axis's size:

* qwen2-0.5b's 2 KV heads over 4 ranks: wk, wv, bk and bv gathered whole,
  each rank reading its query heads' KV head, so their gradients are
  partials, reduce-scattered;
* Mamba2's in_proj (296 wide) and conv_w cut across z | xBC | dt and
  x | B | C, gathered whole; xBC computed whole on every rank and read in
  part; the gated norm's sum of squares, which every rank uses for its
  own block;
* head and expert counts that 4 does not divide (`VARIANTS`: qwen2 with 2
  query heads, deepseek with 2 heads and 6 experts): every rank computes
  them all, and the gathered weights' gradients are the rank's own block,
  with no sum; MLA's c then has its rank r cut over the axis while every
  head is on every rank.

Per config and layout, two steps: the loss, the grad norm, every gradient
leaf and the state after each step (`check_state(count=)`), the bytes each
rank holds, the census over the model axis call for call as the
shapes give it, and every group's call for call and byte for byte as the
dry run traces the step on meta tensors (`launch.dryrun.trace_cell`).  The two layouts run at once, each `run_ranks` call with a
120 s limit and a 60 s collective timeout.
"""
import concurrent.futures
import math

import pytest

from _torch_lm_tp import meta_census
from _torch_lm_tp_train import ARCHS, VARIANTS, TPJob, config, held_state, predicted, refs_of
from repro_torch.launch.distributed import run_ranks
from repro_torch.models import layers as L
from test_torch_lm_mesh_gloo import B, S, STEPS, check_state, check_step

LAYOUTS = {"1x2": (1, 2), "1x4": (1, 4)}
NAMES = ARCHS + list(VARIANTS)


@pytest.fixture(scope="module")
def runs():
    act = L.ACT_DTYPE
    try:
        with concurrent.futures.ThreadPoolExecutor(len(LAYOUTS)) as pool:
            futs = {k: pool.submit(run_ranks, math.prod(s), [TPJob(n) for n in NAMES], "cpu",
                                   120.0, 60.0, None, s) for k, s in LAYOUTS.items()}
            results = {k: dict(zip(NAMES, f.result())) for k, f in futs.items()}
        refs = {n: refs_of(n, results["1x2"][n]) for n in NAMES}
        refs4 = {n: refs_of(n, results["1x4"][n]) for n in NAMES}
    finally:
        L.ACT_DTYPE = act
    return dict(results=results, refs={"1x2": refs, "1x4": refs4})


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tp_step_matches_single_device(runs, layout, name):
    res, ref = runs["results"][layout][name], runs["refs"][layout][name]
    for i in range(STEPS):
        check_step(res["steps"][i], ref[i], f"{layout} {name} step {i}")
        check_state(res["steps"][i]["state"], ref[i]["state"], f"{layout} {name} step {i}",
                    ref[i]["lr"], count=i + 1)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_held_bytes_and_census(runs, layout, name):
    res, cfg, sizes = runs["results"][layout][name], config(name), LAYOUTS[layout]
    for r, h in enumerate(res["held"]):
        want = held_state(cfg, sizes, r)
        assert h["tensors"] == h["storages"] == want, (r, h, want)
    for step in res["steps"]:
        model = {k: step["counts"]["model"][k]["calls"]
                 for k in ("gather", "reduce", "grad_sum", "scatter_sum")}
        assert model == predicted(cfg, sizes), (name, model)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_census_equals_the_dry_run(runs, layout, name):
    want = meta_census(config(name), LAYOUTS[layout], "train", B, S)
    for step in runs["results"][layout][name]["steps"]:
        assert step["counts"] == want, (layout, name)
