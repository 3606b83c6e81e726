"""Serving over 1 x 2 and 1 x 4 layouts (the model axis alone) in spawned
gloo ranks, in float32, against the single-device steps (as
tests/test_torch_lm_tp_gloo.py does at 2 x 2).  At 1 x 4 the reduced
configs reach the cuts that fall inside a head or across a concatenation:
qwen2-0.5b's 2 KV heads over 4 ranks (wk, wv gathered, KV heads
replicated), Mamba2's in_proj (296 wide) across z | xBC | dt and conv_w
across x | B | C (gathered), and a prompt of 9 tokens that spans three of
the four sequence blocks.  Every config runs with caches of 16 positions
(cut), and three with 15 (whole over the sequence at both sizes).  The two
layouts run at once; each `run_ranks` call has a 120 s wall-clock limit
and a 60 s collective timeout.
"""
import concurrent.futures
import math

import pytest

from _torch_lm_tp import (ARCHS, Case, ServeJob, check_case, check_census, check_meta_census,
                          config, held_caches, held_params, single_device)
from repro_torch.launch.distributed import run_ranks
from repro_torch.models import layers as L

LAYOUTS = {"1x2": (1, 2), "1x4": (1, 4)}
CASES = tuple([Case(a) for a in ARCHS]
              + [Case(a, max_seq=15) for a in ("qwen2-0.5b", "deepseek-v2-lite-16b",
                                               "mamba2-1.3b")])


@pytest.fixture(scope="module")
def runs():
    act = L.ACT_DTYPE
    try:
        with concurrent.futures.ThreadPoolExecutor(len(LAYOUTS)) as pool:
            futs = {k: pool.submit(run_ranks, math.prod(s), [ServeJob(CASES)], "cpu", 120.0,
                                   60.0, None, s) for k, s in LAYOUTS.items()}
            return {k: f.result()[0] for k, f in futs.items()}
    finally:
        L.ACT_DTYPE = act


@pytest.fixture(scope="module")
def refs():
    return {case: single_device(case) for case in CASES}


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_serving_matches_single_device(runs, refs, layout, case):
    check_case(runs[layout][case], refs[case], f"{layout} {case.name}")


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_held_bytes_and_census(runs, layout, case):
    res, cfg, sizes = runs[layout][case], config(case.arch), LAYOUTS[layout]
    for r, h in enumerate(res["held_params"]):
        want = held_params(cfg, sizes, r)
        assert h["tensors"] == want and h["storages"] == want, (r, h, want)
    for r, h in enumerate(res.get("held_caches", [])):
        want = held_caches(cfg, sizes, r, case.batch, case.max_seq)
        assert h["tensors"] == want and h["storages"] == want, (r, h, want)
    check_census(res, cfg, sizes, case)


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.name)
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_census_equals_the_dry_run(runs, layout, case):
    check_meta_census(runs[layout][case], config(case.arch), LAYOUTS[layout], case)
