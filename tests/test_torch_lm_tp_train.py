"""Tensor-parallel training (`make_train_step(mesh=, dp_over_model=False)`)
in this process (the CPU): the plan, a one-rank gloo layout against one
device, and each differentiable collective of `models.tp`.

1. The two-cut leaf plan of all ten configs at full width on 2 x 2,
   16 x 16 and 2 x 16 x 16 (`shape_layout`): every leaf's fsdp-cut dim and
   axes and its model-cut dim are `rules.param_spec`'s, its gradient is
   summed over the fsdp axes that do not cut it and never over model, the
   DP posture's plan is the same fsdp cut with model among the summed
   axes, and a spec whose cuts the plan cannot hold is refused.
2. A one-rank gloo layout: all ten reduced configs, two tensor-parallel
   steps with remat in float32 from one state, equal bits with the
   single-device step in the loss, the grad norm, every gradient leaf and
   every leaf of params, mu, nu and master.  Every collective of the
   tensor-parallel code runs as a copy (the census is the one the shapes
   give), and the step leaves the layout it found.  (In bf16 on the CPU
   the row products' float32 partials are the operands widened, whose
   sums the CPU's bf16 GEMM orders otherwise; on the card the float32-output
   GEMM is one device's, and `tests/test_torch_gpu.py` and chip_smoke.py's
   lm_tp_train phase hold the bf16 bits there.)
3. Each `torch.autograd.Function` of `models.tp` and the vocab-parallel
   cross-entropy at one rank against one device's autograd on the whole
   tensor, forward and gradients bit for bit (float32): the gather in both
   backward modes, the sum over the axis, the row and column products,
   `take` of a whole leaf for the rank's part, and the cross-entropy in
   chunks of fewer rows than the batch.
"""
import dataclasses

import pytest
import torch
import torch.distributed as dist

from _torch_lm_tp_train import layer_counts, predicted
from repro_torch import configs
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.launch import mesh, steps
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import tp
from repro_torch.optim import adamw
from repro_torch.sharding import hints, rules
from test_torch_lm_mesh_gloo import GradTap

ARCHS = sorted(configs.ARCHS)
LAYOUTS = {"2x2": (2, 2), "16x16": (16, 16), "2x16x16": (2, 16, 16)}


# ---------------------------------------------------------------------------
# 1. The plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sizes", list(LAYOUTS.values()), ids=list(LAYOUTS))
def test_two_cut_leaf_plan_follows_param_spec(sizes):
    lay = mesh.shape_layout(sizes)
    fsdp = rules.fsdp_axes(lay)
    two_cut = 0
    for arch in ARCHS:
        for k, v in steps.abstract_params(configs.get(arch)).items():
            spec = rules.param_spec(lay, (k,), v)
            plan = steps._leaf_plan(lay, k, v, tensor_parallel=True)
            for d, e in enumerate(spec):
                axes = rules.entry_axes(e)
                if not axes:
                    assert d not in (plan.dim, plan.model_dim), (arch, k)
                elif axes == (rules.MODEL,):
                    assert plan.model_dim == d, (arch, k)
                else:
                    assert (plan.dim, plan.axes) == (d, axes), (arch, k)
            assert plan.rest == tuple(a for a in fsdp if a not in plan.axes), (arch, k)
            assert rules.MODEL not in plan.rest
            model_copies = () if plan.model_dim is not None else (rules.MODEL,)
            assert set(plan.copies) == set(plan.rest) | set(model_copies), (arch, k)
            two_cut += plan.dim is not None and plan.model_dim is not None
            dp = steps._leaf_plan(lay, k, v)
            assert (dp.dim, dp.axes, dp.model_dim) == (plan.dim, plan.axes, None), (arch, k)
            assert dp.rest == dp.copies == tuple(a for a in lay.axes if a not in plan.axes)
    assert two_cut > 0


def test_plan_refuses_a_spec_it_cannot_hold(monkeypatch):
    lay = mesh.shape_layout((2, 2))
    w = torch.empty((4, 4, 4), device="meta")
    monkeypatch.setattr(rules, "param_spec", lambda *a: ("data", "data", None))
    with pytest.raises(ValueError, match="one dim over the fsdp axes"):
        steps._leaf_plan(lay, "w", w, tensor_parallel=True)
    monkeypatch.setattr(rules, "param_spec", lambda *a: (("data", "model"), None, None))
    with pytest.raises(ValueError, match="one dim over the fsdp axes"):
        steps._leaf_plan(lay, "w", w, tensor_parallel=True)


# ---------------------------------------------------------------------------
# 2. A one-rank gloo layout
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path_factory.mktemp('rdv')}/f",
                            rank=0, world_size=1)
    act = L.ACT_DTYPE
    L.ACT_DTYPE = torch.float32
    try:
        yield mesh.make_host_mesh(1, 1)
    finally:
        L.ACT_DTYPE = act
        dist.destroy_process_group()


def bits(t):
    return t.detach().reshape(-1).view(torch.uint8)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_tp_step_equals_single_device_bitwise(one_rank, arch):
    cfg = configs.get(arch).reduced()
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    opt = adamw.OptConfig(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    model = M.init_params(cfg, 0, "cpu").float()
    start = steps.clone_state(steps.init_train_state(model, opt))
    single = steps.make_train_step(cfg, opt, remat=True)
    layout = one_rank.counting()
    step = steps.make_train_step(cfg, opt, remat=True, mesh=layout, dp_over_model=False)
    st, mst = steps.bind(model, steps.clone_state(start)), steps.shard_state(layout, start)
    skeleton = M.LMModel(cfg, None, "meta")
    for i in range(2):
        batch = make_batch(cfg, DataConfig(seed=3), i, 4, 16, "cpu")
        with GradTap() as ts:
            st, ms = single(model, st, batch)
        layout.reset_counts()
        with GradTap() as tm:
            mst, mm = step(skeleton, mst, steps.shard_batch(layout, batch))
        assert hints.get_mesh() is None
        for k in ("loss", "grad_norm", "lr"):
            assert torch.equal(bits(ms[k]), bits(mm[k])), (i, k)
        for k, g in ts.grads[0].items():
            assert torch.equal(bits(g), bits(tm.grads[0][k])), (i, k)
        got = {k: c["calls"] for k, c in layout.counts()["model"].items()
               if k in ("gather", "reduce", "grad_sum", "scatter_sum")}
        assert got == predicted(cfg, (1, 1)), (i, got)
    for part in ("mu", "nu", "master"):
        for k, v in getattr(st.opt, part).items():
            assert torch.equal(bits(v), bits(getattr(mst.opt, part)[k])), (part, k)
    for k, v in st.params.items():
        assert torch.equal(bits(v), bits(mst.params[k])), k


def test_recomputation_runs_under_the_forward_layout_on_another_thread(one_rank):
    """Autograd runs a card's backward on a thread of its own, where the
    layout (per thread, `sharding.hints`) is not installed: remat's
    recomputation installs the one its forward ran under, so it recomputes
    the same tensor-parallel operations (else the saved tensors differ and
    the checkpoint refuses them).  Here the backward runs on another
    thread: the gradients equal one device's, and the layout's backward
    sums ran."""
    import threading
    cfg = configs.get("zamba2-7b").reduced()
    model = M.init_params(cfg, 0, "cpu").float()
    batch = make_batch(cfg, DataConfig(seed=3), 0, 2, 16, "cpu")
    params = list(model.parameters())
    want = torch.autograd.grad(M.loss_fn(model, batch["inputs"], batch["labels"], remat=True),
                               params)
    layout = one_rank.counting()
    with hints.layout(layout):
        loss = M.loss_fn(model, batch["inputs"], batch["labels"], remat=True)
    layout.reset_counts()
    got = {}
    worker = threading.Thread(target=lambda: got.update(grads=torch.autograd.grad(loss, params)))
    worker.start()
    worker.join()
    assert "grads" in got
    for a, b in zip(want, got["grads"]):
        assert torch.equal(bits(a), bits(b))
    assert layout.counts()["model"]["grad_sum"]["calls"] > 0


def test_census_of_a_dense_layer_at_one_rank():
    """The rule the census is written from, for one layer of qwen2 at one
    rank: every leaf whole (no gather), the input gradient of each column
    product summed (q, k, v) and every leaf taken for the rank's part
    summed (wq, bq, wk, wv, bk, bv, wo: whole at one rank), and the MLP's
    two column products and three leaves; two sums in the forward."""
    c = layer_counts(configs.get("qwen2-0.5b").reduced(), 1, "dense")
    assert (c.gather, c.scatter_sum, c.reduce) == (0, 0, 2)
    assert c.grad_sum == 3 + 7 + 5


# ---------------------------------------------------------------------------
# 3. Each Function at one rank against one device's autograd
# ---------------------------------------------------------------------------

def _both(fn_tp, fn_one, *shapes, seed=0):
    """fn_tp and fn_one of the same float32 inputs: the outputs and every
    input's gradient (of a seeded cotangent) bit for bit."""
    gen = torch.Generator().manual_seed(seed)
    xs = [torch.randn(s, generator=gen) for s in shapes]
    outs = []
    for fn in (fn_tp, fn_one):
        ins = [x.clone().requires_grad_(True) for x in xs]
        y = fn(*ins)
        cot = torch.randn(y.shape, generator=torch.Generator().manual_seed(seed + 1))
        grads = torch.autograd.grad(y, ins, cot)
        outs.append((y.detach(), grads))
    (y1, g1), (y2, g2) = outs
    assert torch.equal(bits(y1), bits(y2))
    for a, b in zip(g1, g2):
        assert torch.equal(bits(a), bits(b))


@pytest.mark.parametrize("part", [False, True])
def test_gather_and_take(one_rank, part):
    g = one_rank.group(("model",))
    _both(lambda x: tp.gather(g, x, 1, part) * 2, lambda x: x * 2, (3, 5, 4))
    _both(lambda w: tp.take(g, w, 1, [(1, 3), (4, 5)], 5, part).sin(),
          lambda w: torch.cat([w[:, 1:3], w[:, 4:5]], 1).sin(), (3, 5))


def test_enter_and_reduce(one_rank):
    g = one_rank.group(("model",))
    _both(lambda x: tp.enter(g, x).exp(), lambda x: x.exp(), (4, 6))
    _both(lambda x: tp.reduce(g, x).exp(), lambda x: x.exp(), (4, 6))
    _both(lambda x: tp.enter(g, tp.reduce(g, x.square().sum(-1))).sqrt(),
          lambda x: x.square().sum(-1).sqrt(), (4, 6))


@pytest.mark.parametrize("split", [False, True])
def test_row_and_column_products(one_rank, split):
    g = one_rank.group(("model",))
    _both(lambda x, w: tp.row(g, x, w, [(0, 8)], 8, split), lambda x, w: x @ w, (2, 5, 8), (8, 6))
    _both(lambda x, w: tp.column(g, x, w, split), lambda x, w: x @ w, (2, 5, 8), (8, 6))


def test_vocab_parallel_cross_entropy(one_rank, monkeypatch):
    monkeypatch.setattr(M, "_LOSS_ROWS", 5)                 # chunks of 5 of 12 rows
    g = one_rank.group(("model",))
    labels = torch.randint(0, 7, (3, 4), generator=torch.Generator().manual_seed(2))
    _both(lambda z: M._VocabCrossEntropy.apply(z, labels, g, 0),
          lambda z: M._MeanCrossEntropy.apply(z, labels), (3, 4, 7))
