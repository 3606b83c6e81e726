"""The port's CUDA kernels and main path on the card (marker `gpu`).

Run on a machine with an NVIDIA card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Without a card every test skips (the fixture decides, at run time).  This
file imports neither JAX nor the JAX package, so it runs where only the
port's dependencies are installed.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import trace
from repro_torch.core import synapses
from repro_torch.core.engine import EngineConfig, PlasticityEngine
from repro_torch.core.msp import MSPConfig
from repro_torch.core.noise import GeneratorNoise
from repro_torch.core.traversal import FMMConfig
from repro_torch.kernels import gaussian_nbody as knb, m2l_pair, msp_update as kmsp, ops
from repro_torch.kernels import synaptic_input as ksyn

import _synaptic_tables


KERNELS = ("msp_update", "m2l_separable", "gaussian_nbody", "synaptic_input")


def _launches(fn):
    """fn()'s result, and the CUDA launches of each kernel it made, counted
    by the registry (`repro_torch.trace`) under the profiler, its switch."""
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    got = trace.counts()
    trace.reset()
    return out, {k: got.get(f"kernels.{k}.launches", 0) for k in KERNELS}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False   # the plain m2l's einsums
    return torch.device("cuda")


def _msp_inputs(n, seed, dev):
    rng = np.random.default_rng(seed)
    arrays = (rng.uniform(0, 0.2, n).astype(np.float32), rng.integers(0, 5, n).astype(np.int32),
              rng.uniform(0, 1, n).astype(np.float32), rng.integers(0, 4, n).astype(np.float32),
              rng.uniform(0, 1, n).astype(np.float32))
    return [torch.from_numpy(a).to(dev) for a in arrays]


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 1000, 1 << 20])
def test_msp_update_kernel_bitwise_vs_plain(cuda_device, n):
    k = kmsp.constants(MSPConfig.calibrated(speedup=100.0))
    args = _msp_inputs(n, n, cuda_device)
    got = kmsp.msp_update_cuda(*args, k)
    want = kmsp.msp_update_plain(*args, k)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 63, 700, 1 << 21])
def test_m2l_kernel_vs_plain(cuda_device, b):
    """max|kernel - plain| <= 1e-5 x max|plain| (the series cancels)."""
    rng = np.random.default_rng(b)
    t = lambda lo, hi, shape: torch.from_numpy(
        rng.uniform(lo, hi, shape).astype(np.float32)).to(cuda_device)
    moms, herm, y = t(0, 1, (b, 64)), t(-1, 1, (b, 64)), t(-1.5, 1.5, (b, 3))
    got = m2l_pair.m2l_separable_cuda(moms, herm, y)
    want = m2l_pair.m2l_separable_plain(moms, herm, y)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.gpu
def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    k = kmsp.constants(MSPConfig())
    args = _msp_inputs(8, 0, cuda_device)
    with pytest.raises(ValueError):
        kmsp.msp_update_cuda(args[0].double(), *args[1:], k)
    z = torch.zeros((4, 64), device=cuda_device)
    with pytest.raises(ValueError):
        m2l_pair.m2l_separable_cuda(z[:, :32], z[:, :32], torch.zeros((4, 3), device=cuda_device))
    with pytest.raises(ValueError):
        m2l_pair.m2l_separable_cuda(z, z, torch.zeros((4, 3), device=cuda_device), p=3)


@pytest.mark.gpu
@pytest.mark.parametrize("n,m", [(1, 1), (7, 513), (255, 1025), (300, 1000), (1024, 128),
                                 (4097, 3001)])
def test_gaussian_nbody_kernel_vs_plain(cuda_device, n, m):
    """rtol 2e-5, atol 1e-6, as the Pallas kernel is held to its oracle."""
    rng = np.random.default_rng(n + m)
    t = lambda hi, shape: torch.from_numpy(
        rng.uniform(0, hi, shape).astype(np.float32)).to(cuda_device)
    tgt, src, w = t(3000, (n, 3)), t(3000, (m, 3)), t(5, (m,))
    got, launches = _launches(lambda: ops.gaussian_nbody(tgt, src, w, 750.0 ** 2))
    want = knb.gaussian_nbody_plain(tgt, src, w, 750.0 ** 2)
    torch.cuda.synchronize()
    assert launches["gaussian_nbody"] == 1
    torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-6)


@pytest.mark.gpu
def test_gaussian_nbody_at_a_million_sources_vs_float64(cuda_device):
    rng = np.random.default_rng(0)
    pos = torch.from_numpy(rng.uniform(0, 2190, (1 << 20, 3)).astype(np.float32)).to(cuda_device)
    w = torch.from_numpy(rng.integers(0, 6, 1 << 20).astype(np.float32)).to(cuda_device)
    tgt = pos[::1024].contiguous()
    got = knb.gaussian_nbody_cuda(tgt, pos, w, 750.0 ** 2)
    want = knb.gaussian_nbody_plain(tgt.double(), pos.double(), w.double(), 750.0 ** 2)
    torch.testing.assert_close(got, want.float(), rtol=2e-5, atol=1e-6)


@pytest.mark.gpu
def test_gaussian_nbody_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    z = torch.zeros((8, 3), device=cuda_device)
    w = torch.zeros((8,), device=cuda_device)
    with pytest.raises(ValueError):
        knb.gaussian_nbody_cuda(z.double(), z, w, 1.0)
    with pytest.raises(ValueError):
        knb.gaussian_nbody_cuda(z, z.T.contiguous().T, w, 1.0)
    with pytest.raises(ValueError):
        knb.gaussian_nbody_cuda(z, z, w[:4], 1.0)


def _on(dev, edges, spiked, sign, offsets=(0, 0, 0)):
    """The case's tensors on dev; offsets: each table array (src, dst,
    valid) laid out from that many elements into a buffer of its own, so
    its first slot sits off the allocator's alignment."""
    parts = []
    for a, off in zip(edges, offsets):
        t = torch.from_numpy(a)
        buf = torch.empty((t.numel() + off,), dtype=t.dtype, device=dev)
        view = buf[off:].view(t.shape)
        view.copy_(t)
        parts.append(view)
    to = lambda a: None if a is None else torch.from_numpy(a).to(dev)
    return synapses.SynapseState(*parts), to(spiked), to(sign)


SYN_N = 1 << 16
SYN_CASES = {
    # name: (tables(...) arguments, offsets of src, dst, valid)
    "one_table": (dict(lead=(), n=SYN_N, e=64 * SYN_N), (0, 0, 0)),
    "four_tables": (dict(lead=(4,), n=SYN_N, e=64 * SYN_N), (0, 0, 0)),
    "four_ragged_tables": (dict(lead=(4,), n=SYN_N, e=64 * SYN_N + 7), (0, 0, 0)),
    # One rank's range of a table: its first slot 1029 slots in, 16 k + 7 long.
    "misaligned_range": (dict(lead=(), n=SYN_N, e=16 * SYN_N + 7), (1029, 1029, 1029)),
    "four_misaligned_tables": (dict(lead=(4,), n=SYN_N, e=64 * SYN_N), (3, 3, 3)),
    # Flags and ids that never share their 16-byte alignment: scalar slots only.
    "unaligned_ids": (dict(lead=(2,), n=SYN_N, e=64 * SYN_N), (5, 0, 3)),
    # 2^21 + 5 neurons a row: 256 KB of bits, more than a block's shared memory.
    "bits_beyond_shared_memory": (dict(lead=(2,), n=(1 << 21) + 5, e=1 << 18), (0, 0, 0)),
    # Spikes and signs as views with strides (the distributed ensemble
    # gathers its spikes along dim 1).
    "strided_spikes": (dict(lead=(4,), n=SYN_N, e=64 * SYN_N), (0, 0, 0)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("case", sorted(SYN_CASES))
def test_synaptic_input_kernel_bitwise_vs_plain(cuda_device, case, signed):
    """The kernel (through `synapses.synaptic_input` on the card, one launch)
    equals the plain version on the CPU bit for bit: tables 48 % live in
    their lower half, randomly holed, 1.4 % of neurons spiking."""
    kw, offsets = SYN_CASES[case]
    src, dst, valid, spiked, sign = _synaptic_tables.tables(
        len(case) + signed, spiking=0.014, signed=signed, **kw)
    edges, sp, sg = _on(cuda_device, (src, dst, valid), spiked, sign, offsets)
    if case == "strided_spikes":
        sp = sp.T.contiguous().T
        sg = None if sg is None else sg.T.contiguous().T
        assert not sp.is_contiguous()
    got, launches = _launches(lambda: synapses.synaptic_input(edges, sp, sg))
    cpu = _on(torch.device("cpu"), (src, dst, valid), spiked, sign)
    want = synapses.synaptic_input(*cpu)
    torch.cuda.synchronize()
    assert launches["synaptic_input"] == 1
    assert int(want.abs().sum()) > 0
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_synaptic_input_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    src, dst, valid, spiked, sign = _synaptic_tables.tables(0, (2,), 64, 256, signed=True)
    edges, sp, sg = _on(cuda_device, (src, dst, valid), spiked, sign)
    run = lambda e=edges, s=sp, g=sg: ksyn.synaptic_input_cuda(*e, s, g)
    for bad in (dict(e=edges._replace(src=edges.src.long())),
                dict(e=synapses.SynapseState(*(f[:, :255] for f in edges))),
                dict(s=sp[:1]), dict(s=sp.int()), dict(g=sg[:, :63]), dict(g=sg.double()),
                dict(e=synapses.SynapseState(*(f.cpu() for f in edges)))):
        with pytest.raises(ValueError):
            run(**bad)
    with pytest.raises(ValueError):
        ksyn.synaptic_input_cuda(*(f.cpu() for f in edges), sp.cpu(), None)
    empty = synapses.SynapseState(*(f[:, :0] for f in edges))
    assert torch.equal(ksyn.synaptic_input_cuda(*empty, sp, sg), torch.zeros_like(sg))


class _CpuDraws:
    """GeneratorNoise drawn on the CPU and moved to the card, so the card's
    run and the CPU's run see the same numbers."""

    def __init__(self, seed, device):
        self.inner, self.device = GeneratorNoise(seed, torch.device("cpu")), device

    def __getattr__(self, name):
        fn = getattr(self.inner, name)
        return lambda *a: fn(*a).to(self.device)


@pytest.mark.gpu
def test_main_path_on_card_equals_plain_versions_on_cpu(cuda_device):
    """N = 256, 300 steps from a mid-growth state with the same draws: the
    card (kernels) and the CPU (plain versions) give the same run, and the
    card's run went through both kernels."""
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, 1000.0, (256, 3)).astype(np.float32)
    init = rng.uniform((0.4, 0, 0), (0.7, 6, 6), (256, 3)).astype(np.float32).T.copy()
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        eng = PlasticityEngine(pos, MSPConfig.calibrated(speedup=100.0),
                               FMMConfig(c1=8, c2=8), EngineConfig(), device=dev)
        st = eng.init_state()
        c = torch.from_numpy(init).to(dev)
        st = st._replace(neurons=st.neurons._replace(calcium=c[0], ax_elems=c[1],
                                                     den_elems=c[2]))
        out[dev.type] = _launches(lambda: eng.simulate(st, 300, noise=_CpuDraws(1, dev)))
    (sg, rg), launches = out["cuda"]
    (sc, rc), _ = out["cpu"]
    assert launches["msp_update"] == 300 and launches["m2l_separable"] > 0
    assert launches["synaptic_input"] == 300
    assert int(rc.num_synapses[-1]) > 0
    assert torch.equal(rg.num_synapses.cpu(), rc.num_synapses)
    assert torch.equal(rg.spike_rate.cpu(), rc.spike_rate)
    for f in ("src", "dst", "valid"):
        assert torch.equal(getattr(sg.edges, f).cpu(), getattr(sc.edges, f))
    assert torch.equal(sg.neurons.calcium.cpu(), sc.neurons.calcium)


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["barnes_hut", "direct"])
def test_other_methods_on_card_equal_plain_versions_on_cpu(cuda_device, method):
    """As above for the Barnes-Hut and direct searches, which launch
    msp_update every step and neither of the other kernels."""
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, 1000.0, (256, 3)).astype(np.float32)
    init = rng.uniform((0.4, 0, 0), (0.7, 6, 6), (256, 3)).astype(np.float32).T.copy()
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        eng = PlasticityEngine(pos, MSPConfig.calibrated(speedup=100.0),
                               FMMConfig(c1=8, c2=8), EngineConfig(method=method), device=dev)
        st = eng.init_state()
        c = torch.from_numpy(init).to(dev)
        st = st._replace(neurons=st.neurons._replace(calcium=c[0], ax_elems=c[1],
                                                     den_elems=c[2]))
        out[dev.type] = _launches(lambda: eng.simulate(st, 300, noise=_CpuDraws(1, dev)))
    (sg, rg), launches = out["cuda"]
    (sc, rc), _ = out["cpu"]
    assert launches == {"msp_update": 300, "m2l_separable": 0, "gaussian_nbody": 0,
                        "synaptic_input": 300}
    assert int(rc.num_synapses[-1]) > 0
    assert torch.equal(rg.num_synapses.cpu(), rc.num_synapses)
    assert torch.equal(rg.spike_rate.cpu(), rc.spike_rate)
    for f in ("src", "dst", "valid"):
        assert torch.equal(getattr(sg.edges, f).cpu(), getattr(sc.edges, f))
    assert torch.equal(sg.neurons.calcium.cpu(), sc.neurons.calcium)


@pytest.mark.gpu
def test_dendrite_pyramid_on_card_equals_the_full_pyramids_dendrite_sums(cuda_device):
    """At 2^20 neurons on the card, Barnes-Hut's pyramid holds bit for bit
    the den_w and den_c of the FMM's full pyramid."""
    from repro_torch.core import octree
    n, domain = 1 << 20, 2190.0
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, domain, (n, 3)).astype(np.float32)
    tree = octree.to_device(octree.build_structure(pos, domain), cuda_device)
    t = lambda a: torch.from_numpy(a).to(cuda_device)
    ax = t(rng.integers(0, 6, n).astype(np.float32))
    den = t(rng.integers(0, 6, n).astype(np.float32))
    full = octree.build_pyramid(tree, t(pos), ax, den, FMMConfig().delta)
    got = octree.build_dendrite_pyramid(tree, t(pos), den)
    for lv, fl in zip(got, full):
        assert torch.equal(lv.den_w, fl.den_w)
        assert torch.equal(lv.den_c, fl.den_c)


@pytest.mark.gpu
def test_batched_msp_update_equals_per_replica_launches(cuda_device):
    """The ensemble's one launch over a (K*n,) view of (K, n) state equals
    its plain version on the same input and K launches over the replicas'
    rows, bit for bit (n = 2^20, K = 4)."""
    k, n = 4, 1 << 20
    consts = kmsp.constants(MSPConfig.calibrated(speedup=100.0))
    rows = [_msp_inputs(n, 100 + r, cuda_device) for r in range(k)]
    batched = [torch.stack(ts).reshape(-1) for ts in zip(*rows)]     # (K*n,) each
    got = kmsp.msp_update_cuda(*batched, consts)
    for g, w in zip(got, kmsp.msp_update_plain(*batched, consts)):
        assert torch.equal(g, w)
    for r in range(k):
        want = kmsp.msp_update_cuda(*rows[r], consts)
        for g, w in zip(got, want):
            assert torch.equal(g.reshape(k, n)[r], w)


@pytest.mark.gpu
def test_m2m_pyramid_on_card_equals_cpu(cuda_device):
    """build_pyramid_m2m on the card against the CPU (n = 2^16, depth 5):
    counts exactly, the rest to rtol 1e-5 plus 1e-5 x each array's max; and
    Barnes-Hut's m2m pyramid holds its den_w and den_c bit for bit."""
    from repro_torch.core import octree
    n, domain = 1 << 16, 1000.0
    rng = np.random.default_rng(1)
    pos = rng.uniform(0, domain, (n, 3)).astype(np.float32)
    ax = rng.integers(0, 6, n).astype(np.float32)
    den = rng.integers(0, 6, n).astype(np.float32)
    structure = octree.build_structure(pos, domain)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        t = lambda a: torch.from_numpy(a).to(dev)
        tree = octree.to_device(structure, dev)
        out[dev.type] = (octree.build_pyramid_m2m(tree, t(pos), t(ax), t(den), FMMConfig().delta),
                         octree.build_dendrite_pyramid_m2m(tree, t(pos), t(den)))
    (card, card_bh), (cpu, _) = out["cuda"], out["cpu"]
    for lg, lc, lb in zip(card, cpu, card_bh):
        assert torch.equal(lg.den_w.cpu(), lc.den_w) and torch.equal(lg.ax_w.cpu(), lc.ax_w)
        for f in ("den_c", "ax_c", "herm", "moms"):
            a, b = getattr(lg, f).cpu(), getattr(lc, f)
            assert bool(((a - b).abs() <= 1e-5 * b.abs() + 1e-5 * b.abs().max()).all()), f
        assert torch.equal(lb.den_w, lg.den_w) and torch.equal(lb.den_c, lg.den_c)


def _serve(device, pool=64):
    """Pinned traffic (the CPU tests' scenario) through the service on
    `device`: the event log and every session's result."""
    import tempfile

    from repro_torch.core.probes import CalciumProbe, ProbeSet, SpikeRasterProbe
    from repro_torch.launch.serve import build_service, default_traffic, replay_traffic
    traffic = default_traffic(seed=6, num_sessions=8, pool_size=pool, round_steps=100,
                              max_rounds_of_work=3)
    with tempfile.TemporaryDirectory() as tmp:
        pset = ProbeSet([SpikeRasterProbe(), CalciumProbe()], chunk_size=300)
        svc = build_service(pool, num_slots=4, round_steps=100, speedup=400.0, seed=42,
                            checkpoint_dir=tmp, probes=pset, device=device)
        events = replay_traffic(svc, traffic)
        results = {req.session_id: svc.result(req.session_id) for _, req in traffic}
        svc.close()
    return events, results


@pytest.mark.gpu
def test_served_traffic_on_card_equals_cpu(cuda_device):
    """Every session of the served traffic: the card (kernels) and the CPU
    (plain versions) give the same records, final state and probe rows, bit
    for bit; the card's run went through msp_update and synaptic_input, once
    a round each."""
    (card_events, card), launches = _launches(lambda: _serve(cuda_device))
    assert launches["msp_update"] > 0
    assert launches["synaptic_input"] == launches["msp_update"]
    cpu_events, cpu = _serve("cpu")
    assert card_events == cpu_events and any(e.startswith("restored") for e in cpu_events)
    for sid, want in cpu.items():
        got = card[sid]
        for f, a, b in zip(want.records._fields, got.records, want.records):
            assert torch.equal(a, b), f"{sid}: records.{f}"
        for part in ("neurons", "edges"):
            for f, a, b in zip(getattr(want.final_state, part)._fields,
                               getattr(got.final_state, part), getattr(want.final_state, part)):
                assert torch.equal(a, b), f"{sid}: {part}.{f}"
        assert (got.probe_rows is None) == (want.probe_rows is None)
        for name, rows in (want.probe_rows or {}).items():
            assert torch.equal(got.probe_rows[name], rows), f"{sid}: probe {name}"


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["llama4-maverick-400b-a17b", "deepseek-v2-lite-16b",
                                  "chameleon-34b", "yi-6b", "qwen2-0.5b", "qwen3-8b",
                                  "internlm2-1.8b", "zamba2-7b", "hubert-xlarge", "mamba2-1.3b"])
def test_lm_reduced_on_card_equals_cpu(cuda_device, name):
    """The LM serving path at reduced width: prefill and 3 decode steps (the
    encode step for the encoder) on the card and the CPU from the same
    weights, logits within 0.25 and 0.02 on average (bf16 products summed in
    another order); MoE at capacity_factor 8 (no overflow); and no launch of
    the three FMM kernels."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.launch import lm_serve, steps
    from repro_torch.models import model as M
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = dataclasses.replace(configs.get(name).reduced(), capacity_factor=8.0)
    card = M.init_params(cfg, 0, cuda_device)
    cpu = M.LMModel(cfg, None, "cpu")
    cpu.load_state_dict(card.state_dict())
    gen = torch.Generator().manual_seed(1)
    if cfg.is_encoder:
        x = torch.randn((2, 19, cfg.frontend_dim), generator=gen)
        encode = steps.make_prefill_step(cfg)
        got, launches = _launches(lambda: [encode(card, {"inputs": x.to(cuda_device)})])
        want = [encode(cpu, {"inputs": x})]
    else:
        toks = torch.randint(0, cfg.vocab_size, (2, 19), generator=gen, dtype=torch.int32)
        got, launches = _launches(lambda: lm_serve.score(card, toks.to(cuda_device), 16))
        want = lm_serve.score(cpu, toks, 16)
    for g, w in zip(got, want, strict=True):
        d = (g.cpu() - w).abs()
        assert torch.isfinite(g).all() and float(d.max()) <= 0.25 and float(d.mean()) <= 0.02
    assert not any(launches.values())


@pytest.mark.gpu
def test_moe_dispatch_on_card_equals_cpu(cuda_device):
    """The integer dispatch with overflowing experts, exactly."""
    from repro_torch.models import moe
    expert = torch.randint(0, 4, (2, 64, 6), generator=torch.Generator().manual_seed(0))
    got, want = moe.dispatch(expert.to(cuda_device), 64, 8), moe.dispatch(expert, 64, 8)
    assert not bool(want.keep.all())
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def _train_cfg(name):
    import dataclasses
    from repro_torch import configs
    return dataclasses.replace(configs.get(name).reduced(), capacity_factor=8.0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "qwen2-0.5b", "zamba2-7b",
                                  "hubert-xlarge"])
def test_lm_train_step_on_card_equals_cpu(cuda_device, name):
    """One train step at reduced width from the same parameters and batch on
    the card and the CPU: the loss within 0.05 and the grad norm within 5 %,
    the new master weights within 2 lr (an AdamW step is ~ lr sign(g)), and
    within 1e-6 relative where |g| (read from mu = (1 - b1) g) exceeds 5 %
    of its leaf's largest (floor 1e-6 of the largest leaf's), where the
    tolerance cannot flip the step's sign; and no launch of the three FMM
    kernels."""
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg, opt_cfg = _train_cfg(name), adamw.OptConfig(warmup_steps=2, total_steps=10)
    card = M.init_params(cfg, 0, cuda_device)
    cpu = M.LMModel(cfg, None, "cpu")
    cpu.load_state_dict(card.state_dict())
    batch = make_batch(cfg, DataConfig(seed=1), 0, 2, 16, "cpu")
    step = steps.make_train_step(cfg, opt_cfg)
    (sg, mg), launches = _launches(lambda: step(
        card, steps.init_train_state(card, opt_cfg),
        {k: v.to(cuda_device) for k, v in batch.items()}))
    sw, mw = step(cpu, steps.init_train_state(cpu, opt_cfg), batch)
    assert abs(float(mg["loss"]) - float(mw["loss"])) <= 0.05
    assert abs(float(mg["grad_norm"]) - float(mw["grad_norm"])) <= 0.05 * float(mw["grad_norm"])
    lr = float(mw["lr"])
    top = max(float(m.abs().max()) for m in sw.opt.mu.values())
    for k, w in sw.opt.master.items():
        d, mu = (sg.opt.master[k].cpu() - w).abs(), sw.opt.mu[k].abs()
        assert float(d.max()) <= 2 * lr * 1.001, k
        sure = mu > 0.05 * max(float(mu.max()), 1e-6 * top)
        assert bool((d[sure] <= 1e-6 * w[sure].abs() + 1e-9).all()), k
    assert not any(launches.values())


@pytest.mark.gpu
def test_lm_embedding_backward_same_bits_twice_on_card(cuda_device):
    """qwen2-0.5b's table (151,936 x 896, bf16) at 4 x 4096 Markov tokens,
    which repeat: the gradient of `layers.embed` (indexing, whose backward
    sorts the tokens before it sums their rows) has equal bits twice."""
    from repro_torch import configs
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.models import layers
    cfg = configs.get("qwen2-0.5b")
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    table = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen, device=cuda_device
                        ).to(torch.bfloat16).requires_grad_()
    tokens = make_batch(cfg, DataConfig(seed=0), 0, 4, 4096, cuda_device)["inputs"]
    g = torch.randn((4, 4096, cfg.d_model), generator=gen, device=cuda_device
                    ).to(torch.bfloat16)
    a, b = (torch.autograd.grad(layers.embed(table, tokens), table, g)[0] for _ in range(2))
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
def test_flash_backward_on_card_vs_float64(cuda_device, causal):
    """The flash backward in bf16 (GQA, and Dq != Dv) within 2e-2 of max |g|
    of a float64 naive attention's autograd on the same values."""
    from repro_torch.models.attention import flash_attention
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for h, kv, dq, dv in ((14, 2, 64, 64), (4, 4, 192, 128)):
        shapes = ((1, 512, h, dq), (1, 512, kv, dq), (1, 512, kv, dv), (1, 512, h, dv))
        q, k, v, do = (torch.randn(s, generator=gen, device=cuda_device).to(torch.bfloat16)
                       for s in shapes)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        got = torch.autograd.grad(flash_attention(*leaves, causal, 0, 128, 128), leaves, do)
        leaves = [t.double().requires_grad_() for t in (q, k, v)]
        g = h // kv
        kk, vv = (t.repeat_interleave(g, dim=2) for t in leaves[1:])
        sc = torch.einsum('bthd,bshd->bhts', leaves[0], kk) * dq ** -0.5
        if causal:
            sc = sc.masked_fill(torch.ones(512, 512, dtype=torch.bool,
                                           device=cuda_device).triu(1), float("-inf"))
        o = torch.einsum('bhts,bshd->bthd', torch.softmax(sc, -1), vv)
        want = torch.autograd.grad(o, leaves, do.double())
        for a, b in zip(got, want):
            assert float((a.double() - b).abs().max()) <= 2e-2 * float(b.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "qwen2-0.5b", "zamba2-7b"])
def test_lm_train_steps_on_card_are_deterministic(cuda_device, name):
    """Three steps twice from one state: equal bits (the embedding and MoE
    backwards sum in a fixed order, not by atomics)."""
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    cfg, opt_cfg = _train_cfg(name), adamw.OptConfig(warmup_steps=1, total_steps=10)
    model = M.init_params(cfg, 0, cuda_device)
    start = steps.clone_state(steps.init_train_state(model, opt_cfg))
    ends = []
    for _ in range(2):
        st = steps.bind(model, steps.clone_state(start))
        for i in range(3):
            st, _ = steps.make_train_step(cfg, opt_cfg)(
                model, st, make_batch(cfg, DataConfig(seed=2), i, 4, 64, cuda_device))
        ends.append(steps.clone_state(st))
    for k in ends[0].params:
        for part in ("params", "mu", "nu", "master"):
            a = ends[0].params if part == "params" else getattr(ends[0].opt, part)
            b = ends[1].params if part == "params" else getattr(ends[1].opt, part)
            assert torch.equal(a[k].view(torch.uint8), b[k].view(torch.uint8)), (part, k)


@pytest.mark.gpu
def test_lm_fsdp_step_on_a_one_rank_nccl_layout_equals_single_device(cuda_device, tmp_path):
    """The FSDP step (`make_train_step(mesh=)`) on a 1 x 1 NCCL layout against
    the single-device step, two steps of reduced qwen2-0.5b in bf16 from one
    state and batch: equal bits in the loss, the grad norm, every gradient
    leaf (taken as the step hands it to AdamW) and every leaf of params, mu,
    nu and master; one gather per unit went through NCCL."""
    import torch.distributed as dist
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch import mesh, steps
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    cfg, opt_cfg = _train_cfg("qwen2-0.5b"), adamw.OptConfig(warmup_steps=2, total_steps=10)
    taps, update = [], adamw.update

    def tapped(grads, *args, **kwargs):
        taps.append({k: v.clone() for k, v in grads.items()})
        return update(grads, *args, **kwargs)

    layout = mesh.make_host_mesh(1, 1, f"file://{tmp_path}/rendezvous", 0, cuda_device)
    try:
        layout = layout.counting()
        model = M.init_params(cfg, 0, cuda_device)
        start = steps.clone_state(steps.init_train_state(model, opt_cfg))
        single = steps.make_train_step(cfg, opt_cfg)
        fsdp = steps.make_train_step(cfg, opt_cfg, mesh=layout, dp_over_model=True)
        st, mst = steps.bind(model, steps.clone_state(start)), steps.shard_state(layout, start)
        skeleton = M.LMModel(cfg, None, "meta")
        adamw.update = tapped
        for i in range(2):
            batch = make_batch(cfg, DataConfig(seed=2), i, 4, 64, cuda_device)
            st, ms = single(model, st, batch)
            layout.reset_counts()
            mst, mm = fsdp(skeleton, mst, steps.shard_batch(layout, batch, True))
            for k in ("loss", "grad_norm", "lr"):
                assert torch.equal(ms[k], mm[k]), (i, k)
            want, got = taps[-2:]
            for k, g in want.items():
                assert torch.equal(g.view(torch.uint8), got[k].view(torch.uint8)), (i, k)
            assert layout.counts()["data"]["gather"]["calls"] == 2 + 2 * cfg.num_layers
        for part in ("params", "mu", "nu", "master"):
            a = st.params if part == "params" else getattr(st.opt, part)
            b = mst.params if part == "params" else getattr(mst.opt, part)
            for k in a:
                assert torch.equal(a[k].detach().view(torch.uint8),
                                   b[k].detach().view(torch.uint8)), (part, k)
    finally:
        adamw.update = update
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 1024, 2048), (8, 1, 10944)])
def test_tp_partial_product_rounds_as_one_device_matmul(cuda_device, shape):
    """A row-cut product's float32 partial (`models.tp.partial`, the bf16
    GEMM with a float32 output), rounded to bf16, has the bits of one
    device's bf16 matmul: at one rank the layout's sum is a copy, so the
    tensor-parallel product equals the single-device one."""
    from repro_torch.models import tp
    b, t, k = shape
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((b, t, k), generator=gen, device=cuda_device).bfloat16()
    w = (torch.randn((k, 2048), generator=gen, device=cuda_device) / k ** 0.5).bfloat16()
    got = tp.partial(x, w)
    assert got.dtype == torch.float32 and got.shape == (b, t, 2048)
    assert torch.equal(got.bfloat16(), x @ w)


@pytest.mark.gpu
def test_lm_serving_on_a_one_rank_nccl_layout(cuda_device, tmp_path):
    """Reduced deepseek-v2-lite-16b and zamba2-7b in bf16 served through the
    layout's steps on a 1 x 1 NCCL layout against one device: the same
    greedy tokens, and every collective of the tensor-parallel code ran."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.launch import lm_serve, mesh, steps
    from repro_torch.models import model as M
    layout = mesh.make_host_mesh(1, 1, f"file://{tmp_path}/rendezvous", 0, cuda_device)
    try:
        layout = layout.counting()
        for name in ("deepseek-v2-lite-16b", "zamba2-7b"):
            cfg = configs.get(name).reduced()
            model = M.init_params(cfg, 0, cuda_device)
            prompts = torch.randint(0, cfg.vocab_size, (4, 16), device=cuda_device,
                                    generator=torch.Generator(device=cuda_device).manual_seed(1),
                                    dtype=torch.int32)
            want = lm_serve.generate(model, prompts, 8).tokens
            layout.reset_counts()
            got = lm_serve.generate(steps.shard_params(layout, cfg, model), prompts, 8,
                                    mesh=layout).tokens
            assert torch.equal(got, want), name
            assert layout.counts()["model"]["reduce"]["calls"] > 0
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 1024, 896, 128), (2, 1024, 4864, 896)])
def test_tp_row_and_column_backward_bits_on_card(cuda_device, tmp_path, shape):
    """The tensor-parallel products of `models.tp` on a one-rank NCCL model
    axis, in bf16: the row product (float32 partials summed, rounded once)
    and the column product (its input gradient the float32-output GEMM,
    summed, rounded once) give one device's x @ w forward and its
    `MmBackward` gradients bit for bit."""
    import torch.distributed as dist
    from repro_torch.launch import mesh
    from repro_torch.models import tp
    b, t, k, n = shape
    layout = mesh.make_host_mesh(1, 1, f"file://{tmp_path}/rendezvous", 0, cuda_device)
    try:
        g = layout.group(("model",))
        gen = torch.Generator(device=cuda_device).manual_seed(0)
        x0 = torch.randn((b, t, k), generator=gen, device=cuda_device).bfloat16()
        w0 = (torch.randn((k, n), generator=gen, device=cuda_device) / k ** 0.5).bfloat16()
        cot = torch.randn((b, t, n), generator=gen, device=cuda_device).bfloat16()
        for name, fn in (("row", lambda x, w: tp.row(g, x, w, [(0, k)], k, True)),
                         ("column", lambda x, w: tp.column(g, x, w, True))):
            outs = []
            for f in (fn, lambda x, w: x @ w):
                x, w = x0.clone().requires_grad_(True), w0.clone().requires_grad_(True)
                y = f(x, w)
                outs.append((y.detach(),) + torch.autograd.grad(y, (x, w), cot))
            for i, (a, c) in enumerate(zip(*outs)):
                assert torch.equal(a.view(torch.int16), c.view(torch.int16)), (name, i)
    finally:
        dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["qwen2-0.5b", "deepseek-v2-lite-16b", "zamba2-7b"])
def test_lm_tp_step_on_a_one_rank_nccl_layout_equals_single_device(cuda_device, tmp_path,
                                                                     name):
    """The tensor-parallel step (`make_train_step(mesh=, dp_over_model=False)`)
    on a 1 x 1 NCCL layout against the single-device step, two steps of the
    reduced config in bf16 from one state and batch: equal bits in the
    loss, the grad norm, every gradient leaf and every leaf of params, mu,
    nu and master; the sums over the model axis ran through NCCL."""
    import torch.distributed as dist
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.launch import mesh, steps
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    cfg, opt_cfg = _train_cfg(name), adamw.OptConfig(warmup_steps=2, total_steps=10)
    taps, update = [], adamw.update

    def tapped(grads, *args, **kwargs):
        taps.append({k: v.clone() for k, v in grads.items()})
        return update(grads, *args, **kwargs)

    layout = mesh.make_host_mesh(1, 1, f"file://{tmp_path}/rendezvous", 0, cuda_device)
    try:
        layout = layout.counting()
        model = M.init_params(cfg, 0, cuda_device)
        start = steps.clone_state(steps.init_train_state(model, opt_cfg))
        single = steps.make_train_step(cfg, opt_cfg)
        tp_step = steps.make_train_step(cfg, opt_cfg, mesh=layout, dp_over_model=False)
        st, mst = steps.bind(model, steps.clone_state(start)), steps.shard_state(layout, start)
        skeleton = M.LMModel(cfg, None, "meta")
        adamw.update = tapped
        for i in range(2):
            batch = make_batch(cfg, DataConfig(seed=2), i, 4, 64, cuda_device)
            st, ms = single(model, st, batch)
            layout.reset_counts()
            mst, mm = tp_step(skeleton, mst, steps.shard_batch(layout, batch))
            for k in ("loss", "grad_norm", "lr"):
                assert torch.equal(ms[k], mm[k]), (i, k)
            want, got = taps[-2:]
            for k, g in want.items():
                assert torch.equal(g.view(torch.uint8), got[k].view(torch.uint8)), (i, k)
            assert layout.counts()["model"]["grad_sum"]["calls"] > 0
        for part in ("params", "mu", "nu", "master"):
            a = st.params if part == "params" else getattr(st.opt, part)
            b = mst.params if part == "params" else getattr(mst.opt, part)
            for k in a:
                assert torch.equal(a[k].detach().view(torch.uint8),
                                   b[k].detach().view(torch.uint8)), (part, k)
    finally:
        adamw.update = update
        dist.destroy_process_group()


@pytest.mark.gpu
def test_four_ranks_over_nccl_equal_one_card():
    """p = 4 ranks over NCCL, one card each (`run_ranks` puts rank r on card
    r), at n = 2^16 with the routed, sharded switches and counter draws,
    from a start with synapses and elements below the degree (so the
    deletion ranks over the slot ranges): records, spikes and edge tables
    bit for bit the single-device engine's on the sorted positions."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    from repro_torch import convert
    from repro_torch.core.distributed import sorted_positions
    from repro_torch.launch.distributed import Job, run_ranks, same_run
    n, dev = 1 << 16, torch.device("cuda", 0)
    msp_cfg = MSPConfig.calibrated(speedup=100.0)
    fmm_cfg = FMMConfig(sigma=750.0)
    ecfg = EngineConfig(domain=877.0, rng="counter")
    pos = sorted_positions(np.random.default_rng(3).uniform(0, 877.0, (n, 3))
                           .astype(np.float32), ecfg)
    eng = PlasticityEngine(pos, msp_cfg, fmm_cfg, ecfg, dev)
    g = torch.Generator(device=dev).manual_seed(4)
    st = eng.init_state()
    e = 30 * n
    src = torch.randint(0, n, (e,), generator=g, device=dev, dtype=torch.int32)
    dst = torch.randint(0, n, (e,), generator=g, device=dev, dtype=torch.int32)
    st.edges.src[:e], st.edges.dst[:e], st.edges.valid[:e] = src, dst, True
    u = lambda lo, hi: torch.empty(n, device=dev).uniform_(lo, hi, generator=g)
    deg = lambda ids: torch.bincount(ids.long(), minlength=n).float()
    st = st._replace(neurons=st.neurons._replace(
        calcium=u(0.5, 0.9), ax_elems=torch.clamp(deg(src) + u(-2.0, 1.5), min=0),
        den_elems=torch.clamp(deg(dst) + u(-2.0, 3.0), min=0)))
    opts = dict(pyramid_partials="owner_span", find_phase="sharded", pyramid_exchange="routed")
    job = Job(pos, msp_cfg, fmm_cfg, ecfg, opts, 250, seed=6, state=convert.to_numpy(st))
    res, = run_ranks(4, [job], "cuda", 900.0, 300.0)
    want_st, want_recs = eng.simulate(st, 250, seed=6)
    assert same_run(res, want_st, want_recs) == []
    assert int(want_recs.num_synapses[-1]) != e
