"""The port's kernel modules against the JAX package.

On the CPU each kernel module runs its plain PyTorch version, held against
the JAX oracle: `msp_update` bit for bit (the spike draw `u < x'` must never
flip), `m2l_separable` to 1e-5 of the batch's largest |series| (the series
cancels, so an elementwise relative tolerance would measure cancellation,
not the port).  tests/test_torch_gpu.py holds the CUDA kernels against the
plain versions on the card.
"""
import dataclasses
from fractions import Fraction

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from torch.profiler import ProfilerActivity, profile

from repro.core import engine as jengine
from repro.core import msp as jmsp
from repro.core import synapses as jsyn
from repro.kernels import ref
from repro_torch import trace
from repro_torch.core import msp, synapses
from repro_torch.kernels import msp_update as kmsp, ops

import _synaptic_tables

CONFIGS = {"paper": msp.MSPConfig.paper(),
           "calibrated": msp.MSPConfig.calibrated(speedup=100.0)}


def _jax_cfg(cfg):
    return jmsp.MSPConfig(**dataclasses.asdict(cfg))


def _msp_inputs(n, seed):
    # The input ranges of tests/test_kernels.py's msp_update tests.
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 0.2, n).astype(np.float32),
            rng.integers(0, 5, n).astype(np.int32),
            rng.uniform(0, 1, n).astype(np.float32),
            rng.integers(0, 4, n).astype(np.float32),
            rng.uniform(0, 1, n).astype(np.float32))


@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
@pytest.mark.parametrize("n", [1, 1000, 1 << 16])
def test_msp_update_plain_bitwise_vs_jitted_ref(n, cfg_name):
    cfg = CONFIGS[cfg_name]
    jc = _jax_cfg(cfg)
    args = _msp_inputs(n, n)
    run = jax.jit(lambda *a: ref.msp_update(
        *a, x0=jc.x0, tau_x=jc.tau_x, background=jc.background, w_syn=jc.w_syn,
        beta_ca=jc.beta_ca, tau_ca=jc.tau_ca, refractory=jc.refractory))
    want = [np.asarray(w) for w in run(*args)]
    got = ops.msp_update(*map(torch.from_numpy, args), cfg)
    for name, g, w in zip(("x", "refrac", "spiked", "calcium"), got, want):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


@pytest.mark.parametrize("cfg_name", sorted(CONFIGS))
def test_step_neurons_matches_jitted_jax(cfg_name):
    cfg = CONFIGS[cfg_name]
    n = 4096
    x, refrac, ca, syn, u = _msp_inputs(n, 7)
    rng = np.random.default_rng(8)
    ax = rng.uniform(0, 6, n).astype(np.float32)
    den = rng.uniform(0, 6, n).astype(np.float32)
    spiked = rng.uniform(size=n) < 0.1
    jstate = jmsp.NeuronState(*map(jnp.asarray, (x, refrac, spiked, ca, ax, den)))
    step = jax.jit(lambda s, syn_in, uu: jmsp.step_neurons(
        s, syn_in, None, _jax_cfg(cfg), u=uu))
    want = step(jstate, jnp.asarray(syn), jnp.asarray(u))
    state = msp.NeuronState(*map(torch.from_numpy, (x, refrac, spiked, ca, ax, den)))
    got = msp.step_neurons(state, torch.from_numpy(syn), cfg, u=torch.from_numpy(u))
    for name in ("x", "refrac", "spiked", "calcium"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    # The growth curve goes through exp, which differs by an ulp between
    # torch and XLA:CPU on some inputs.
    for name in ("ax_elems", "den_elems"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), rtol=1e-5,
                                   err_msg=name)


def test_fma_pattern_inside_jitted_simulate():
    """The rounding the plain version pins is the one of the jitted engine:
    x' and calcium after steps of `PlasticityEngine.simulate` (the scan body,
    with the synaptic input of a populated edge table) equal the plain
    version's bit for bit, given the engine's own spike uniforms."""
    n, steps = 512, 4
    cfg = CONFIGS["calibrated"]
    rng = np.random.default_rng(3)
    pos = rng.uniform(0, 1000.0, (n, 3)).astype(np.float32)
    eng = jengine.PlasticityEngine(pos, _jax_cfg(cfg),
                                   engine_cfg=jengine.EngineConfig())
    st = eng.init_state()
    e = eng.edge_capacity
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    valid = rng.uniform(size=e) < 0.05
    st = st._replace(
        neurons=st.neurons._replace(
            x=jnp.asarray(rng.uniform(0, 0.2, n).astype(np.float32)),
            spiked=jnp.asarray(rng.uniform(size=n) < 0.3),
            calcium=jnp.asarray(rng.uniform(0, 1, n).astype(np.float32))),
        edges=jsyn.SynapseState(jnp.asarray(src), jnp.asarray(dst),
                                jnp.asarray(valid)))
    key = jax.random.key(5)
    for _ in range(steps):
        prev = st
        st, _ = eng.simulate(prev, key, 1)
        kact, _ = jax.random.split(jax.random.fold_in(key, prev.step))
        u = np.asarray(jax.random.uniform(kact, (n,), jnp.float32))
        syn = np.asarray(jsyn.synaptic_input(prev.edges, prev.neurons.spiked))
        got = ops.msp_update(*(torch.from_numpy(np.array(a)) for a in (
            prev.neurons.x, prev.neurons.refrac, prev.neurons.calcium, syn, u)), cfg)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(st.neurons.x))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(st.neurons.spiked))
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(st.neurons.calcium))


def test_fma_emulation_is_correctly_rounded():
    """fma_f32 rounds once: it equals the exact value (as a Python fraction
    would give it) rounded to float32, also on the double-rounding cases
    where plain float64 arithmetic followed by a cast is off by one ulp."""
    rng = np.random.default_rng(0)
    a = rng.uniform(-1, 1, 20000).astype(np.float32)
    b = rng.uniform(-1, 1, 20000).astype(np.float32)
    c = rng.uniform(-1, 1, 20000).astype(np.float32)
    # Two cases where float64 rounding lands exactly on a float32 midpoint
    # while the exact value lies just above it (first) or just below it
    # (second), so that a plain cast rounds the wrong way.
    a2 = np.float32([1 + 2 ** -12, 2 ** -12 * (1 - 2 ** -23)])
    b2 = np.float32([1 + 2 ** -12, 2 ** -12 * (1 + 2 ** -23)])
    c2 = np.float32([2 ** -60, 1 + 4097 * 2 ** -23])
    a, b, c = (np.concatenate(v) for v in ((a, a2), (b, b2), (c, c2)))
    got = kmsp.fma_f32(*map(torch.from_numpy, (a, b, c))).numpy()
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (naive[-2:] != got[-2:]).all()
    for i in list(range(0, 20000, 97)) + [20000, 20001]:
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        lo = np.float32(float(exact))
        cands = [lo, np.nextafter(lo, np.float32(np.inf)),
                 np.nextafter(lo, np.float32(-np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.float32(v).view(np.int32)) & 1))
        assert got[i] == best, (i, a[i], b[i], c[i])


@pytest.mark.parametrize("b", [1, 63, 512, 700])
def test_m2l_plain_vs_ref(b):
    # The input ranges of tests/test_kernels.py's m2l test.
    rng = np.random.default_rng(b)
    moms = rng.uniform(0, 1, (b, 64)).astype(np.float32)
    herm = rng.uniform(-1, 1, (b, 64)).astype(np.float32)
    y = rng.uniform(-1.5, 1.5, (b, 3)).astype(np.float32)
    want = np.asarray(ref.m2l_separable(jnp.asarray(moms), jnp.asarray(herm),
                                        jnp.asarray(y)))
    got = ops.m2l_separable(*map(torch.from_numpy, (moms, herm, y))).numpy()
    assert got.shape == (b,)
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    """Under the profiler (the registry's switch) the plain versions count
    no launch; m2l_separable's pairs count on either path."""
    trace.reset()
    args = _msp_inputs(16, 0)
    with profile(activities=[ProfilerActivity.CPU]):
        ops.msp_update(*map(torch.from_numpy, args), CONFIGS["paper"])
        z = torch.zeros((3, 64))
        ops.m2l_separable(z, z, torch.zeros((3, 3)))
        ops.gaussian_nbody(torch.zeros((5, 3)), torch.ones((7, 3)), torch.ones(7), 1.0)
        edges = synapses.empty(64, torch.device("cpu"))
        ops.synaptic_input(edges._replace(valid=torch.ones(64, dtype=torch.bool)),
                           torch.ones(4, dtype=torch.bool))
    assert trace.counts() == {"kernels.m2l_separable.pairs": 3}
    trace.reset()


def _syn_case(case):
    """(edges, spiked, sign) of one spike-propagation case, as tensors."""
    t = _synaptic_tables.tables
    arrays = {
        "table": lambda: t(1, (), 200, 64 * 200),
        "table_signed": lambda: t(2, (), 200, 64 * 200, signed=True),
        "tables": lambda: t(3, (3,), 150, 64 * 150),
        "tables_signed": lambda: t(4, (3,), 150, 64 * 150, signed=True),
        "empty_table": lambda: t(5, (2,), 50, 0),
        "every_slot_valid": lambda: t(6, (2,), 40, 8 * 40, live=1.0, signed=True),
        # Neuron 0 spikes; the free slots' ids (0, 0) must add nothing.
        "free_slots_at_neuron_0": lambda: t(7, (), 100, 64 * 100, live=0.1, spiking=1.0),
        "ragged_range": lambda: t(8, (), 120, 64 * 120, signed=True),
    }[case]()
    src, dst, valid, spiked, sign = (None if a is None else torch.from_numpy(a)
                                     for a in arrays)
    edges = synapses.SynapseState(src, dst, valid)
    if case == "ragged_range":       # one rank's slot range: 16 k + 7 slots, odd start
        edges = synapses.SynapseState(*(f[1029:1029 + 16 * 150 + 7] for f in edges))
    return edges, spiked, sign


@pytest.mark.parametrize("case", ["table", "table_signed", "tables", "tables_signed",
                                  "empty_table", "every_slot_valid",
                                  "free_slots_at_neuron_0", "ragged_range"])
def test_synaptic_input_plain_cases(case):
    """The plain version (what the CPU runs) against a numpy loop over each
    table row, exactly: every term is +-1."""
    edges, spiked, sign = _syn_case(case)
    want = _synaptic_tables.synaptic_input(
        *(f.numpy() for f in edges), spiked.numpy(), None if sign is None else sign.numpy())
    got = synapses.synaptic_input(edges, spiked, sign)
    assert got.dtype == torch.float32 and got.shape == spiked.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "free_slots_at_neuron_0":
        assert int((~edges.valid).sum()) > 0 and bool(spiked[0])
    if case == "every_slot_valid":
        assert bool(edges.valid.all())
