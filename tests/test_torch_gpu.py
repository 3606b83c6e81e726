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

from repro_torch.core.engine import EngineConfig, PlasticityEngine
from repro_torch.core.msp import MSPConfig
from repro_torch.core.noise import GeneratorNoise
from repro_torch.core.traversal import FMMConfig
from repro_torch.kernels import m2l_pair, msp_update as kmsp, ops


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
        ops.reset_launches()
        out[dev.type] = eng.simulate(st, 300, noise=_CpuDraws(1, dev)), dict(ops.launches)
    (sg, rg), launches = out["cuda"]
    (sc, rc), _ = out["cpu"]
    assert launches["msp_update"] == 300 and launches["m2l_separable"] > 0
    assert int(rc.num_synapses[-1]) > 0
    assert torch.equal(rg.num_synapses.cpu(), rc.num_synapses)
    assert torch.equal(rg.spike_rate.cpu(), rc.spike_rate)
    for f in ("src", "dst", "valid"):
        assert torch.equal(getattr(sg.edges, f).cpu(), getattr(sc.edges, f))
    assert torch.equal(sg.neurons.calcium.cpu(), sc.neurons.calcium)
