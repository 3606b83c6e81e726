"""The plain reference against the port at a tiny size on the CPU, where the
port runs its own plain versions: every replica of two update intervals,
from the mix's start state and from the port's state, bit for bit."""
import numpy as np
import pytest
import torch

import _bench_paths  # noqa: F401
from bench.harness import check as ck
from bench.harness import spec, system, traffic as tr
from bench.reference import neurons as nr
from bench.reference import octree as ot
from bench.reference import search as sr
from bench.reference import update as ur

TINY = {"n": 384, "domain": 150.0}
TINY_START = {"sigma": 35.0}
SEED = 2 ** 31 + 17


def _cpu_cell(name):
    c = spec.cell(name)
    return c._replace(config={**c.config, **TINY},
                      traffic={**c.traffic, "start": {**c.traffic["start"], **TINY_START}})


@pytest.mark.parametrize("cell", ["fmm-sweep16-steady", "bh-sweep16-steady"])
def test_every_replica_of_two_intervals_bit_for_bit(cell):
    c = _cpu_cell(cell)
    dev = torch.device("cpu")
    n, every = c.config["n"], c.config["update_interval"]
    pos = tr.positions(SEED, n, c.config["domain"])
    sut = system.build(c.config, c.traffic, pos, dev)
    start = tr.start(c.start.draw, c.traffic, SEED, 1, torch.as_tensor(pos), c.config["domain"])
    assert start.src.shape[0] > 2 * n
    states = system.start_states(sut, start)
    noises = system.noises(sut, SEED, 1)
    ref = ck.Reference(c.config, c.traffic, c.start.draw, pos, dev)
    pre = [None] * sut.num_replicas
    for step0 in (0, every):
        states, recs = system.run(sut, states, every, noises)
        for k in range(sut.num_replicas):
            post = system.capture(states, k)
            it = ck.Interval(episode=1, step0=step0, replica=k, pre=pre[k], post=post,
                             records=system.replica_records(recs, k))
            want = ref.run(SEED, it)
            for f in ck.FIELDS:
                np.testing.assert_array_equal(post.neurons[f],
                                              getattr(want.neurons, f).numpy(), err_msg=f)
            np.testing.assert_array_equal(it.records, ck.records_array(want.records))
            live = want.edges.valid.numpy()
            np.testing.assert_array_equal(post.slots, np.flatnonzero(live))
            np.testing.assert_array_equal(post.src, want.edges.src.numpy()[live])
            np.testing.assert_array_equal(post.dst, want.edges.dst.numpy()[live])
            assert post.dropped == want.dropped == 0
            numbers = ck.compare(ref, SEED, it)
            assert numbers == {k: 0.0 for k in ck.NUMBERS}
            pre[k] = post
    assert int(recs.num_synapses[-1].min()) > 0


def test_m2l_and_pyramid_match_the_port_plain_versions():
    from repro_torch.core import octree as port_octree
    from repro_torch.kernels import m2l_pair
    g = torch.Generator().manual_seed(3)
    moms, herm = torch.randn(300, 64, generator=g), torch.randn(300, 64, generator=g)
    y = torch.randn(300, 3, generator=g)
    assert torch.equal(sr.m2l_separable(moms, herm, y, 4),
                       m2l_pair.m2l_separable_plain(moms, herm, y, 4))

    pos = tr.positions(9, 500, 160.0)
    ax = torch.floor(torch.rand(500, generator=g) * 5)
    den = torch.floor(torch.rand(500, generator=g) * 5)
    tree = ot.build_tree(pos, 160.0, "cpu")
    ptree = port_octree.to_device(port_octree.build_structure(pos, 160.0), torch.device("cpu"))
    mine = ot.pyramid(tree, torch.as_tensor(pos), ax, den, np.float32(600.0) ** 2, 4)
    theirs = port_octree.build_pyramid(ptree, torch.as_tensor(pos), ax, den,
                                       np.float32(600.0) ** 2, 4)
    for a, b in zip(mine, theirs):
        for f in ot.LevelSums._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_fma_emulation_matches_the_port():
    from repro_torch.kernels import msp_update
    g = torch.Generator().manual_seed(4)
    a, b, c = (torch.randn(10000, generator=g) for _ in range(3))
    assert torch.equal(nr.fma_f32(a, b, c), msp_update.fma_f32(a, b, c))


def test_inhibitory_sign_follows_the_traced_count():
    sign = ur.inhibitory_sign(1 << 20, 0.1, "cpu")
    assert int((sign < 0).sum()) == int(np.floor(np.float32(0.1) * np.float32(1 << 20)))
    assert ur.inhibitory_sign(100, 0.0, "cpu") is None
