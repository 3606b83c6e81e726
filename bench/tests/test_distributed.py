"""The `distributed` system, its reference and its readers, at a tiny size on
the CPU (gloo ranks; the port runs its plain versions):

* the reference's frozen counter draws equal the port's bit for bit;
* the blocked whole-network reference equals itself run in one block;
* the reference's own Morton sort gives the port's order, and its octree
  built on the device equals `octree.build_tree` of the sorted positions;
* a run of the cell at p = 2 and p = 4 reads `correct`, the bfloat16
  control reads not correct, and ranks whose order differs from the
  reference's fail every interval;
* a rank that loads the JAX package leaves the run without a result;
* the configuration's departures from Table 1 are exactly its `reduced`;
* the five collective readers, by hand on a fixture, and None where the
  program keeps no such range or counter.
"""
import json
import textwrap

import numpy as np
import pytest
import torch

import _bench_paths  # noqa: F401
from bench.harness import check as ck
from bench.harness import links, ranks as rk, spec, traffic as tr
from bench.reference import network as net_ref
from bench.reference import streams as ref_streams
from repro_torch.core import streams

CELL = "fmm-dist4-67m-steady"
SEED = 2 ** 31 + 23
CPU = torch.device("cpu")


def _tiny(p: int, n: int = 4096):
    c = spec.cell(CELL)
    return c._replace(
        config={**c.config, "n": n, "domain": 200.0,
                "distributed": {**c.config["distributed"], "ranks": p}},
        traffic={**c.traffic, "episode_steps": 200,
                 "start": {**c.traffic["start"], "sigma": 40.0}})


def test_counter_draws_are_the_ports_bit_for_bit():
    ids = torch.tensor([0, 1, 7, 2 ** 20 + 3, 2 ** 31 + 9, 2 ** 32 - 1], dtype=torch.int64)
    mine, port = ref_streams.CounterDraws(2 ** 40 + 77), streams.CounterNoise(2 ** 40 + 77, CPU)
    assert torch.equal(mine.spike_uniform(12, ids), port.spike_uniform(12, ids))
    assert torch.equal(mine.delete_bits(12, 1, ids), port.delete_bits(12, 1, ids))
    assert torch.equal(mine.descent_gumbel(12, 3, ids), port.descent_gumbel(12, 3, ids))
    assert torch.equal(mine.leaf_gumbel(12, ids, 9), port.leaf_gumbel(12, ids, 9))
    assert torch.equal(mine.conflict_bits(12, ids), port.conflict_bits(12, ids))


def _reference_interval(c, monkeypatch, small: bool, dtype=torch.float32):
    if small:
        monkeypatch.setattr(net_ref, "SLOTS", 4096)
        monkeypatch.setattr(net_ref, "ELEMENTS", 40000)
        monkeypatch.setattr(net_ref, "ROWS", 700)
    else:
        for name in ("SLOTS", "ELEMENTS", "ROWS"):
            monkeypatch.setattr(net_ref, name, 1 << 40)
    from bench.systems import distributed as sysd
    w = sysd.Window(config=c.config, traffic=c.traffic, root=str(c.root), ranks=2, digests=[],
                    intervals=1, kept=[], act=[], upd=[], setup_s=0.0, peak_bytes=0,
                    profile=None, counts=None, reference={})
    net = sysd.reference_net(w, SEED, CPU)
    it = sysd.Checked(episode=1, step0=0, records=np.zeros((100, 4)), pre=None, post=[])
    nrn, edges = sysd.start(w, SEED, it, net, CPU)
    draws = ref_streams.CounterDraws(tr.noise_seed(SEED, 1, 0))
    if small:
        delete = net_ref.delete_excess
        monkeypatch.setattr(net_ref, "delete_excess",
                            lambda *a, **k: delete(*a, **k, segments=777))
    return net_ref.run_interval(net, nrn, edges, draws, 0, 100, dtype)


def test_blocked_reference_equals_one_block(monkeypatch):
    c = _tiny(2)
    whole = _reference_interval(c, monkeypatch, small=False)
    blocked = _reference_interval(c, monkeypatch, small=True)
    for f in ck.FIELDS:
        assert torch.equal(getattr(whole.neurons, f), getattr(blocked.neurons, f)), f
    for a, b in zip(whole.edges, blocked.edges):
        assert torch.equal(a, b)
    assert np.array_equal(ck.records_array(whole.records), ck.records_array(blocked.records))
    assert int(whole.records[-1].num_synapses) != int(whole.records[0].num_synapses)


def test_reference_sort_is_the_ports_order():
    from repro_torch.core.distributed import sorted_positions
    from repro_torch.core.engine import EngineConfig
    c = _tiny(2, n=1 << 14).config
    pos = tr.positions(SEED, c["n"], c["domain"])
    mine, _ = net_ref.sorted_tree(pos, c["domain"], CPU)
    port = sorted_positions(pos, EngineConfig(domain=c["domain"]))
    assert np.array_equal(mine, port)
    assert rk.digest(mine) == rk.digest(port) != rk.digest(mine[::-1])


@pytest.mark.parametrize("n,domain", [(1 << 14, 200.0), (5000, 123.0), (8, 10.0)])
def test_reference_tree_built_on_the_device_is_build_tree(n, domain):
    from bench.reference import octree as ot
    pos = tr.positions(SEED + n, n, domain)
    sorted_pos, tree = net_ref.sorted_tree(pos, domain, CPU)
    want = ot.build_tree(sorted_pos, domain, "cpu")
    assert (tree.depth, tree.n, tree.max_leaf, tree.domain) == (want.depth, want.n,
                                                                want.max_leaf, want.domain)
    for name in ("order", "leaf_start", "leaf_of"):
        a, b = getattr(tree, name), getattr(want, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    for got, ref in zip(tree.levels, want.levels):
        for name in ref._fields:
            a, b = getattr(got, name), getattr(ref, name)
            assert a.dtype == b.dtype and torch.equal(a, b), name


def test_unpack_inverts_pack():
    from bench.systems import distributed as sysd
    v = torch.rand(8 * 37, generator=torch.Generator().manual_seed(1)) < 0.4
    assert torch.equal(sysd.unpack_bits(rk.pack_bits(v), CPU), v)


@pytest.mark.parametrize("p", [2, 4])
def test_a_run_reads_correct_and_the_control_does_not(p):
    c = _tiny(p)
    sut = spec.system_module("distributed")
    w = sut.measure(c, SEED + p, 0.2, False, "cpu")
    e2e = sut.end_to_end(w)
    assert set(e2e) == {"neuron_steps_per_s", "activity_step_ms", "update_ms", "setup_s"}
    assert all(v > 0 for v in e2e.values())
    assert len(w.kept) == 2 and w.intervals >= 2
    verdict = sut.judge(w, SEED + p, "cpu")
    assert verdict["failed"] == 0 and verdict["checked"] == 2
    assert verdict["worst"] == {k: 0.0 for k in ck.NUMBERS}
    control = sut.compare(w, SEED + p, "cpu", control=True)
    assert all(ck.judge([r], c.config["limits"])["failed"] == 1 for r in control)
    reordered = w._replace(digests=[rk.digest(np.zeros((1, 3), np.float32))] + w.digests[1:],
                           reference={})
    assert sut.judge(reordered, SEED + p, "cpu")["failed"] == 2


def test_a_rank_that_loads_the_jax_package_gives_no_result(tmp_path):
    """Rank 1's start generator plants a module named `repro`; the run
    raises SystemExit once the ranks have exited."""
    (tmp_path / "bench" / "starts").mkdir(parents=True)
    (tmp_path / "bench" / "starts" / "planted.py").write_text(textwrap.dedent(f"""
        import sys, types
        from bench.harness import spec
        _real = spec._module("starts", "network_blocks", spec.Path({str(spec.ROOT)!r}))
        globals().update({{k: v for k, v in vars(_real).items() if not k.startswith("__")}})

        def draw_block(*args):
            if args[-2] == 1:
                sys.modules.setdefault("repro", types.ModuleType("repro"))
            return _real.draw_block(*args)
    """))
    c = _tiny(2)
    c = c._replace(root=tmp_path, traffic={**c.traffic, "start": {**c.traffic["start"],
                                                                   "generator": "planted"}})
    sut = spec.system_module("distributed")
    with pytest.raises(SystemExit, match="repro"):
        sut.measure(c, SEED + 5, 0.2, False, "cpu")


def test_reduced_is_every_departure_from_table_1():
    bm = spec.benchmark()
    entry = next(x for x in bm["configs"] if x["name"] == "msp-fmm-67m")
    cfg = spec.load_json(spec.ROOT / entry["file"])
    table = cfg["paper_table_1"]
    assert sorted(k for k in table if cfg[k] != table[k]) == sorted(entry["reduced"])
    assert cfg["sigma"] == table["sigma"] == 750.0
    assert cfg["n"] == 2 ** 26 and cfg["distributed"]["ranks"] == 4
    assert cfg["engine"]["rng"] == "counter"


# -- the readers ---------------------------------------------------------------------------

def _fixture():
    """Two traced chunks: an activity chunk of 99 steps and an update chunk,
    each with NCCL kernels launched inside `dist.*` ranges and one
    launched outside any."""
    ms = 1_000_000
    rec = {
        "chunks": [["bench.activity", 0, 100 * ms], ["bench.update", 100 * ms, 300 * ms]],
        "ranges": [["dist.merge", 1 * ms, 2 * ms], ["dist.gather", 3 * ms, 4 * ms],
                   ["update.connectivity", 110 * ms, 290 * ms],
                   ["dist.scatter_sum", 150 * ms, 151 * ms]],
        "ops": [["ncclDevKernel_AllReduce_Sum_f32", 5 * ms, 2 * ms, 1 * ms + 5],
                ["ncclDevKernel_AllGather", 8 * ms, 4 * ms, 3 * ms + 5],
                ["elementwise_kernel", 9 * ms, 1 * ms, 3 * ms + 9],
                ["ncclDevKernel_AllReduce_Sum_f32", 20 * ms, 3 * ms, 50 * ms],
                ["ncclDevKernel_ReduceScatter", 160 * ms, 6 * ms, 150 * ms + 1],
                ["nccl:all_reduce", 5 * ms, 2 * ms, 1 * ms + 6]],
        "chunk_steps": [["bench.activity", 99], ["bench.update", 1]],
        "activity_steps": 99, "replica_updates": 1, "rows": 64}
    counts = {"bench.activity": {"dist.merge.calls": 99, "dist.merge.bytes": 99 * 400,
                                 "dist.gather.calls": 99, "dist.gather.bytes": 99 * 800},
              "bench.update": {"dist.exchange.rows": 4096, "update.networks": 1,
                               "dist.scatter_sum.bytes": 10}}
    return {"profile": rec, "counts": counts, "ranks": 4, "peak_bytes": 0}


def _read(name, ctx):
    return spec.metric_module(name).read(ctx)


def test_readers_by_hand():
    ctx = _fixture()
    assert _read("step_collective_ms", ctx) == pytest.approx(6.0 / 99)
    assert _read("update_collective_ms", ctx) == pytest.approx(6.0)
    assert _read("collective_bytes_per_step", ctx) == pytest.approx(1200.0)
    bus = 99 * (2 * 0.75 * 400 + 0.75 * 800)
    assert _read("link_roofline", ctx) == pytest.approx(
        100.0 * bus / 6e-3 / links.NVLINK_BYTES_PER_S)
    assert _read("exchange_rows_per_update", ctx) == pytest.approx(4096.0)


def test_readers_find_nothing_without_the_ranges_and_counters():
    ctx = _fixture()
    bare = dict(ctx, counts={"bench.activity": {}, "bench.update": {"update.networks": 1}})
    bare["profile"] = dict(ctx["profile"], ranges=[r for r in ctx["profile"]["ranges"]
                                                   if not r[0].startswith("dist.")])
    for name in ("step_collective_ms", "update_collective_ms", "collective_bytes_per_step",
                 "link_roofline", "exchange_rows_per_update"):
        assert _read(name, bare) is None, name
        assert _read(name, {"profile": None, "counts": None, "ranks": 4}) is None, name


def test_entries_name_only_the_new_cell():
    bm = spec.benchmark()
    mine = {"step_collective_ms", "update_collective_ms", "collective_bytes_per_step",
            "link_roofline", "exchange_rows_per_update"}
    for m in bm["per_layer"]:
        if m["name"] in mine:
            assert m["workloads"] == [CELL]
            mod = spec.metric_module(m["name"])
            assert (mod.UNIT, mod.LAYER, mod.MOVES) == (m["unit"], m["layer"], m["moves"])
    cell = next(w for w in bm["workloads"] if w["name"] == CELL)
    assert cell["chips"] == 4 and len(cell["why"]) <= 200
    assert json.loads(json.dumps(bm)) == bm


def test_control_script_reads_the_cell():
    """`bench/control.py`'s readings for this system: the sound numbers at 0,
    the control's over every limit but none below it."""
    import importlib.util
    path = spec.BENCH / "control.py"
    mod_spec = importlib.util.spec_from_file_location("bench_control", path)
    control = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(control)
    c = _tiny(2)
    r = control.readings(c, SEED + 9, 0.2, device="cpu")
    assert r["checked"] == 2 and r["intervals"] == 2
    assert r["sound"] == {k: 0.0 for k in ck.NUMBERS}
    assert all(r["control_min"][k] > c.config["limits"][k] for k in ck.NUMBERS)
