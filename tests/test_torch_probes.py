"""The port's probes and checkpoints against the JAX package's.

N = 256 from the seeded mid-growth state of `test_torch_engine`, the JAX
engine's draws replayed (`JaxReplayNoise`): spike rasters and turnover rows
exactly equal to JAX's probes, calcium rows within rtol 1e-5 (the growth
curve's exp).  Within the port: a probed run is bit for bit the probe-free
run, a chunked run the uninterrupted one, and a restore mid-chunk rewrites
the same files.  Chunk files and checkpoints cross between the packages
in both directions.
"""
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from repro.checkpoint import manager as jmanager
from repro.core import engine as jengine
from repro.core import probes as jprobes
from repro_torch import convert
from repro_torch.checkpoint import manager
from repro_torch.core import engine, ensemble, probes
from test_torch_engine import (ENGINE_CFG, FMM_CFG, MSP_CFG, JaxReplayNoise, _jax_configs,
                               _jax_state, _mid_growth)

N, SEED = 256, 11


def _regions(pos):
    return ((pos[:, 0] > 500) + 2 * (pos[:, 1] > 500) + 4 * (pos[:, 2] > 500)).astype(np.int32)


def _psets(pos, chunk):
    port = probes.ProbeSet((probes.SpikeRasterProbe(), probes.CalciumProbe(),
                            probes.TurnoverProbe(_regions(pos), 8)), chunk_size=chunk)
    jax_ = jprobes.ProbeSet((jprobes.SpikeRasterProbe(), jprobes.CalciumProbe(),
                             jprobes.TurnoverProbe(_regions(pos), 8)), chunk_size=chunk)
    return port, jax_


def _port(pos):
    return engine.PlasticityEngine(pos, MSP_CFG, FMM_CFG, ENGINE_CFG, device="cpu")


def _assert_rows(got: dict, want: dict, what=""):
    """spikes and turnover exactly, calcium within rtol 1e-5."""
    assert set(got) == set(want), what
    for name in got:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        assert g.shape == w.shape, (what, name)
        if name == "calcium":
            np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=f"{what} {name}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")


@pytest.fixture(scope="module")
def replayed():
    """One 300-step run in a single 300-row chunk, JAX and port, same draws."""
    pos, arrays = _mid_growth(N, SEED)
    key = jax.random.key(SEED)
    pset, jpset = _psets(pos, 300)
    jeng = jengine.PlasticityEngine(pos, *_jax_configs())
    jst, jrecs, jps = jeng.simulate(_jax_state(arrays), key, 300, None, jpset, jpset.init(N))
    jax.block_until_ready(jrecs.num_synapses)
    eng = _port(pos)
    st0 = convert.from_jax_state(arrays, "cpu")
    st, recs, ps = eng.simulate(st0, 300, noise=JaxReplayNoise(key), probes=pset,
                                probe_state=pset.init(N, device="cpu"))
    return dict(pos=pos, arrays=arrays, key=key, eng=eng, st0=st0, pset=pset, jpset=jpset,
                jst=jst, jrecs=jrecs, jps=jps, st=st, recs=recs, ps=ps)


def test_probe_rows_match_jax(replayed):
    ps, jps = replayed["ps"], replayed["jps"]
    assert int(ps.cursor) == int(jps.cursor) == 300
    assert int(ps.step0) == int(jps.step0) == 1
    _assert_rows({k: v.numpy() for k, v in ps.buffers.items()},
                 {k: np.asarray(v) for k, v in jps.buffers.items()})
    births = ps.buffers["turnover"][:, 0].sum()
    assert int(births) > 0


def test_probed_run_is_the_probe_free_run(replayed):
    eng = replayed["eng"]
    st, recs = eng.simulate(replayed["st0"], 300, noise=JaxReplayNoise(replayed["key"]))
    for a, b in zip(recs, replayed["recs"]):
        assert torch.equal(a, b)
    for part in ("neurons", "edges"):
        for a, b in zip(getattr(st, part), getattr(replayed["st"], part)):
            assert torch.equal(a, b)


def test_turnover_accounts_for_every_change_of_the_synapse_count(replayed):
    """births - deaths equals the change of the record's synapse count at
    every step.  A step that wrote into the edge table in place, or handed
    back its input's tensors after changing them, would break this."""
    tov = replayed["ps"].buffers["turnover"].numpy().astype(np.int64)
    syn = replayed["recs"].num_synapses.numpy().astype(np.int64)
    net = tov[:, 0].sum(axis=1) - tov[:, 1].sum(axis=1)
    np.testing.assert_array_equal(net, np.diff(np.r_[0, syn]))
    assert (net != 0).sum() >= 3


def test_chunked_run_equals_the_uninterrupted_run(tmp_path):
    pos, arrays = _mid_growth(128, 5)
    eng = _port(pos)
    st0 = convert.from_jax_state(arrays, "cpu")
    pset, _ = _psets(pos, 64)
    whole, wrecs, wps = eng.simulate(st0, 300, seed=2, probes=pset)
    big, _ = _psets(pos, 300)
    _, _, bps = eng.simulate(st0, 300, seed=2, probes=big)
    st, recs, ps = probes.simulate_chunked(eng, st0, 300, pset, seed=2, out_dir=str(tmp_path))
    for a, b in zip(recs, wrecs):
        assert torch.equal(a, b)
    for a, b in zip(st.edges, whole.edges):
        assert torch.equal(a, b)
    assert int(ps.cursor) == 300 - 4 * 64 and int(ps.step0) == 257
    for name in ("spikes", "calcium", "turnover"):
        steps, rows = probes.read_trajectory(str(tmp_path), name)
        np.testing.assert_array_equal(steps, np.arange(1, 301))
        np.testing.assert_array_equal(rows, bps.buffers[name].numpy())
    assert sorted(os.listdir(tmp_path)) == [f"chunk_{s:09d}.npz" for s in (1, 65, 129, 193, 257)]


def test_restore_mid_chunk_neither_duplicates_nor_drops_rows(tmp_path):
    """A checkpoint at step 130 (cursor 30 into a chunk of 100), restored and
    run on to 260, leaves the files of an uninterrupted 260-step run."""
    pos, arrays = _mid_growth(128, 6)
    eng = _port(pos)
    st0 = convert.from_jax_state(arrays, "cpu")
    pset, _ = _psets(pos, 100)
    ref, out, ckpt = (str(tmp_path / d) for d in ("ref", "out", "ckpt"))
    probes.simulate_chunked(eng, st0, 260, pset, seed=3, out_dir=ref)
    st, _, ps = probes.simulate_chunked(eng, st0, 130, pset, seed=3, out_dir=out)
    assert int(ps.cursor) == 30 and int(ps.step0) == 101
    manager.save_pytree((st, ps), ckpt, st.step)
    (st2, ps2), step = manager.restore_pytree((st0, pset.init(128, device="cpu")), ckpt)
    assert step == 130 and st2.step == 130 and int(ps2.cursor) == 30
    for a, b in zip(ps2.buffers.values(), ps.buffers.values()):
        assert torch.equal(a, b)
    probes.simulate_chunked(eng, st2, 130, pset, seed=3, out_dir=out, probe_state=ps2)
    assert sorted(os.listdir(out)) == sorted(os.listdir(ref))
    for fname in os.listdir(ref):
        with np.load(os.path.join(ref, fname)) as a, np.load(os.path.join(out, fname)) as b:
            assert set(a.files) == set(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{fname}:{k}")


def test_interventions_and_the_checkpoint_manager(tmp_path):
    """The lesion hook fires at its step; the run equals the probe-free run
    with the same surgery; the manager keeps the newest checkpoints, each a
    restorable (state, probe_state) pair."""
    pos, arrays = _mid_growth(128, 7)
    eng = _port(pos)
    st0 = convert.from_jax_state(arrays, "cpu")
    pset, _ = _psets(pos, 100)
    mask = np.linalg.norm(pos - 500.0, axis=1) < 300.0
    lesion = lambda s: probes.apply_lesion(s, mask)
    mgr = manager.CheckpointManager(str(tmp_path / "ckpt"), keep=2)
    st, recs, _ = probes.simulate_chunked(eng, st0, 300, pset, seed=4,
                                          interventions={150: lesion}, manager=mgr)
    mgr.wait()
    a, r1 = eng.simulate(st0, 150, seed=4)
    b, r2 = eng.simulate(lesion(a), 150, seed=4)
    for x, y, z in zip(recs, r1, r2):
        assert torch.equal(x, torch.cat([y, z]))
    assert torch.equal(st.edges.valid, b.edges.valid)
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_000000200", "step_000000300"]
    assert manager.latest_step(str(tmp_path / "ckpt")) == 300
    (rs, rps), step = mgr.restore((st0, pset.init(128, device="cpu")))
    assert step == 300 and rs.step == 300 and int(rps.cursor) == 0 and int(rps.step0) == 301
    for x, y in zip(rs.neurons, st.neurons):
        assert torch.equal(x, y)
    mgr.close()


def test_apply_lesion_matches_jax(replayed):
    mask = np.linalg.norm(replayed["pos"] - 500.0, axis=1) < 300.0
    got = convert.to_numpy(probes.apply_lesion(replayed["st"], mask))
    want = jprobes.apply_lesion(replayed["jst"], jnp.asarray(mask))
    for name in ("src", "dst", "valid"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(want.edges, name)))
    for name in ("refrac", "spiked"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(want.neurons, name)))
    for name in ("x", "calcium", "ax_elems", "den_elems"):
        np.testing.assert_allclose(got[name], np.asarray(getattr(want.neurons, name)),
                                   rtol=1e-5)
        assert (got[name][mask] == 0).all()
    before = int(replayed["st"].edges.valid.sum())
    assert 0 < int(got["valid"].sum()) < before


def test_chunk_files_cross_between_the_packages(replayed, tmp_path):
    """JAX's ProbeWriter files read back with the port's read_trajectory,
    and the port's with JAX's."""
    pos, arrays, key = replayed["pos"], replayed["arrays"], replayed["key"]
    pset, jpset = _psets(pos, 64)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jeng = jengine.PlasticityEngine(pos, *_jax_configs())
    jprobes.simulate_chunked(jeng, _jax_state(arrays), key, 150, jpset, out_dir=jdir)
    probes.simulate_chunked(replayed["eng"], replayed["st0"], 150, pset,
                            noise=JaxReplayNoise(key), out_dir=pdir)
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(pdir))
    for name in ("spikes", "calcium", "turnover"):
        js, jv = probes.read_trajectory(jdir, name)
        ps_, pv = jprobes.read_trajectory(pdir, name)
        np.testing.assert_array_equal(js, np.arange(1, 151))
        np.testing.assert_array_equal(ps_, js)
        _assert_rows({name: pv}, {name: jv}, "cross-read")


def test_jax_checkpoint_restores_into_the_port(replayed, tmp_path):
    """A (SimState, ProbeState) checkpoint written by the JAX package
    restores into the port's template and equals `from_jax_state` and
    `probe_state_from_jax`; the port's checkpoint restores into JAX's."""
    jst, jps = replayed["jst"], replayed["jps"]
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jmanager.save_pytree((jst, jps), jdir, 300)
    template = (replayed["st0"], replayed["pset"].init(N, device="cpu"))
    (st, ps), step = manager.restore_pytree(template, jdir)
    assert step == 300
    arrays = {**{k: np.asarray(v) for k, v in jst.neurons._asdict().items()},
              **{k: np.asarray(v) for k, v in jst.edges._asdict().items()},
              "step": np.asarray(jst.step), "dropped": np.asarray(jst.dropped)}
    want = convert.from_jax_state(arrays, "cpu")
    for part in ("neurons", "edges"):
        for a, b in zip(getattr(st, part), getattr(want, part)):
            assert torch.equal(a, b)
    assert st.step == want.step == 300 and isinstance(st.step, int)
    assert st.dropped.dtype == torch.int64 and torch.equal(st.dropped, want.dropped)
    wps = convert.probe_state_from_jax(
        {"cursor": np.asarray(jps.cursor), "step0": np.asarray(jps.step0),
         "buffers": {k: np.asarray(v) for k, v in jps.buffers.items()}}, "cpu")
    assert int(ps.cursor) == int(wps.cursor) and int(ps.step0) == int(wps.step0)
    for k in wps.buffers:
        assert torch.equal(ps.buffers[k], wps.buffers[k])
    back = convert.probe_state_to_numpy(ps)
    assert back["cursor"].dtype == np.int32 and int(back["step0"]) == int(jps.step0)
    for k, v in back["buffers"].items():
        np.testing.assert_array_equal(v, np.asarray(jps.buffers[k]))

    path = manager.save_pytree((st, ps), pdir, 300)
    import json
    with open(os.path.join(path, "manifest.json")) as f:
        stored = {k: v["stored"] for k, v in json.load(f)["arrays"].items()}
    assert stored["0|.step"] == "host int" and stored["0|.dropped"] == "tensor"
    assert stored["1|.cursor"] == "numpy"
    (jst2, jps2), _ = jmanager.restore_pytree((jst, jps), pdir)
    for a, b in zip(jax.tree.leaves((jst2, jps2)), jax.tree.leaves((jst, jps))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_ensemble_probes_equal_sequential_probed_runs(tmp_path):
    """Replica k's rows equal a single probed run with its draws; the writer
    splits a batched state into per-replica files itself."""
    pos, arrays = _mid_growth(64, 8)
    eng = _port(pos)
    st0 = convert.from_jax_state(arrays, "cpu")
    pset, _ = _psets(pos, 200)
    noises = ensemble.replica_noises(5, 3, "cpu")
    ens = ensemble.EnsembleEngine(eng)
    _, _, bps = ens.simulate(ensemble.stack_states([st0] * 3), 200, noises=noises, probes=pset)
    assert bps.cursor.tolist() == [200] * 3
    paths = probes.ProbeWriter(str(tmp_path)).flush(pset, bps)
    assert [os.path.basename(p) for p in paths] == [f"chunk_000000001_r{k}.npz" for k in range(3)]
    for k in range(3):
        _, _, ps = eng.simulate(st0, 200, noise=noises[k], probes=pset)
        for name, buf in ps.buffers.items():
            assert torch.equal(buf, bps.buffers[name][k])
            steps, rows = probes.read_trajectory(str(tmp_path), name, replica=k)
            np.testing.assert_array_equal(rows, buf.numpy())
    with pytest.raises(FileNotFoundError):
        probes.read_trajectory(str(tmp_path), "spikes")


def test_probe_set_validation():
    with pytest.raises(ValueError, match="duplicate"):
        probes.ProbeSet((probes.CalciumProbe(), probes.CalciumProbe()))
    with pytest.raises(ValueError, match="positive"):
        probes.ProbeSet((probes.CalciumProbe(),), chunk_size=0)
    ps = probes.ProbeSet((probes.SpikeRasterProbe(),), chunk_size=4).init(10, start_step=7,
                                                                           device="cpu")
    assert int(ps.step0) == 8 and ps.buffers["spikes"].shape == (4, 10)
    assert probes.TurnoverProbe(np.zeros(3), 2).needs_merge
    assert probes.SpikeRasterProbe.row_sharded and not probes.TurnoverProbe.row_sharded


def test_checkpoint_manager_surfaces_writer_errors(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    mgr = manager.CheckpointManager(str(blocker), async_save=True)
    mgr.save({"a": torch.zeros(3)}, 1)
    with pytest.raises(OSError):
        mgr.wait()
    mgr.close()
