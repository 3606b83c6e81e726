"""The port's serving layer (`repro_torch/serve`, `repro_torch/launch/serve.py`).

1. The slot allocator's property tests, copies of tests/test_serve_batcher.py
   run against the port's `SlotBatcher`: I1 no two live sessions share a
   slot, I2 a slot is reused only after its occupant's release, I3
   admitted == live + evicted + finished + queued restores.
2. Pinned TGI-style traffic (pool 64, 4 slots, rounds of 100, seed 6, the
   JAX package's tests/test_serve_integration.py scenario) through the
   port's `SimulationService` on the CPU: EVERY session equals an isolated
   port run of its own size (`isolated_engine(n).simulate` with counter
   draws) bit for bit: records, neuron rows, the edge-table prefix with no
   valid edge past it, probe rows with inert pad columns.  The scenario is
   checked to cover an evict and a restore into another slot, a round at
   full occupancy and a session that finishes mid-round.
3. The errors of `submit` and `result`.
"""

import random
import tempfile

import pytest
import torch

from _hypothesis_compat import given, settings, strategies as st
from repro_torch.core.probes import CalciumProbe, ProbeSet, SpikeRasterProbe
from repro_torch.launch.serve import (build_service, default_traffic, occupancy_histogram,
                                      replay_traffic)
from repro_torch.serve import BatcherError, SessionRequest, SlotBatcher

POOL, SLOTS, ROUND = 64, 4, 100
CHUNK = 300


@settings(max_examples=60, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_random_event_walk_keeps_invariants(seed):
    rng = random.Random(seed)
    num_slots = rng.randint(1, 5)
    b = SlotBatcher(num_slots)
    # model: session id -> state in {queued, live, evicted, finished}
    model = {}
    ever_admitted = set()
    next_id = 0
    for _ in range(rng.randint(20, 120)):
        ops = ["submit"]
        if any(s == "queued" for s in model.values()):
            ops.append("admit")
        live = [sid for sid, s in model.items() if s == "live"]
        if live:
            ops += ["finish", "evict"]
        ev = [sid for sid, s in model.items() if s == "evicted"]
        if ev:
            ops.append("restore")
        op = rng.choice(ops)

        if op == "submit":
            sid = f"s{next_id}"
            next_id += 1
            b.enqueue(sid)
            model[sid] = "queued"
        elif op == "admit":
            got = b.admit_next()
            if got is None:
                assert not b.free_slots() or b.queued == 0
            else:
                sid, slot, _ = got
                assert model[sid] == "queued"
                assert 0 <= slot < num_slots
                model[sid] = "live"
                ever_admitted.add(sid)
        elif op in ("finish", "evict"):
            sid = rng.choice(live)
            slot = b.slot_of(sid)
            b.release(sid, finished=(op == "finish"))
            assert b.occupant(slot) is None  # slot actually freed
            model[sid] = "finished" if op == "finish" else "evicted"
        elif op == "restore":
            sid = rng.choice(ev)
            b.enqueue(sid, restore=True)
            model[sid] = "queued"

        # I1/I2 from the model's view: every live session holds exactly
        # the slot the batcher reports, and no slot is double-booked.
        live_now = [sid for sid, s in model.items() if s == "live"]
        slots = [b.slot_of(sid) for sid in live_now]
        assert None not in slots
        assert len(set(slots)) == len(slots)
        assert len(live_now) == b.live <= num_slots
        for sid in live_now:
            assert b.occupant(b.slot_of(sid)) == sid
        # I3: admitted counts first admissions only; queued restores stay
        # counted (they were admitted once) while the batcher's `evicted`
        # tracks only sessions currently on disk.
        assert b.admitted == len(ever_admitted)
        assert b.evicted == sum(1 for s in model.values() if s == "evicted")
        assert b.finished == sum(1 for s in model.values() if s == "finished")


@settings(max_examples=30, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_drain_conserves_sessions(seed):
    """Submit a burst, churn admissions/evictions, then drain: every
    session ends finished and the lifetime counters balance."""
    rng = random.Random(seed)
    b = SlotBatcher(rng.randint(1, 4))
    n = rng.randint(1, 12)
    for i in range(n):
        b.enqueue(f"s{i}")
    evicted_once = set()
    for _ in range(400):
        while b.admit_next() is not None:
            pass
        live = [sid for sid, _ in b.live_items()]
        if not live and b.queued == 0:
            break
        for sid in live:
            if rng.random() < 0.3 and sid not in evicted_once:
                b.release(sid, finished=False)
                evicted_once.add(sid)
                b.enqueue(sid, restore=True)
            else:
                b.release(sid, finished=True)
    assert b.finished == b.admitted == n
    assert b.live == 0 and b.evicted == 0 and b.queued == 0


def test_fifo_admission_lowest_slot_first():
    b = SlotBatcher(3)
    for sid in ["a", "b", "c", "d"]:
        b.enqueue(sid)
    assert b.admit_next() == ("a", 0, False)
    assert b.admit_next() == ("b", 1, False)
    assert b.admit_next() == ("c", 2, False)
    assert b.admit_next() is None  # full
    b.release("b", finished=True)
    assert b.admit_next() == ("d", 1, False)  # freed slot, FIFO queue


def test_restore_may_land_in_a_different_slot():
    b = SlotBatcher(2)
    b.enqueue("a")
    b.enqueue("b")
    assert b.admit_next() == ("a", 0, False)
    assert b.admit_next() == ("b", 1, False)
    b.release("a", finished=False)  # evict a from slot 0
    b.enqueue("c")
    assert b.admit_next() == ("c", 0, False)  # newcomer takes slot 0
    b.release("b", finished=True)
    b.enqueue("a", restore=True)
    assert b.admit_next() == ("a", 1, True)  # a restores into slot 1


def test_error_paths():
    with pytest.raises(ValueError):
        SlotBatcher(0)
    b = SlotBatcher(2)
    b.enqueue("a")
    with pytest.raises(BatcherError):
        b.enqueue("a")  # already queued
    b.admit_next()
    with pytest.raises(BatcherError):
        b.enqueue("a")  # already live
    with pytest.raises(BatcherError):
        b.release("ghost", finished=True)  # not live
    with pytest.raises(BatcherError):
        b.enqueue("ghost", restore=True)  # never admitted
    b.release("a", finished=True)
    with pytest.raises(BatcherError):
        b.enqueue("a")  # ids are single-use


# -- the service on pinned traffic --------------------------------------------

def _isolated(svc, req):
    """The ground truth a served session must reproduce bit for bit."""
    eng = svc.isolated_engine(req.n_neurons)
    pset = ProbeSet([SpikeRasterProbe(), CalciumProbe()], chunk_size=CHUNK)
    return eng, eng.simulate(eng.init_state(), req.num_steps, seed=req.seed, probes=pset)


def _assert_session_matches(svc, req):
    res = svc.result(req.session_id)
    eng, (st, recs, ps) = _isolated(svc, req)
    n, sid = req.n_neurons, req.session_id
    for f, a, b in zip(recs._fields, res.records, recs):
        assert a.shape == b.shape == (req.num_steps,), (sid, f)
        assert torch.equal(a, b), f"{sid}: records.{f} not bit for bit equal"
    for f, a, b in zip(st.neurons._fields, res.final_state.neurons, st.neurons):
        assert torch.equal(a[:n], b), f"{sid}: neurons.{f} not bit for bit equal"
        assert not a[n:].any(), f"{sid}: neurons.{f} pad rows not inert"
    cap = eng.edge_capacity
    for f, a, b in zip(st.edges._fields, res.final_state.edges, st.edges):
        assert torch.equal(a[:cap], b), f"{sid}: edges.{f}"
    assert not res.final_state.edges.valid[cap:].any(), f"{sid}: synapse on a pad row"
    assert res.final_state.step == st.step == req.num_steps
    assert torch.equal(res.final_state.dropped, st.dropped)
    if req.record_probes:
        assert set(res.probe_rows) == {"spikes", "calcium"}
        for name, rows in res.probe_rows.items():
            assert rows.shape[0] == req.num_steps
            assert torch.equal(rows[:, :n], ps.buffers[name][:req.num_steps]), \
                f"{sid}: probe {name} not bit for bit equal"
            assert not rows[:, n:].any(), f"{sid}: probe {name} pad columns not inert"
    else:
        assert res.probe_rows is None
    return recs


@pytest.fixture(scope="module")
def served():
    """Replay the pinned traffic once; every test reads the same run."""
    pset = ProbeSet([SpikeRasterProbe(), CalciumProbe()], chunk_size=CHUNK)
    with tempfile.TemporaryDirectory() as tmp:
        svc = build_service(POOL, num_slots=SLOTS, round_steps=ROUND, speedup=400.0, seed=42,
                            checkpoint_dir=tmp, probes=pset, device="cpu")
        traffic = default_traffic(seed=6, num_sessions=8, pool_size=POOL, round_steps=ROUND,
                                  max_rounds_of_work=3)
        events = replay_traffic(svc, traffic)
        yield svc, traffic, events
        svc.close()


def test_traffic_covers_the_contract(served):
    svc, traffic, events = served
    reqs = [req for _, req in traffic]
    assert len({r.n_neurons for r in reqs}) >= 3
    assert len({arr for arr, _ in traffic}) >= 3
    evicted = [e.split()[1] for e in events if e.startswith("evicted")]
    restored = [e.split()[1] for e in events if e.startswith("restored")]
    assert evicted and restored
    # a restore into another slot than the session's first
    slot_of = lambda kind, sid: next(e.split()[2] for e in events
                                     if e.startswith(kind) and e.split()[1] == sid)
    assert any(slot_of("admitted", sid) != slot_of("restored", sid) for sid in restored)
    assert max(occupancy_histogram(svc)) == SLOTS
    assert any(r.num_steps % ROUND for r in reqs), "no session finishes mid-round"
    assert sum("finished" in e for e in events) == sum("admitted" in e for e in events) == 8
    b = svc.batcher
    assert b.finished == b.admitted == len(traffic)
    assert b.live == 0 and b.evicted == 0 and b.queued == 0


def test_every_session_equals_its_isolated_run(served):
    svc, traffic, _ = served
    nsyn = {req.session_id: int(_assert_session_matches(svc, req).num_synapses[-1])
            for _, req in traffic}
    assert sum(1 for v in nsyn.values() if v > 0) >= len(nsyn) // 2


def test_submit_and_result_errors(served):
    svc, traffic, _ = served
    with pytest.raises(ValueError, match="duplicate"):
        svc.submit(traffic[0][1])
    with pytest.raises(ValueError, match="exceeds the pool"):
        svc.submit(SessionRequest("too-big", n_neurons=POOL + 1, num_steps=ROUND, seed=0))
    with pytest.raises(ValueError, match="chunk_size"):
        svc.submit(SessionRequest("too-long", n_neurons=8, num_steps=CHUNK + ROUND, seed=0,
                                  record_probes=True))
    with pytest.raises(KeyError, match="unknown session"):
        svc.result("never-submitted")
    with pytest.raises(ValueError, match="positive"):
        SessionRequest("bad", n_neurons=0, num_steps=ROUND, seed=0)


def test_probes_must_be_configured_and_rounds_whole_intervals():
    with tempfile.TemporaryDirectory() as tmp:
        svc = build_service(16, num_slots=1, round_steps=ROUND, checkpoint_dir=tmp,
                            device="cpu")
        with pytest.raises(ValueError, match="no probe set"):
            svc.submit(SessionRequest("p", n_neurons=8, num_steps=ROUND, record_probes=True))
        with pytest.raises(ValueError, match="multiple of"):
            build_service(16, num_slots=1, round_steps=150, checkpoint_dir=tmp, device="cpu")
        with pytest.raises(RuntimeError, match="not finished"):
            svc.submit(SessionRequest("q", n_neurons=8, num_steps=ROUND))
            svc.result("q")


def _holding(svc):
    """Sessions that may update again: live, evicted, or queued to restore."""
    return sum(1 for s in svc.sessions.values()
               if s.status in ("running", "evicted") or (s.status == "queued" and s.steps_done))


def test_prefix_engines_are_bounded_by_live_and_evicted_sessions():
    """Traffic with more distinct session sizes than slots: the engine's
    cache of prefix engines never holds more sizes than there are live and
    evicted sessions, it is empty after close, and every session still
    equals its isolated run."""
    with tempfile.TemporaryDirectory() as tmp:
        pset = ProbeSet([SpikeRasterProbe(), CalciumProbe()], chunk_size=CHUNK)
        svc = build_service(POOL, num_slots=2, round_steps=ROUND, speedup=400.0, seed=42,
                            checkpoint_dir=tmp, probes=pset, device="cpu")
        traffic = default_traffic(seed=3, num_sessions=6, pool_size=POOL, round_steps=ROUND,
                                  max_rounds_of_work=2)
        sizes = {req.n_neurons for _, req in traffic} - {POOL}   # POOL: the engine itself
        assert len(sizes) > svc.num_slots
        pending = sorted(traffic, key=lambda t: t[0])
        seen = set()
        while pending or any(s.status != "finished" for s in svc.sessions.values()):
            while pending and pending[0][0] <= svc.round_idx:
                svc.submit(pending.pop(0)[1])
            svc.run_round()
            seen |= set(svc.engine._prefixes)
            assert len(svc.engine._prefixes) <= _holding(svc), svc.round_idx
        assert seen
        for _, req in traffic:
            _assert_session_matches(svc, req)
        svc.close()
        assert not svc.engine._prefixes
