"""The distributed engine against the JAX engine: p = 4 gloo ranks in
spawned CPU processes (sharded find phase, routed exchange fetching every
level below the root) replay the JAX engine's own draws from a table.  The
run equals the single-device port run with the same draws bit for bit
(records, spikes, the whole final state), and the JAX engine's run as
tests/test_torch_engine.py holds the single-device port to it (N = 256,
300 steps from a seeded mid-growth state: exact synapse counts, spike rates
and edge tables, calcium at rtol 1e-5).  JAX is imported inside the test
only, so the spawned ranks that unpickle `TableNoise` from this module do
not import it."""
import dataclasses

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core.distributed import sorted_positions
from repro_torch.core.engine import EngineConfig, PlasticityEngine
from repro_torch.launch.distributed import Job, run_ranks, same_run

N, STEPS = 256, 300


class TableNoise:
    """Draws recorded from another noise object, replayed by (draw, step,
    its other arguments, the number of indices); picklable, so spawned
    ranks can replay them."""

    def __init__(self, inner=None):
        self.inner = inner
        self.table = {}

    def __getstate__(self):
        return {"inner": None, "table": self.table}

    def _draw(self, name, step, *args):
        idx = [a for a in args if isinstance(a, torch.Tensor)][0]
        rest = tuple(a for a in args if not isinstance(a, torch.Tensor))
        key = (name, step, rest, idx.shape[0])
        if self.inner is not None:
            self.table[key] = getattr(self.inner, name)(step, *args).numpy()
        return torch.from_numpy(self.table[key].copy())

    def spike_uniform(self, step, rows):
        return self._draw("spike_uniform", step, rows)

    def delete_bits(self, step, side, slots):
        return self._draw("delete_bits", step, side, slots)

    def descent_gumbel(self, step, level, ids):
        return self._draw("descent_gumbel", step, level, ids)

    def leaf_gumbel(self, step, rows, max_leaf):
        return self._draw("leaf_gumbel", step, rows, max_leaf)

    def conflict_bits(self, step, rows):
        return self._draw("conflict_bits", step, rows)


def test_four_ranks_with_the_jax_draws_equal_the_jax_engine():
    """See the module docs."""
    import jax
    from repro.core import engine as jengine
    from test_torch_engine import JaxReplayNoise, _jax_configs, _jax_state, _mid_growth
    pos, arrays = _mid_growth(N, 11)
    ecfg = EngineConfig()
    spos = sorted_positions(pos, ecfg)
    key = jax.random.key(11)
    jeng = jengine.PlasticityEngine(spos, *_jax_configs())
    jst, jrecs = jeng.simulate(_jax_state(arrays), key, STEPS)
    msp_cfg, fmm_cfg, _ = (convert.configs_from_jax(*(dataclasses.asdict(c)
                                                       for c in _jax_configs())))
    recorder = TableNoise(JaxReplayNoise(key))
    eng = PlasticityEngine(spos, msp_cfg, fmm_cfg, ecfg, device="cpu")
    st, recs = eng.simulate(convert.from_jax_state(arrays, "cpu"), STEPS, noise=recorder)
    job = Job(spos, msp_cfg, fmm_cfg, ecfg, dict(pyramid_exchange="routed", routed_shared_levels=0),
              STEPS,
              state=arrays, noise=recorder)
    res, = run_ranks(4, [job], "cpu", 240.0, 60.0)
    assert not same_run(res, st, recs)
    np.testing.assert_array_equal(res["records"]["num_synapses"], np.asarray(jrecs.num_synapses))
    np.testing.assert_array_equal(res["records"]["spike_rate"], np.asarray(jrecs.spike_rate))
    np.testing.assert_allclose(res["records"]["calcium_mean"], np.asarray(jrecs.calcium_mean),
                               rtol=1e-5)
    for f in ("src", "dst", "valid"):
        np.testing.assert_array_equal(res["state"][f], np.asarray(getattr(jst.edges, f)))
    assert int(res["records"]["num_synapses"][-1]) > 0
