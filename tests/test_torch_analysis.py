"""The network analysis report (`core/analysis.py`) against the JAX
package's, on edge tables grown by the port at N = 256 (300 steps, three
connectivity updates) with each search method, handed to both packages as
the same numpy arrays.

Integer results (degrees, maxima, isolated neurons, histogram counts) and
the reciprocity fraction must be equal; float means and standard deviations
agree to rtol 1e-6 (float32 reductions in another order); the clustering
coefficient is host numpy in both and must be equal.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import analysis as janalysis
from repro.core.synapses import SynapseState as JaxSynapses
from repro_torch import convert
from repro_torch.core import analysis, engine

from test_torch_engine import FMM_CFG, MSP_CFG, _mid_growth


@pytest.fixture(scope="module", params=["fmm", "barnes_hut", "direct"])
def grown(request):
    pos, arrays = _mid_growth(256, 21)
    eng = engine.PlasticityEngine(pos, MSP_CFG, FMM_CFG,
                                  engine.EngineConfig(method=request.param), device="cpu")
    st, recs = eng.simulate(convert.from_jax_state(arrays, "cpu"), 300, seed=3)
    assert int(recs.num_synapses[-1]) > 500
    e = st.edges
    jedges = JaxSynapses(*(jnp.asarray(t.numpy()) for t in (e.src, e.dst, e.valid)))
    return pos, e, jedges


def test_degree_statistics_match_jax(grown):
    pos, e, je = grown
    got = analysis.degree_statistics(e, len(pos))
    want = janalysis.degree_statistics(je, len(pos))
    assert set(got) == set(want)
    for k in ("out_max", "in_max", "isolated"):
        assert int(got[k]) == int(want[k]), k
    for k in ("out_mean", "out_std", "in_mean", "in_std"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)


def test_reciprocity_matches_jax(grown):
    pos, e, je = grown
    got = float(analysis.reciprocity(e, len(pos)))
    assert got == pytest.approx(float(janalysis.reciprocity(je, len(pos))), rel=1e-6)
    assert 0.0 <= got <= 1.0


@pytest.mark.parametrize("max_dist", [None, 800.0])
def test_connection_length_profile_matches_jax(grown, max_dist):
    pos, e, je = grown
    got = analysis.connection_length_profile(e, torch.from_numpy(pos), max_dist=max_dist)
    want = janalysis.connection_length_profile(je, jnp.asarray(pos), max_dist=max_dist)
    np.testing.assert_array_equal(got["bin_edges"].numpy(), np.asarray(want["bin_edges"]))
    np.testing.assert_array_equal(got["counts"].numpy(), np.asarray(want["counts"]))
    np.testing.assert_allclose(float(got["mean_length"]), float(want["mean_length"]),
                               rtol=1e-6)
    if max_dist is None:
        assert int(got["counts"].sum()) == int(e.valid.sum())


def test_clustering_coefficient_matches_jax(grown):
    pos, e, je = grown
    assert analysis.clustering_coefficient(e, len(pos)) == \
        janalysis.clustering_coefficient(je, len(pos))


def test_summarize_matches_jax(grown):
    pos, e, je = grown
    got = analysis.summarize(e, torch.from_numpy(pos))
    want = janalysis.summarize(je, jnp.asarray(pos))
    assert set(got) == set(want) and set(got["degrees"]) == set(want["degrees"])
    for k, v in want["degrees"].items():
        assert got["degrees"][k] == pytest.approx(v, rel=1e-6), k
    for k in ("reciprocity", "mean_connection_length", "clustering_coefficient"):
        assert got[k] == pytest.approx(want[k], rel=1e-6), k
