"""The port's LM configs, init, caches and step specs against the JAX
package's: `repro_torch.models.config`, `repro_torch.configs`,
`repro_torch.models.model.init_params`/`make_cache`,
`repro_torch.launch.steps.input_specs`."""
import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.launch import steps as jax_steps
from repro.models import config as jax_config
from repro.models import model as JM
from repro_torch import configs, convert
from repro_torch.launch import steps
from repro_torch.models import config
from repro_torch.models import model as TM

from _torch_lm import ARCH_NAMES


def test_registry_and_every_field_equal():
    assert list(configs.ARCHS) == list(jax_configs.ARCHS)
    for name in ARCH_NAMES:
        assert dataclasses.asdict(configs.get(name)) == dataclasses.asdict(jax_configs.get(name))
        assert (dataclasses.asdict(configs.get(name).reduced())
                == dataclasses.asdict(jax_configs.get(name).reduced()))
        assert (dataclasses.asdict(configs.get(name).reduced(layers=3, d_model=96, vocab=128))
                == dataclasses.asdict(jax_configs.get(name).reduced(layers=3, d_model=96,
                                                                    vocab=128)))
        for prop in ("resolved_head_dim", "is_encoder", "supports_decode", "sub_quadratic"):
            assert getattr(configs.get(name), prop) == getattr(jax_configs.get(name), prop)
    with pytest.raises(KeyError):
        configs.get("gpt-2")


def test_shapes_and_applicability_matrix_equal():
    assert [dataclasses.astuple(s) for s in config.ALL_SHAPES] == [
        dataclasses.astuple(s) for s in jax_config.ALL_SHAPES]
    for name in ARCH_NAMES:
        for s, js in zip(config.ALL_SHAPES, jax_config.ALL_SHAPES):
            assert (config.shape_applicability(configs.get(name), s)
                    == jax_config.shape_applicability(jax_configs.get(name), js))


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_input_specs_equal(name):
    for s, js in zip(config.ALL_SHAPES, jax_config.ALL_SHAPES):
        got = steps.input_specs(configs.get(name), s)
        want = jax_steps.input_specs(jax_configs.get(name), js)
        assert list(got) == list(want)
        for k in got:
            assert got[k].shape == want[k].shape
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)


def _jax_leaves(tree):
    return {".".join(str(getattr(p, "key", p)) for p in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_init_tree_shapes_dtypes_and_spread(name):
    """The port's own init: the reference tree's leaves (shapes, dtypes), ones
    for norm scales and D, zeros for biases, and each drawn leaf's standard
    deviation 1/sqrt(fan_in) within five standard errors of the estimate."""
    cfg = jax_configs.get(name).reduced()
    want = _jax_leaves(jax.eval_shape(lambda: JM.init_params(jax.random.key(0), cfg)))
    model = TM.init_params(configs.get(name).reduced(), seed=0, device="cpu")
    got = convert.lm_params_to_numpy(model)
    got = {".".join(p): v for p, v in convert._leaves(got)}
    assert set(got) == set(want)
    for path, leaf in got.items():
        assert leaf.shape == want[path].shape and leaf.dtype == want[path].dtype, path
        last = path.split(".")[-1]
        x = np.asarray(leaf, np.float64)
        if last in ("scale", "d_skip"):
            assert np.all(x == 1), path
        elif last in ("b", "bq", "bk", "bv", "conv_b", "a_log", "dt_bias"):
            assert np.all(x == 0), path
        else:
            stacked = path.split(".")[0] in TM.STACKS
            shape = leaf.shape[1:] if stacked else leaf.shape
            fan_in = {"table": shape[-1], "wo": shape[-2], "w_uk": shape[0], "w_uv": shape[0],
                      "conv_w": shape[0], "out_proj": shape[0]}.get(last, shape[0])
            tol = max(0.02, 5 / math.sqrt(2 * x.size))
            assert abs(x.std() * math.sqrt(fan_in) - 1) < tol, (path, x.std())
    # the same seed gives the same draws; another seed others
    again = TM.init_params(configs.get(name).reduced(), seed=0, device="cpu")
    other = TM.init_params(configs.get(name).reduced(), seed=1, device="cpu")
    for (n, a), b, c in zip(model.named_parameters(), again.parameters(), other.parameters()):
        assert torch.equal(a, b), n
    assert any(not torch.equal(a, c) for a, c in zip(model.parameters(), other.parameters()))


@pytest.mark.parametrize("name", [n for n in ARCH_NAMES if jax_configs.get(n).supports_decode])
def test_make_cache_layout_equal(name):
    cfg = jax_configs.get(name).reduced()
    want = _jax_leaves(jax.eval_shape(lambda: JM.make_cache(cfg, 3, 24)))
    got = convert.lm_cache_to_numpy(TM.make_cache(configs.get(name).reduced(), 3, 24, "cpu"))
    got = {".".join(p): v for p, v in convert._leaves(got)}
    assert set(got) == set(want)
    for path, leaf in got.items():
        assert leaf.shape == want[path].shape and leaf.dtype == want[path].dtype, path
        assert not np.any(np.asarray(leaf, np.float32)), path


def test_partial_super_layer_refused():
    """A MoE config whose layers after the dense prefix are not whole
    super-layers is refused, as the reference's init asserts."""
    bad = dataclasses.replace(configs.get("llama4-maverick-400b-a17b").reduced(), num_layers=3)
    with pytest.raises(ValueError, match="super-layers"):
        TM.make_cache(bad, 1, 8, "cpu")
