"""Whole models of the MoE configs at reduced width (deepseek's MLA, dense
prefix and shared experts; llama4's super-layers): the port against the
JAX package's forward_train, prefill and decode from the same parameters
(`_torch_lm.check_whole_model` states the tolerances)."""
import pytest

from _torch_lm import check_whole_model


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b", "llama4-maverick-400b-a17b"])
def test_whole_model_vs_jax(name):
    check_whole_model(name)
