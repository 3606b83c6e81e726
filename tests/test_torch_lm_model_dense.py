"""Whole models of the dense, VLM and audio configs at reduced width: the
port (`repro_torch.models.model`) against the JAX package's forward_train,
prefill and decode from the same parameters (`_torch_lm.check_whole_model`
states the tolerances)."""
import pytest

from _torch_lm import check_whole_model


@pytest.mark.parametrize("name", ["chameleon-34b", "hubert-xlarge", "internlm2-1.8b",
                                  "qwen2-0.5b", "qwen3-8b", "yi-6b"])
def test_whole_model_vs_jax(name):
    check_whole_model(name)
