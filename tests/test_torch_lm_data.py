"""The port's synthetic data pipeline (`repro_torch.data.pipeline`): a pure
function of (seed, step), the Markov stream's band structure (checked on
the JAX package's batches too: the structure is the reference's, the
numbers are the port's own counter hash), labels shifted by one, the
`random` kind and the audio batch."""
import jax
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.data.pipeline import DataConfig as JDataConfig, make_batch as jmake_batch
from repro_torch import configs
from repro_torch.data.pipeline import DataConfig, make_batch


def _np(batch):
    return {k: np.asarray(v) for k, v in batch.items()}


def test_data_determinism_and_structure():
    """The reference's `test_data_determinism_and_structure` on the port."""
    cfg = configs.get("qwen2-0.5b").reduced()
    d = DataConfig(seed=7)
    b1 = _np(make_batch(cfg, d, 3, 4, 32, "cpu"))
    b2 = _np(make_batch(cfg, d, 3, 4, 32, "cpu"))
    np.testing.assert_array_equal(b1["inputs"], b2["inputs"])
    b3 = _np(make_batch(cfg, d, 4, 4, 32, "cpu"))
    assert not np.array_equal(b1["inputs"], b3["inputs"])
    assert not np.array_equal(b1["inputs"], _np(make_batch(cfg, DataConfig(seed=8), 3, 4, 32,
                                                           "cpu"))["inputs"])
    assert (b1["inputs"] < cfg.vocab_size).all() and (b1["inputs"] >= 0).all()
    assert b1["inputs"].dtype == np.int32 and b1["inputs"].shape == (4, 32)
    # labels are inputs shifted by one
    np.testing.assert_array_equal(b1["inputs"][:, 1:], b1["labels"][:, :-1])


def _check_bands(toks, vocab, classes):
    """Each token lies in its class's band of vocab // classes ids, and the
    class walks by steps in [-2, 3) modulo `classes`, from 0."""
    band = vocab // classes
    cls = toks // band
    assert (cls < classes).all()
    steps = np.diff(np.concatenate([np.zeros((toks.shape[0], 1), np.int64), cls], 1), axis=1)
    assert set(np.unique(steps % classes)) <= {0, 1, 2, classes - 2, classes - 1}
    # every step and every offset in the band occurs
    assert len(np.unique(steps % classes)) == 5
    assert len(np.unique(toks % band)) == band


@pytest.mark.parametrize("source", ["port", "jax"])
def test_markov_band_structure(source):
    cfg = configs.get("qwen2-0.5b").reduced(vocab=512)
    if source == "port":
        b = _np(make_batch(cfg, DataConfig(seed=1, zipf_classes=32), 0, 8, 256, "cpu"))
    else:
        jcfg = jax_configs.get("qwen2-0.5b").reduced(vocab=512)
        b = _np(jax.tree.map(np.asarray, jmake_batch(jcfg, JDataConfig(seed=1, zipf_classes=32),
                                                     0, 8, 256)))
    toks = np.concatenate([b["inputs"], b["labels"][:, -1:]], axis=1).astype(np.int64)
    _check_bands(toks, 512, 32)


def test_random_kind_is_uniform_over_the_vocab():
    cfg = configs.get("yi-6b").reduced(vocab=64)
    b = _np(make_batch(cfg, DataConfig(seed=2, kind="random"), 5, 16, 256, "cpu"))
    counts = np.bincount(b["inputs"].ravel(), minlength=64)
    assert counts.min() > 0 and (b["inputs"] < 64).all()
    # 4096 draws over 64 ids: each count within 6 standard deviations of 64
    assert np.abs(counts - 64).max() < 6 * 8
    np.testing.assert_array_equal(b["inputs"][:, 1:], b["labels"][:, :-1])
    with pytest.raises(ValueError, match="kind"):
        make_batch(cfg, DataConfig(kind="zipf"), 0, 1, 4, "cpu")


def test_audio_batch():
    """Normal features (B, S, F) float32 and integer labels in the vocab."""
    cfg = configs.get("hubert-xlarge").reduced()
    b = make_batch(cfg, DataConfig(seed=3), 0, 4, 64, "cpu")
    x, lab = b["inputs"].numpy(), b["labels"].numpy()
    assert x.shape == (4, 64, cfg.frontend_dim) and x.dtype == np.float32
    assert lab.shape == (4, 64) and lab.dtype == np.int32
    assert (lab >= 0).all() and (lab < cfg.vocab_size).all()
    # 8192 standard normals: mean within 0.05, std within 0.05 of 1
    assert abs(x.mean()) < 0.05 and abs(x.std() - 1) < 0.05
    assert torch.equal(make_batch(cfg, DataConfig(seed=3), 0, 4, 64, "cpu")["inputs"],
                       b["inputs"])
