"""Edge tables for the spike-propagation tests, and a numpy reference.

Imports neither JAX nor the port: the card's tests use it too.
"""
import numpy as np


def tables(seed: int, lead: tuple, n: int, e: int, live: float = 0.48,
           spiking: float = 0.2, signed: bool = False):
    """(src, dst, valid, spiked, sign) numpy arrays: (*lead, e) tables whose
    live slots are a `live` share of each table; up to half, all in its
    lower half and randomly holed (as `insert` fills the lowest free slots
    after deletions); free slots point at neuron 0, as the engine leaves
    them; spikes on a `spiking` share of the (*lead, n) neurons; sign +-1
    or None."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, lead + (e,)).astype(np.int32)
    dst = rng.integers(0, n, lead + (e,)).astype(np.int32)
    span = max(0.5, live)
    valid = (np.arange(e) < span * e) & (rng.uniform(size=lead + (e,)) < live / span)
    src[~valid] = 0
    dst[~valid] = 0
    spiked = rng.uniform(size=lead + (n,)) < spiking
    sign = np.where(rng.uniform(size=lead + (n,)) < 0.3, -1.0, 1.0).astype(np.float32) \
        if signed else None
    return src, dst, valid, spiked, sign


def synaptic_input(src, dst, valid, spiked, sign=None) -> np.ndarray:
    """(*lead, n) float32: for each table row, +sign[src] (or +1) at dst for
    every live slot whose source spiked, one row at a time with np.add.at."""
    n, e = spiked.shape[-1], valid.shape[-1]
    rows = int(np.prod(spiked.shape[:-1], dtype=np.int64))
    s, d, v = (a.reshape(rows, e) for a in (src, dst, valid))
    sp = spiked.reshape(rows, n)
    sg = np.ones((rows, n), np.float32) if sign is None else sign.reshape(rows, n)
    out = np.zeros((rows, n), np.float32)
    for r in range(rows):
        hit = v[r] & sp[r][s[r]]
        np.add.at(out[r], d[r][hit], sg[r][s[r][hit]])
    return out.reshape(spiked.shape)
