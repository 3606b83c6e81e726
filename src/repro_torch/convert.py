"""Carry simulation state and configs between the JAX package and the port.

In this system the "weights" are the simulation state and its configs.
Both directions go through numpy arrays and plain values, so this module
needs nothing of the JAX package: a caller flattens the JAX `SimState` into
a dict of numpy arrays (`STATE_FIELDS`) and the config dataclasses into
dicts (`dataclasses.asdict`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.engine import EngineConfig, SimState
from repro_torch.core.msp import MSPConfig, NeuronState
from repro_torch.core.synapses import SynapseState
from repro_torch.core.traversal import FMMConfig

NEURON_FIELDS = {"x": np.float32, "refrac": np.int32, "spiked": np.bool_,
                 "calcium": np.float32, "ax_elems": np.float32,
                 "den_elems": np.float32}
EDGE_FIELDS = {"src": np.int32, "dst": np.int32, "valid": np.bool_}
STATE_FIELDS = tuple(NEURON_FIELDS) + tuple(EDGE_FIELDS) + ("step", "dropped")

# JAX-only config fields the port does not have, and the one value of each it
# can take over (the JAX defaults, and every backend: the port has no
# backend switch, its kernels run wherever a card is).
_ANY = object()
_JAX_ONLY = {"backend": _ANY, "taylor_chunk": 1 << 30, "guard_delta": None}


def from_jax_state(arrays: dict, device: str | torch.device = "cuda") -> SimState:
    """A port `SimState` on `device` from the JAX `SimState` fields as numpy
    arrays: x, refrac, spiked, calcium, ax_elems, den_elems, src, dst, valid,
    step, dropped."""
    dev = _device.resolve(device)
    missing = set(STATE_FIELDS) - set(arrays)
    if missing:
        raise KeyError(f"from_jax_state: missing fields {sorted(missing)}")
    t = lambda name, dt: torch.as_tensor(np.ascontiguousarray(arrays[name], dt),
                                         device=dev)
    return SimState(
        neurons=NeuronState(**{k: t(k, dt) for k, dt in NEURON_FIELDS.items()}),
        edges=SynapseState(**{k: t(k, dt) for k, dt in EDGE_FIELDS.items()}),
        step=int(arrays["step"]),
        dropped=torch.as_tensor(int(arrays["dropped"]), dtype=torch.int64, device=dev))


def to_numpy(state: SimState) -> dict:
    """The state's fields as numpy arrays, named as `from_jax_state` takes
    them."""
    out = {k: v.cpu().numpy() for k, v in state.neurons._asdict().items()}
    out.update({k: v.cpu().numpy() for k, v in state.edges._asdict().items()})
    out["step"] = np.int32(state.step)
    out["dropped"] = np.int32(state.dropped.item())
    return out


def _port_config(cls, fields: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    kept = {}
    for k, v in fields.items():
        if k in names:
            kept[k] = v
        elif k in _JAX_ONLY:
            allowed = _JAX_ONLY[k]
            if allowed is not _ANY and v != allowed:
                raise NotImplementedError(f"{cls.__name__}: {k}={v!r} is not ported")
        else:
            raise KeyError(f"{cls.__name__} has no field {k!r}")
    return cls(**kept)


def configs_from_jax(msp: dict, fmm: dict, engine: dict):
    """(MSPConfig, FMMConfig, EngineConfig) of the port from the JAX configs'
    fields."""
    return (_port_config(MSPConfig, msp), _port_config(FMMConfig, fmm),
            _port_config(EngineConfig, engine))
