"""Carry simulation state and configs between the JAX package and the port.

In this system the "weights" are the simulation state and its configs.
Both directions go through numpy arrays and plain values, so this module
needs nothing of the JAX package: a caller flattens the JAX `SimState` into
a dict of numpy arrays (`STATE_FIELDS`), the config dataclasses into dicts
(`dataclasses.asdict`), `KernelParams` into a dict of its fields and a
`ProbeState` into {"cursor", "step0", "buffers": {name: array}}.

Ensemble states carry a leading (K,) axis on every field.  The port keeps
one host step counter for all replicas (they step in lockstep), so the
replicas' steps must agree.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.core.engine import EngineConfig, KernelParams, SimState
from repro_torch.core.msp import MSPConfig, NeuronState
from repro_torch.core.probes import ProbeState
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
_JAX_ONLY = {"backend": _ANY}


def from_jax_state(arrays: dict, device: str | torch.device = "cuda") -> SimState:
    """A port `SimState` on `device` from the JAX `SimState` fields as numpy
    arrays: x, refrac, spiked, calcium, ax_elems, den_elems, src, dst, valid,
    step, dropped.  Ensemble states ((K,)-leading fields) come across whole;
    their K step counters must be equal."""
    dev = _device.resolve(device)
    missing = set(STATE_FIELDS) - set(arrays)
    if missing:
        raise KeyError(f"from_jax_state: missing fields {sorted(missing)}")
    steps = np.unique(np.asarray(arrays["step"]))
    if steps.size != 1:
        raise ValueError(f"from_jax_state: replicas at different steps {steps.tolist()}; "
                         "the port steps an ensemble in lockstep")
    t = lambda name, dt: torch.as_tensor(np.array(arrays[name], dt), device=dev)
    return SimState(
        neurons=NeuronState(**{k: t(k, dt) for k, dt in NEURON_FIELDS.items()}),
        edges=SynapseState(**{k: t(k, dt) for k, dt in EDGE_FIELDS.items()}),
        step=int(steps[0]), dropped=t("dropped", np.int64))


def to_numpy(state: SimState) -> dict:
    """The state's fields as numpy arrays, named and typed as
    `from_jax_state` takes them (step and dropped int32, one per replica)."""
    out = {k: v.cpu().numpy() for k, v in state.neurons._asdict().items()}
    out.update({k: v.cpu().numpy() for k, v in state.edges._asdict().items()})
    out["dropped"] = state.dropped.cpu().numpy().astype(np.int32)
    out["step"] = np.full(out["dropped"].shape, state.step, np.int32)
    return out


def params_from_jax(fields: dict) -> KernelParams:
    """Port `KernelParams` (float32 numpy) from the JAX KernelParams' fields
    as numpy arrays (scalars, or (K,) columns)."""
    return KernelParams(*(np.asarray(fields[f], np.float32) for f in KernelParams._fields))


def params_to_numpy(params: KernelParams) -> dict:
    return {f: np.asarray(v, np.float32) for f, v in params._asdict().items()}


def probe_state_from_jax(arrays: dict, device: str | torch.device = "cuda") -> ProbeState:
    """A port `ProbeState` on `device` from {"cursor", "step0", "buffers":
    {name: array}} (the JAX ProbeState's leaves as numpy arrays)."""
    dev = _device.resolve(device)
    return ProbeState(cursor=np.asarray(arrays["cursor"], np.int32),
                      step0=np.asarray(arrays["step0"], np.int32),
                      buffers={k: torch.as_tensor(np.array(v), device=dev)
                               for k, v in arrays["buffers"].items()})


def probe_state_to_numpy(ps: ProbeState) -> dict:
    return {"cursor": np.asarray(ps.cursor, np.int32), "step0": np.asarray(ps.step0, np.int32),
            "buffers": {k: v.cpu().numpy() for k, v in ps.buffers.items()}}


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


DISTRIBUTED_OPTIONS = ("pyramid_partials", "find_phase", "pyramid_exchange",
                       "routed_shared_levels")


def distributed_options_from_jax(fields: dict) -> dict:
    """The keyword options of the port's `DistributedPlasticityEngine` from a
    JAX `DistributedPlasticityEngine`'s attributes of the same names (the
    engine validates their values)."""
    unknown = set(fields) - set(DISTRIBUTED_OPTIONS)
    if unknown:
        raise KeyError(f"DistributedPlasticityEngine has no option {sorted(unknown)}")
    return dict(fields)


def configs_from_jax(msp: dict, fmm: dict, engine: dict):
    """(MSPConfig, FMMConfig, EngineConfig) of the port from the JAX configs'
    fields."""
    return (_port_config(MSPConfig, msp), _port_config(FMMConfig, fmm),
            _port_config(EngineConfig, engine))
