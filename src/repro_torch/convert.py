"""Carry simulation state and configs, and the LM substrate's parameter and
cache trees, between the JAX package and the port.

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


# ---------------------------------------------------------------------------
# The LM substrate: parameter and cache trees
# ---------------------------------------------------------------------------
#
# A JAX parameter tree is a nested dict of arrays whose layer stacks
# ("layers", "dense_prefix", "dense_inter") carry a leading (L,) axis; the
# port's `LMModel` holds the same leaves under the same names, one module per
# layer, so the leaf at path ("layers", "attn", "wq") row i is the parameter
# "layers.<i>.attn.wq".  A JAX cache tree stacks every group (the hybrid's
# "shared_attn" over its sites too); the port's caches are {group: [per-layer
# dict]}.  bfloat16 crosses as its bits (`torch.from_numpy` refuses
# ml_dtypes' bfloat16), so both directions are exact.


def _leaves(tree: dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _set(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _to_torch(a) -> torch.Tensor:
    a = np.array(a, order="C")               # a writable copy (JAX's arrays are read-only)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes                     # JAX's numpy bfloat16 (not JAX itself)
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _flat_named(tree: dict) -> dict:
    """A JAX LM tree's leaves keyed by the port's parameter names (stacked
    leaves split into one name per layer)."""
    from repro_torch.models.model import STACKS
    flat = {}
    for path, leaf in _leaves(tree):
        leaf = np.asarray(leaf)
        if path[0] in STACKS:
            for i in range(leaf.shape[0]):
                flat[".".join((path[0], str(i)) + path[1:])] = leaf[i]
        else:
            flat[".".join(path)] = leaf
    return flat


def _stack_named(named) -> dict:
    """(name, tensor) pairs as the JAX tree: nested dicts of numpy arrays,
    the layer stacks stacked along a leading axis."""
    from repro_torch.models.model import STACKS
    stacks, out = {}, {}
    for name, p in named:
        path = tuple(name.split("."))
        if path[0] in STACKS:
            stacks.setdefault((path[0],) + path[2:], []).append(_to_numpy(p))
        else:
            _set(out, path, _to_numpy(p))
    for path, rows in stacks.items():
        _set(out, path, np.stack(rows))
    return out


def lm_params_from_jax(tree: dict, cfg, device: str | torch.device = "cuda"):
    """An `LMModel` of `cfg` on `device` holding the JAX parameter tree's
    leaves (numpy arrays, bfloat16 as ml_dtypes'), bit for bit."""
    from repro_torch.models.model import LMModel
    dev = _device.resolve(device)
    flat = _flat_named(tree)
    model = LMModel(cfg, None, dev)
    params = dict(model.named_parameters())
    if set(flat) != set(params):
        raise KeyError(f"lm_params_from_jax: leaves {sorted(set(flat) ^ set(params))} "
                       "are not in both trees")
    with torch.no_grad():
        for name, p in params.items():
            t = _to_torch(flat[name])
            if t.shape != p.shape or t.dtype != p.dtype:
                raise ValueError(f"lm_params_from_jax: {name} is {tuple(t.shape)} {t.dtype}, "
                                 f"the model's {tuple(p.shape)} {p.dtype}")
            p.copy_(t)
    return model


def lm_params_to_numpy(model) -> dict:
    """The model's parameters as the JAX tree: nested dicts of numpy arrays,
    the layer stacks stacked along a leading axis."""
    return _stack_named(model.named_parameters())


# A JAX `TrainState(params, opt=OptState(mu, nu, master, count), step)` with
# numpy leaves (`jax.tree.map(np.asarray, state)`) and the port's
# (`launch.steps.TrainState`, the optimizer's leaves keyed by parameter
# name) cross leaf for leaf and bit for bit; on the way back the state is
# plain dicts of the same trees.


def train_state_from_jax(state, cfg, device: str | torch.device = "cuda"):
    """(model, TrainState) on `device` from a JAX TrainState's numpy leaves;
    the state's params are the model's parameters."""
    from repro_torch.launch.steps import TrainState
    from repro_torch.optim.adamw import OptState
    dev = _device.resolve(device)
    model = lm_params_from_jax(state.params, cfg, dev)
    params = dict(model.named_parameters())

    def named(tree):
        if tree is None:
            return None
        flat = {k: _to_torch(v).to(dev) for k, v in _flat_named(tree).items()}
        if set(flat) != set(params):
            raise KeyError(f"train_state_from_jax: {sorted(set(flat) ^ set(params))}")
        return flat

    scalar = lambda a: torch.tensor(int(np.asarray(a)), dtype=torch.int32, device=dev)
    opt = state.opt
    return model, TrainState(params=params,
                             opt=OptState(named(opt.mu), named(opt.nu), named(opt.master),
                                          scalar(opt.count)),
                             step=scalar(state.step))


def train_state_to_numpy(state) -> dict:
    """{"params", "opt": {"mu", "nu", "master", "count"}, "step"} as the JAX
    trees and int32 scalars."""
    tree = lambda named: None if named is None else _stack_named(named.items())
    scalar = lambda t: np.asarray(int(t), np.int32)
    o = state.opt
    return {"params": tree(state.params),
            "opt": {"mu": tree(o.mu), "nu": tree(o.nu), "master": tree(o.master),
                    "count": scalar(o.count)},
            "step": scalar(state.step)}


def batch_from_jax(batch: dict, device: str | torch.device = "cuda") -> dict:
    """A JAX `make_batch` batch (numpy leaves) as the port's tensors."""
    dev = _device.resolve(device)
    return {k: _to_torch(np.asarray(v)).to(dev) for k, v in batch.items()}


def lm_cache_from_jax(tree: dict, device: str | torch.device = "cuda") -> dict:
    """The port's caches ({group: [per-layer dict]}) from a JAX cache tree."""
    dev = _device.resolve(device)
    out = {}
    for group, leaves in tree.items():
        n = {np.asarray(v).shape[0] for v in leaves.values()}.pop()
        out[group] = [{k: _to_torch(np.asarray(v)[i]).to(dev) for k, v in leaves.items()}
                      for i in range(n)]
    return out


def lm_cache_to_numpy(caches: dict) -> dict:
    """The JAX cache tree (every group stacked) from the port's caches."""
    return {group: {k: np.stack([_to_numpy(c[k]) for c in layers]) for k in layers[0]}
            for group, layers in caches.items()}
