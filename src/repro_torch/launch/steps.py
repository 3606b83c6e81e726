"""Train / prefill / decode step factories (port of `repro.launch.steps`,
single device).

`input_specs` gives each model input of a shape cell as a shape and a dtype;
`make_train_step` returns the function a trainer calls, `make_prefill_step`
and `make_decode_step` the ones a server calls (under inference mode).  The
single-device port has no sharding arguments, and no `abstract_*` or
`*_shardings` builders: those exist only over a mesh.

A `TrainState`'s params are the model's own parameters (`init_train_state`,
`bind`), and a train step updates them and the optimizer state in place
(`optim.adamw`); `clone_state` copies a state to keep it.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch
from torch.profiler import record_function

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.optim import adamw


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]   # name -> the model's parameter
    opt: adamw.OptState
    step: torch.Tensor                # 0-d int32


class Spec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Spec]:
    """Shape and dtype of every model input of this cell."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":    # one new token against a seq_len cache
        return {"token": Spec((b, 1), torch.int32), "cache_pos": Spec((), torch.int32)}
    if cfg.family == "audio":
        specs = {"inputs": Spec((b, s, cfg.frontend_dim), torch.float32)}
    else:
        specs = {"inputs": Spec((b, s), torch.int32)}
    if shape.kind == "train":
        specs["labels"] = Spec((b, s), torch.int32)
    return specs


def init_train_state(model: M.LMModel, opt_cfg: adamw.OptConfig) -> TrainState:
    params = dict(model.named_parameters())
    dev = next(iter(params.values())).device
    return TrainState(params=params, opt=adamw.init(params, opt_cfg),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def clone_state(state: TrainState) -> TrainState:
    """Every tensor of the state copied (the params as plain tensors; `bind`
    puts them back into a model)."""
    copy = lambda tree: None if tree is None else {k: v.detach().clone()
                                                   for k, v in tree.items()}
    o = state.opt
    return TrainState(params=copy(state.params),
                      opt=adamw.OptState(copy(o.mu), copy(o.nu), copy(o.master),
                                         o.count.clone()),
                      step=state.step.clone())


@torch.no_grad()
def bind(model: M.LMModel, state: TrainState) -> TrainState:
    """`state` with its params copied into `model`'s parameters (a restored
    or cloned state), and its params now those parameters."""
    params = dict(model.named_parameters())
    if set(params) != set(state.params):
        raise KeyError(f"bind: {sorted(set(params) ^ set(state.params))} not in both")
    for k, p in params.items():
        if state.params[k] is not p:
            p.copy_(state.params[k])
    return state._replace(params=params)


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.OptConfig, remat: bool = True):
    """train_step(model, state, batch) -> (state, metrics): the loss and its
    gradients, one AdamW update; metrics `loss`, `grad_norm` and `lr` at the
    new count, as the reference's (0-d tensors on the device)."""
    def train_step(model: M.LMModel, state: TrainState, batch) -> Tuple[TrainState, Dict]:
        with record_function("lm.train_step"):
            names = list(state.params)
            with record_function("lm.loss"):
                loss = M.loss_fn(model, batch["inputs"], batch["labels"], remat=remat)
            with record_function("lm.backward"):
                grads = dict(zip(names, torch.autograd.grad(
                    loss, [state.params[k] for k in names])))
            with record_function("lm.optim"):
                params, opt = adamw.update(grads, state.opt, state.params, opt_cfg)
                metrics = {"loss": loss.detach(), "grad_norm": adamw.global_norm(grads),
                           "lr": adamw.schedule(opt_cfg, opt.count)}
            return TrainState(params=params, opt=opt, step=state.step + 1), metrics
    return train_step


def make_prefill_step(cfg: ModelConfig):
    if cfg.is_encoder:
        # Encoder-only archs have no decode, hence no cache: "prefill" is the
        # full bidirectional forward (the serving operation for hubert).
        @torch.inference_mode()
        def encode_step(params, batch):
            return M.forward_train(params, batch["inputs"])
        return encode_step

    @torch.inference_mode()
    def prefill_step(params, caches, batch):
        return M.forward_prefill(params, batch["inputs"], caches)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    @torch.inference_mode()
    def serve_step(params, caches, batch):
        return M.forward_decode(params, batch["token"], caches, batch["cache_pos"])
    return serve_step
