"""The LM's layout while a step runs, and the activation anchors (port of
`repro/sharding/hints.py`).

The reference installs its mesh at trace time and pins three activation
layouts with `with_sharding_constraint`, from which XLA derives the
collectives.  The port's ranks are processes: a step installs its layout
here (`layout`, or `set_mesh` as the reference's steps call it), the layers
read it (`models/tp.py`) and compute their blocks, and each anchor returns
its input in the anchor's layout:

    hint_batch(x)               the rank's block of the batch, whole over
                                model (every layer of the port leaves its
                                output so: the identity)
    hint_logits(x, vocab)       (B, ..., V) with the vocab over model: the
                                rank's block of a whole vocab, the identity
                                on a block
    hint_moe_buffer(x, experts) (B, E, C, d) with the experts over model: the
                                rank's experts of a whole buffer, the
                                identity on a block

A whole value's block is a view (every rank holds the whole value, so
no collective is needed); no anchor is ever handed a layout it would have
to gather.  Under the DP-over-model posture the model axis carries batch
blocks and every anchor is the identity; with no layout installed every
anchor is the identity and the layers run their single-device code.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional

from repro_torch.sharding import rules

_state = threading.local()


def set_mesh(mesh, dp_over_model: bool = False, unit: Optional[Callable] = None) -> None:
    """Install `mesh` (an `LMGroups` layout, or None) for this thread.  unit:
    the context-manager factory the serving steps enter around each unit's
    use of its weights (`models.model`'s units; None: the modules' own)."""
    _state.mesh, _state.dp, _state.unit = mesh, dp_over_model, unit


def get_mesh():
    return getattr(_state, "mesh", None)


def dp_over_model() -> bool:
    return getattr(_state, "dp", False)


def get_unit() -> Optional[Callable]:
    return getattr(_state, "unit", None)


def installed() -> tuple:
    """(mesh, dp_over_model, unit) as installed on this thread: `layout`'s
    arguments, to install the same on another thread."""
    return get_mesh(), dp_over_model(), get_unit()


@contextlib.contextmanager
def layout(mesh, dp_over_model: bool = False, unit: Optional[Callable] = None):
    """`set_mesh` while the block runs, the previous layout restored after."""
    saved = installed()
    set_mesh(mesh, dp_over_model, unit)
    try:
        yield
    finally:
        set_mesh(*saved)


def model_group():
    """The group of the model axis under the tensor-parallel posture (a
    layout is installed and the model axis does not carry batch blocks);
    None otherwise."""
    mesh = get_mesh()
    if mesh is None or dp_over_model():
        return None
    return mesh.group((rules.MODEL,))


def model_block(x, dim: int, whole: int):
    """x's block along `dim` of the model axis, where a tensor-parallel
    layout cuts a dim of `whole` entries over it (`rules._spec`'s
    divisibility), else x; x is whole there or already the block."""
    g = model_group()
    if g is None or whole % g.size:
        return x
    per = whole // g.size
    if x.shape[dim] == per:
        return x
    if x.shape[dim] != whole:
        raise ValueError(f"anchor: dim {dim} has {x.shape[dim]} entries, neither the whole "
                         f"{whole} nor a block of {per}")
    return x.narrow(dim, g.rank * per, per)


def hint_batch(x):
    """The rank's batch block, whole over model.  The port's layers produce
    exactly that (each rank computes its own rows, and every tensor-parallel
    partial is summed over model before it leaves its layer)."""
    return x


def hint_logits(x, vocab: int):
    """(B, ..., V) logits with the vocab over model (TP posture); the DP
    posture and a vocab that model does not divide leave them whole."""
    return model_block(x, x.dim() - 1, vocab)


def hint_moe_buffer(x, experts: int):
    """(B, E, C, d) MoE dispatch buffer with the experts over model (TP
    posture): the rank fills and runs only its experts' slice."""
    return model_block(x, 1, experts)
