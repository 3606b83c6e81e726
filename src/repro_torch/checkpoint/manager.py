"""Checkpoints: atomic save and restore of nested state, with an async
writer (port of `repro/checkpoint/manager.py`, same layout on disk).

A save publishes one `step_<n:09d>/` directory holding `arrays.npz` (one
array per leaf, keyed by its path) and `manifest.json` (each array's shape
and dtype, and the step).  Paths are keyed as the JAX package keys them:
NamedTuple fields as `.name`, dict entries by key, tuple items by index,
joined with `|` (`0|.neurons|.x`, `1|.buffers|spikes`).  So a checkpoint
that the JAX package wrote of its `(SimState, ProbeState)` restores into the
port's template, and the reverse.

Leaves are tensors, numpy arrays and host ints.  Where the port's types
differ from the JAX package's, the manifest says how each leaf is stored
(`"stored"`): the port's `SimState.step` is a host int, saved as a 0-d int64
array (the JAX package saves an int32 array), its `dropped` an int64 tensor
(int32 there).  A restore converts each array to the template leaf's type,
dtype and device.  numpy has no bfloat16: a bf16 tensor is stored as its
int16 bits (`"stored": "bfloat16 bits"`) and restored bit for bit; the JAX
package stores bf16 as uint16 bits, which restore the same way.  A None
leaf (an `OptState` without master weights) holds nothing, as a JAX tree's
None does.

Properties: atomic publish (write a temporary directory, fsync, rename);
async mode copies to the host at once and writes on a background thread;
retention (`keep`) and `latest_step()`.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

_SEP = "|"


def _leaves(tree: Any, path: Tuple[str, ...] = ()):
    """(key, leaf) pairs of a nested NamedTuple / dict / tuple / list."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, v in zip(tree._fields, tree):
            yield from _leaves(v, path + (f".{name}",))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    elif tree is not None:
        yield _SEP.join(path), tree


def _rebuild(template: Any, fetch, path: Tuple[str, ...] = ()):
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_rebuild(v, fetch, path + (f".{n}",))
                                for n, v in zip(template._fields, template)))
    if isinstance(template, dict):
        return {k: _rebuild(v, fetch, path + (str(k),)) for k, v in template.items()}
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(v, fetch, path + (str(i),))
                              for i, v in enumerate(template))
    if template is None:
        return None
    return fetch(_SEP.join(path), template)


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as a numpy array that no later write to the leaf can change,
    and how it is stored."""
    if isinstance(leaf, torch.Tensor):
        host = leaf.detach().to("cpu", copy=True)
        if host.dtype == torch.bfloat16:
            return host.view(torch.int16).numpy(), "bfloat16 bits"
        return host.numpy(), "tensor"
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        return np.array(leaf, np.int64), "host int"
    return np.array(leaf), "numpy"


def host_copy(tree: Any) -> Dict[str, Tuple[np.ndarray, str]]:
    """Every leaf copied to the host, keyed by its path."""
    return {key: _to_host(leaf) for key, leaf in _leaves(tree)}


def _publish(host: Dict[str, Tuple[np.ndarray, str]], directory: str, step: int) -> str:
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f".tmp_step_{step:09d}")
    final = os.path.join(directory, f"step_{step:09d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
        np.savez(f, **{k: a for k, (a, _) in host.items()})
        f.flush()
        os.fsync(f.fileno())
    manifest = {"step": int(step),
                "arrays": {k: {"shape": list(a.shape), "dtype": a.dtype.name, "stored": how}
                           for k, (a, how) in host.items()}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save_pytree(tree: Any, directory: str, step: int) -> str:
    """Synchronous atomic save; returns the published path."""
    return _publish(host_copy(tree), directory, step)


def _restore_leaf(arr: np.ndarray, leaf, key: str):
    if isinstance(leaf, torch.Tensor):
        shape = tuple(leaf.shape)
    else:
        shape = np.shape(leaf)
    if tuple(arr.shape) != shape:
        raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {shape}")
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16 and arr.dtype in (np.int16, np.uint16):
            bits = torch.from_numpy(np.array(arr).view(np.int16))
            return bits.view(torch.bfloat16).to(leaf.device)
        return torch.from_numpy(np.array(arr)).to(device=leaf.device, dtype=leaf.dtype)
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        return int(arr)
    return np.asarray(arr, dtype=np.asarray(leaf).dtype)


def restore_pytree(template: Any, directory: str,
                   step: Optional[int] = None) -> Tuple[Any, int]:
    """Restore into the structure, types, dtypes and devices of `template`;
    returns (tree, step)."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:09d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        def fetch(key, leaf):
            if key not in manifest["arrays"]:
                raise KeyError(f"checkpoint missing {key}")
            return _restore_leaf(data[key], leaf, key)
        tree = _rebuild(template, fetch)
    return tree, manifest["step"]


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory) if d.startswith("step_")]
    return max(steps) if steps else None


class CheckpointManager:
    """Retention and an optional async writer thread.  `save` copies the
    tree to the host before it returns, so later writes to its tensors (the
    probe buffers are written in place) do not reach the checkpoint."""

    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._q: "queue.Queue" = queue.Queue(maxsize=2)
        self._errors: List[BaseException] = []
        self._thread: Optional[threading.Thread] = None
        if async_save:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            host, step = item
            try:
                _publish(host, self.directory, step)
                self._gc()
            except Exception as e:          # surfaced on the next save()/wait()/close()
                self._errors.append(e)
            finally:
                self._q.task_done()

    def _gc(self):
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.directory)
                       if d.startswith("step_"))
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"), ignore_errors=True)

    def save(self, tree: Any, step: int):
        if self._errors:
            raise self._errors.pop()
        host = host_copy(tree)
        if self.async_save:
            self._q.put((host, step))
        else:
            _publish(host, self.directory, step)
            self._gc()

    def wait(self):
        if self.async_save:
            self._q.join()
        if self._errors:
            raise self._errors.pop()

    def restore(self, template: Any, step: Optional[int] = None):
        return restore_pytree(template, self.directory, step)

    def close(self):
        if self._thread is not None:
            self._q.put(None)
            self._thread.join()
            self._thread = None
        if self._errors:
            raise self._errors.pop()
