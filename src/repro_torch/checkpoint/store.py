"""Flat-key npz checkpoint store (cf. ``repro.checkpoint.store``).

One ``ckpt_{step:08d}.npz`` per step, written to a ``.tmp`` file and then
renamed into place.  Each leaf is one array, keyed by its path joined with
``|`` as ``jax.tree_util.tree_flatten_with_path`` names it: dict keys in
sorted order, dataclass and NamedTuple field names
(``state|opt|mu|embed|table``), tuple and list indices
(``state|tstates|0|...``); ``None`` and empty containers hold no leaf.
A dataclass field marked static (``metadata={"static": True}``, as the
registry's spec and the span ring's capacity are: JAX's meta fields) holds
no leaf either; a restore takes it from ``like``.
A dtype numpy cannot store (bfloat16, the float8 types) is stored as an
unsigned bit view under ``key::dtype``.  So each package reads the
other's files.

A Python int leaf (the port's ``OptState.step``) is stored as an int32
0-d array, as the JAX optimizer keeps it, and restored as an int.

The JAX store's ``restore(key_aliases=)``, its migration path from
checkpoints of an older state layout, is not ported: no such checkpoint
of the port exists.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch

Tree = Any
_SEP = "|"
#: dtypes numpy cannot serialise: (key tag, unsigned type of their width)
_VIEW = {torch.bfloat16: ("bfloat16", np.uint16),
         torch.float8_e4m3fn: ("float8_e4m3fn", np.uint8),
         torch.float8_e5m2: ("float8_e5m2", np.uint8)}
_BY_TAG = {tag: dtype for dtype, (tag, _) in _VIEW.items()}


def _map_with_path(fn: Callable[[Tuple[str, ...], Any], Any], node: Tree,
                   path: Tuple[str, ...] = ()) -> Tree:
    """``node`` rebuilt with every leaf replaced by ``fn(path, leaf)``,
    the containers walked in JAX's flattening order."""
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _map_with_path(fn, node[k], path + (str(k),))
                for k in sorted(node)}
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return dataclasses.replace(node, **{
            fl.name: _map_with_path(fn, getattr(node, fl.name),
                                    path + (fl.name,))
            for fl in dataclasses.fields(node)
            if not fl.metadata.get("static")})
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_map_with_path(fn, getattr(node, name),
                                           path + (name,))
                            for name in node._fields))
    if isinstance(node, (tuple, list)):
        return type(node)(_map_with_path(fn, x, path + (str(i),))
                          for i, x in enumerate(node))
    return fn(path, node)


def _to_numpy(leaf: Union[torch.Tensor, int]) -> Tuple[str, np.ndarray]:
    """(key suffix, array) of one leaf."""
    if isinstance(leaf, int):
        return "", np.asarray(leaf, np.int32)
    if not isinstance(leaf, torch.Tensor):
        raise TypeError(f"cannot checkpoint a leaf of type "
                        f"{type(leaf).__name__}")
    t = leaf.detach().cpu()
    if t.dtype in _VIEW:
        tag, bits = _VIEW[t.dtype]
        raw = t.contiguous().reshape(-1).view(torch.uint8).numpy()
        return f"::{tag}", raw.view(bits).reshape(tuple(t.shape))
    return "", t.numpy()


def save(directory: str, step: int, tree: Tree) -> str:
    """Write ``tree`` as ``directory/ckpt_{step:08d}.npz``; returns the
    path."""
    os.makedirs(directory, exist_ok=True)
    arrays = {}

    def put(path, leaf):
        suffix, arr = _to_numpy(leaf)
        arrays[_SEP.join(path) + suffix] = arr

    _map_with_path(put, tree)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
    os.replace(tmp, path)
    return path


def latest_step(directory: str) -> Optional[int]:
    """The largest step checkpointed in ``directory`` (None: none)."""
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := re.match(r"ckpt_(\d+)\.npz$", f))]
    return max(steps) if steps else None


def _tensor(arr: np.ndarray, tag: str) -> torch.Tensor:
    if not tag:
        return torch.from_numpy(arr)
    raw = torch.from_numpy(np.ascontiguousarray(arr).reshape(-1)
                           .view(np.uint8))
    return raw.view(_BY_TAG[tag]).reshape(arr.shape)


def restore(directory: str, step: int, like: Tree, *,
            device: Optional[Union[str, torch.device]] = None) -> Tree:
    """The checkpoint of ``step`` in the structure of ``like``: every key
    must be there with ``like``'s shape; each tensor lands on ``like``'s
    dtype and device (or on ``device``), an int leaf as an int."""
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    with np.load(path) as data:
        tagged = {}
        for k in data.files:
            base, _, tag = k.partition("::")
            tagged[base] = (k, tag)

        def load(kpath, leaf):
            ks = _SEP.join(kpath)
            if ks not in tagged:
                raise KeyError(f"checkpoint missing key {ks!r}")
            key, tag = tagged[ks]
            arr = data[key]
            shape = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) \
                else ()
            if tuple(arr.shape) != shape:
                raise ValueError(f"shape mismatch for {ks}: "
                                 f"{arr.shape} vs {shape}")
            if not isinstance(leaf, torch.Tensor):
                return type(leaf)(arr)
            return _tensor(arr, tag).to(
                device=leaf.device if device is None else device,
                dtype=leaf.dtype)

        return _map_with_path(load, like)
