"""Carry the reference's weights into the port's modules.

``load_reference_params(model, params)`` takes the parameter pytree of
``repro.models.lm.LM.init`` (nested dicts whose leaves are numpy arrays)
and copies every leaf into the matching parameter of a port ``LM``. A
stacked group (``blocks``, ``mlstm``, ...) is unstacked along its first
axis, layer i into ``<group>.<i>.<rest of the path>``. A leaf with no
place in the port, a shape that differs, or a port parameter left unset
raises. Each leaf is cast to its parameter's dtype; bf16 leaves must come
as float32 (``np.asarray`` of a bf16 array gives a dtype ``torch`` cannot
read), and bf16 -> float32 -> bf16 gives the reference's bits back.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

# The reference's stacked (scanned) groups: axis 0 is the layer.
STACKED = ("blocks", "blocks_local", "blocks_global", "mlstm", "slstm",
           "mamba", "tail", "enc_blocks")


def _leaves(tree, path: Tuple[str, ...] = ()) -> Iterator:
    if tree is None:
        return
    if isinstance(tree, dict):
        for k, sub in tree.items():
            yield from _leaves(sub, path + (str(k),))
        return
    yield path, np.asarray(tree)


def _placements(path, arr):
    if path[0] in STACKED:
        for i in range(arr.shape[0]):
            yield ".".join((path[0], str(i)) + path[1:]), arr[i]
    else:
        yield ".".join(path), arr


def load_reference_params(model: torch.nn.Module, params) -> None:
    """Copy the reference pytree ``params`` into ``model`` (a port ``LM``)."""
    own = dict(model.named_parameters())
    placed = set()
    for path, arr in _leaves(params):
        if arr.dtype.kind not in "fiu":
            raise TypeError(f"reference leaf {'/'.join(path)} has dtype "
                            f"{arr.dtype}; cast it to float32 first")
        for name, a in _placements(path, arr):
            if name not in own:
                raise KeyError(f"reference leaf {name} has no place in "
                               f"the port's {type(model).__name__}")
            p = own[name]
            if tuple(a.shape) != tuple(p.shape):
                raise ValueError(f"{name}: reference shape {a.shape} != "
                                 f"port shape {tuple(p.shape)}")
            with torch.no_grad():
                p.copy_(torch.tensor(a).to(p.dtype))
            placed.add(name)
    missing = sorted(set(own) - placed)
    if missing:
        raise KeyError(f"{len(missing)} port parameters not set by the "
                       f"reference's params: {missing[:5]}")
