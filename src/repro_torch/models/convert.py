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

The other way round, ``reference_leaves(model)`` lists the reference's
leaves in its pytree order (dict keys sorted at each level), each with
the port parameters that make it: one, or the L layers of a stacked
group. ``reference_tree`` stacks any per-parameter tensors (parameters,
gradients) into the reference's nested layout and ``load_tree`` writes
such a tree back into the parameters, so the optimizer, the clip, the
gradient compression and the checkpoint all see the reference's leaves:
a stacked norm scale is one ``(L, d)`` leaf, as the reference's is.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, List, NamedTuple, Tuple

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


class RefLeaf(NamedTuple):
    """One leaf of the reference's parameter pytree."""
    path: Tuple[str, ...]            # its keys from the root
    names: Tuple[str, ...]           # the port parameters, in layer order
    params: Tuple[torch.nn.Parameter, ...]
    stacked: bool                    # a scanned group: axis 0 is the layer


def reference_leaves(model: torch.nn.Module) -> List[RefLeaf]:
    """The reference's leaves of a port ``LM``, in ``jax.tree`` order."""
    groups: Dict[Tuple[str, ...], list] = {}
    for name, p in model.named_parameters():
        parts = tuple(name.split("."))
        if parts[0] in STACKED:
            key, layer = (parts[0],) + parts[2:], int(parts[1])
        else:
            key, layer = parts, -1
        groups.setdefault(key, []).append((layer, name, p))
    out = []
    for key in sorted(groups):
        items = sorted(groups[key], key=lambda t: t[0])
        out.append(RefLeaf(key, tuple(n for _, n, _ in items),
                           tuple(p for _, _, p in items), items[0][0] >= 0))
    return out


def reference_tree(leaves: List[RefLeaf],
                   get: Callable[[str, torch.Tensor], torch.Tensor]) -> dict:
    """The reference's nested-dict layout whose leaf is ``get(name, param)``
    of its parameter, or those of a stacked group's layers stacked along a
    new axis 0 (a copy)."""
    tree: dict = {}
    for leaf in leaves:
        vals = [get(n, p) for n, p in zip(leaf.names, leaf.params)]
        node = tree
        for k in leaf.path[:-1]:
            node = node.setdefault(k, {})
        node[leaf.path[-1]] = _stack(vals) if leaf.stacked else vals[0]
    return tree


def _stack(vals):
    if vals[0].device.type == "meta":     # shapes only (stack on meta is slow)
        return torch.empty((len(vals),) + tuple(vals[0].shape),
                           dtype=vals[0].dtype, device="meta")
    return torch.stack(vals)


def reference_params(model: torch.nn.Module) -> dict:
    """The model's parameters in the reference's layout (detached;
    zamba's absent ``tail`` a ``None`` as in the reference's ``init``)."""
    tree = reference_tree(reference_leaves(model), lambda n, p: p.detach())
    if model.cfg.block_pattern == "zamba" and "tail" not in tree:
        tree["tail"] = None
    return tree


def load_tree(leaves: List[RefLeaf], tree: dict) -> None:
    """Copy a reference-layout tree of tensors into the parameters, in
    place (a stacked leaf layer by layer)."""
    with torch.no_grad():
        for leaf in leaves:
            v = tree
            for k in leaf.path:
                v = v[k]
            if leaf.stacked:
                for p, layer in zip(leaf.params, v):
                    p.copy_(layer)
            else:
                leaf.params[0].copy_(v)


def to_reference_tree(model: torch.nn.Module,
                      tensors: Dict[str, torch.Tensor]) -> dict:
    """``tensors`` keyed by port parameter name (gradients, say) in the
    reference's nested layout, as numpy float32."""
    tree = reference_tree(reference_leaves(model),
                          lambda n, p: tensors[n].detach().float().cpu())

    def to_numpy(node):
        if isinstance(node, dict):
            return {k: to_numpy(v) for k, v in node.items()}
        return node.numpy()
    return to_numpy(tree)
