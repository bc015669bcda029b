"""Checkpointing with an atomic manifest commit and an async writer.

The counterpart of ``repro.checkpoint.checkpoint``, with its layout:
  <dir>/step_000123/
      shard_0.npz             every leaf of the tree (one process)
      MANIFEST.json           ``step``, ``time``, ``leaves`` (shape and
                              dtype by path) and ``n_hosts``; the
                              directory is committed by renaming
                              ``.tmp_step_*`` after both are written, so a
                              directory without a manifest is never read
                              and is garbage-collected.

A tree is nested dicts, NamedTuples and sequences of tensors (or numpy
arrays), ``None`` for an absent leaf; the leaf paths are the reference's
(``params/blocks/attn/wq``, ``opt/inner/m/...``). bf16 leaves go to disk as
float32 and come back as bf16 (bit for bit), as in the reference.
``restore`` places the leaves on ``device``, which defaults to ``"cuda"``,
or with ``shardings`` (a tree of ``distributed.sharding.NamedSharding``)
straight into the pieces of a mesh. A leaf held as pieces
(``ShardedTensor``) is saved whole, assembled on the host, as the
reference saves a sharded state.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..distributed.sharding import ShardedTensor, ShardStore
from ..models.lm import require_cuda


def _flatten(tree) -> Dict[str, Any]:
    flat = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}" if path else k)
        elif isinstance(node, (list, tuple)) and not hasattr(node, "shape"):
            if hasattr(node, "_fields"):      # NamedTuple
                for k, v in zip(node._fields, node):
                    walk(v, f"{path}/{k}" if path else k)
            else:
                for i, v in enumerate(node):
                    walk(v, f"{path}/{i}")
        elif node is None:
            flat[path] = None
        else:
            flat[path] = node

    walk(tree, "")
    return flat


def _unflatten_into(treedef_example, flat: Dict[str, Any]):
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}" if path else k)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)) and not hasattr(node, "shape"):
            if hasattr(node, "_fields"):
                vals = [walk(v, f"{path}/{k}" if path else k)
                        for k, v in zip(node._fields, node)]
                return type(node)(*vals)
            return type(node)(walk(v, f"{path}/{i}")
                              for i, v in enumerate(node))
        if node is None:
            return None
        return flat[path]

    return walk(treedef_example, "")


def _to_host(v) -> Optional[np.ndarray]:
    """A leaf as a numpy array of its own (a copy: the caller may update
    the tensor in place while the writer runs); bf16 as float32, which
    numpy can store (``restore`` casts back per the example); a sharded
    leaf whole."""
    if v is None:
        return None
    if isinstance(v, ShardedTensor):
        out = None
        for p in v.pieces:
            part = _to_host(p.data)
            if out is None:
                out = np.empty(v.shape, dtype=part.dtype)
            out[p.index] = part
        return out
    if isinstance(v, torch.Tensor):
        t = v.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()
    return np.array(v)


def save(ckpt_dir: str, step: int, tree, blocking: bool = True,
         keep: int = 3) -> threading.Thread:
    """Save a tree of tensors. The leaves are copied to host memory before
    this returns; the files are written on a daemon thread, joined here
    when ``blocking``. Keeps the newest ``keep`` complete checkpoints."""
    host = {k: _to_host(v) for k, v in _flatten(tree).items()}
    meta = {k: (None if v is None else
                dict(shape=list(v.shape), dtype=str(v.dtype)))
            for k, v in host.items()}

    def write():
        d = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
        tmp = pathlib.Path(ckpt_dir) / f".tmp_step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "shard_0.npz",
                 **{k: v for k, v in host.items() if v is not None})
        manifest = {"step": step, "time": time.time(), "leaves": meta,
                    "n_hosts": 1}
        (tmp / "MANIFEST.json").write_text(json.dumps(manifest))
        if d.exists():
            shutil.rmtree(d)
        os.rename(tmp, d)           # atomic commit
        _gc(ckpt_dir, keep)

    t = threading.Thread(target=write, daemon=True)
    t.start()
    if blocking:
        t.join()
    return t


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(complete_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(pathlib.Path(ckpt_dir) / f"step_{s:08d}",
                      ignore_errors=True)
    # half-written junk
    for p in pathlib.Path(ckpt_dir).glob(".tmp_step_*"):
        shutil.rmtree(p, ignore_errors=True)


def complete_steps(ckpt_dir: str):
    root = pathlib.Path(ckpt_dir)
    if not root.exists():
        return []
    out = []
    for p in root.glob("step_*"):
        if (p / "MANIFEST.json").exists():
            out.append(int(p.name.split("_")[1]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = complete_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, example_tree, step: Optional[int] = None,
            device="cuda", shardings=None) -> Tuple[int, Any]:
    """Restore the newest complete checkpoint (or ``step``) into the
    structure of ``example_tree``: each leaf a tensor on ``device`` with
    the example leaf's dtype; with ``shardings`` (``example_tree``'s
    structure) each leaf cut from the host copy into its pieces on the
    sharding's mesh (``device`` unused), never whole on a device."""
    if shardings is None:
        require_cuda(device)
    else:
        stores = {}
        sh = dict(_flatten(shardings))
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint in {ckpt_dir}")
    d = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    flat = {}
    with np.load(d / "shard_0.npz") as data:
        for k, v in _flatten(example_tree).items():
            if v is None:
                flat[k] = None
                continue
            t = torch.from_numpy(data[k])
            dtype = (v.dtype if isinstance(v, (torch.Tensor, ShardedTensor))
                     else torch.from_numpy(np.empty(0, np.asarray(v).dtype))
                     .dtype)
            if shardings is None:
                flat[k] = t.to(device=device, dtype=dtype)
                continue
            ns = sh[k]
            store = stores.setdefault(ns.mesh, ShardStore(ns.mesh))
            flat[k] = store.shard(t.to(dtype), ns)
    return step, _unflatten_into(example_tree, flat)
