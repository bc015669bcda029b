"""Sharding rules, and the shard store that holds a tensor as its pieces.

The counterpart of ``repro.distributed.sharding``. Mesh axes: ("data",
"model") single-pod, ("pod", "data", "model") multi-pod; "pod" folds into
the data-parallel axes everywhere.

Parallelism mapping (the reference's):
  DP    batch over dp axes
  TP    heads / d_ff / vocab / d_inner over "model"
  EP    MoE experts over "model"
  SP    long-context decode: KV-cache sequence over "model" (+ dp when the
        batch does not divide) — flash-decoding's split
  FSDP  optional: the largest free dim of every big leaf over dp

Every rule checks divisibility and falls back to replication, as the
reference's does. ``P`` and ``NamedSharding`` are the port's own
``PartitionSpec`` and ``NamedSharding``: a spec holds, a dim, ``None``, an
axis name or a tuple of names (major to minor).

The shard store (:class:`ShardStore`) is how the port holds a leaf on a
mesh in one process: :meth:`ShardStore.shard` cuts it into its distinct
pieces. A piece the reference replicates along axes outside its spec is
held once, on the position where those axes are 0 (as relations are in
``core.distributed``), so a sharded leaf takes the unsharded leaf's
memory. :meth:`ShardStore.gather` rebuilds the leaf bit for bit on a
position, :meth:`ShardStore.scatter_add` cuts a whole leaf back into the
pieces and adds it there; each counts the bytes of the pieces it moves
between positions, by the reference's collective name.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from collections import Counter
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..core.distributed import Mesh

# Positions a node (8 cards joined by NVLink); a move between positions
# of two nodes crosses the network.
CARDS_PER_NODE = 8


class P(tuple):
    """A partition spec: one entry a dim (``None``, an axis name, or a
    tuple of axis names); trailing dims not named are unsharded."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def entry_axes(entry) -> Tuple[str, ...]:
    """The axis names of one spec entry, major to minor."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def dp_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _size(mesh: Mesh, axes) -> int:
    return math.prod(mesh.axis_size(a) for a in entry_axes(axes))


def _div(n: int, mesh: Mesh, axes) -> bool:
    return n % _size(mesh, axes) == 0


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the reference's ``NamedSharding``."""
    mesh: Mesh
    spec: P

    def dim_axes(self, ndim: int) -> List[Tuple[str, ...]]:
        return [entry_axes(self.spec[i]) if i < len(self.spec) else ()
                for i in range(ndim)]

    def shard_shape(self, shape) -> Tuple[int, ...]:
        """The shape of the piece each position holds."""
        out = []
        for n, axes in zip(shape, self.dim_axes(len(shape))):
            k = _size(self.mesh, axes)
            if n % k:
                raise ValueError(f"dim {n} of {tuple(shape)} does not divide "
                                 f"over {axes} ({k}) in {self.spec}")
            out.append(n // k)
        return tuple(out)

    def axes_used(self) -> Tuple[str, ...]:
        """The mesh axes the spec names, in mesh order."""
        used = {a for e in self.spec for a in entry_axes(e)}
        return tuple(a for a in self.mesh.axis_names if a in used)

    def planned_bytes(self, shape, dtype) -> int:
        """Bytes the plan places on each position (``shard_shape``)."""
        return math.prod(self.shard_shape(shape)) * _itemsize(dtype)

    def pieces(self, shape) -> List[Tuple[Tuple[slice, ...], int]]:
        """Each distinct piece as (its slices of the leaf, the flat mesh
        position that holds it): row-major over the axes the spec uses, the
        other axes at 0."""
        used = self.axes_used()
        local = self.shard_shape(shape)
        dims = self.dim_axes(len(shape))
        out = []
        for coords in itertools.product(*(range(self.mesh.axis_size(a))
                                          for a in used)):
            at = dict(zip(used, coords))
            sl = []
            for n, axes in zip(local, dims):
                idx = 0
                for a in axes:
                    idx = idx * self.mesh.axis_size(a) + at[a]
                sl.append(slice(idx * n, (idx + 1) * n))
            out.append((tuple(sl), position_of(self.mesh, at)))
        return out


def position_of(mesh: Mesh, coords: Dict[str, int]) -> int:
    """The flat (row-major) position of ``coords``, absent axes at 0."""
    flat = 0
    for name, size in zip(mesh.axis_names, mesh.shape):
        flat = flat * size + coords.get(name, 0)
    return flat


def coords_of(mesh: Mesh, position: int) -> Dict[str, int]:
    out = {}
    for name, size in zip(reversed(mesh.axis_names), reversed(mesh.shape)):
        out[name] = position % size
        position //= size
    return out


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


# --------------------------------------------------------------------------
# rules
# --------------------------------------------------------------------------
STACKED_KEYS = ("blocks", "mlstm", "slstm", "mamba", "tail")


class ShardingRules:
    def __init__(self, mesh: Mesh, cfg, fsdp: Optional[bool] = None):
        self.mesh = mesh
        self.cfg = cfg
        self.dp = dp_axes(mesh)
        self.tp = "model"
        self.fsdp = cfg.fsdp if fsdp is None else fsdp

    def ns(self, spec: P) -> NamedSharding:
        return NamedSharding(self.mesh, spec)

    def _heads_shardable(self) -> bool:
        cfg, m = self.cfg, self.mesh
        return (_div(cfg.eff_n_heads, m, self.tp)
                and _div(cfg.eff_n_kv_heads, m, self.tp))

    # ---- parameter specs ----
    def param_spec(self, path: str, leaf) -> P:
        """``path``: the '/'-joined reference key path; a stacked group's
        leaf carries the layer dim first."""
        cfg, m, tp = self.cfg, self.mesh, self.tp
        name = path.split("/")[-1]
        parent = path.split("/")[-2] if "/" in path else ""
        nd = len(leaf.shape)
        stacked = any(s in path for s in STACKED_KEYS) \
            and "shared_attn" not in path
        L = (None,) if stacked else ()

        def with_stack(*dims):
            return P(*(L + tuple(dims)))

        def tp_if(n):
            return tp if _div(n, m, tp) else None

        if name == "table":
            return P(tp, None) if _div(leaf.shape[-2], m, tp) else P(None, None)
        if name in ("enc_pos", "dec_pos"):
            return P(None, None)

        if parent in ("attn", "xattn"):
            hs = self._heads_shardable()
            if name in ("wq", "wk", "wv"):
                return with_stack(None, tp if hs else None, None)
            if name == "wo":
                return with_stack(tp if hs else None, None, None)
            if name in ("bq", "bk", "bv"):
                return with_stack(tp if hs else None, None)

        if name == "router":
            return with_stack(None, tp_if(leaf.shape[-1]))
        if parent == "moe" and not cfg.moe_ep \
                and name in ("w_gate", "w_up", "w_down"):
            return with_stack(None, None, None)
        if parent == "moe" and name in ("w_gate", "w_up"):
            if _div(leaf.shape[-3], m, tp):
                return with_stack(tp, None, None)
            return with_stack(None, None, tp_if(leaf.shape[-1]))
        if parent == "moe" and name == "w_down":
            if _div(leaf.shape[-3], m, tp):
                return with_stack(tp, None, None)
            return with_stack(None, tp_if(leaf.shape[-2]), None)

        if name in ("w_gate", "w_up", "w_in", "w_q", "w_k", "w_v", "w_o",
                    "w_z", "w_x"):
            return with_stack(None, tp_if(leaf.shape[-1]))
        if name in ("w_down", "out_proj"):
            return with_stack(tp_if(leaf.shape[-2]), None)

        if name in ("w_B", "w_C", "w_dt"):
            return with_stack(None, None)
        if name in ("A_log", "dt_bias", "D"):
            return with_stack(tp_if(leaf.shape[-1]))
        if name in ("conv_w", "conv_b", "norm_scale"):
            if _div(leaf.shape[-1], m, tp):
                return with_stack(*((None,) * (nd - len(L) - 1) + (tp,)))
            return with_stack(*((None,) * (nd - len(L))))

        return with_stack(*((None,) * (nd - len(L))))

    def params_shardings(self, params_struct) -> Any:
        def walk(node, path):
            if isinstance(node, dict):
                return {k: walk(v, f"{path}/{k}" if path else k)
                        for k, v in node.items()}
            if isinstance(node, (list, tuple)) and not hasattr(node, "shape"):
                t = [walk(v, f"{path}/{i}") for i, v in enumerate(node)]
                return type(node)(*t) if hasattr(node, "_fields") \
                    else type(node)(t)
            if node is None:
                return None
            return self.ns(self.param_spec(path, node))
        return walk(params_struct, "")

    # ---- batch / cache specs ----
    def batch_spec(self, batch_size: int, rank: int) -> P:
        if batch_size % _size(self.mesh, self.dp) == 0:
            return P(self.dp, *(None,) * (rank - 1))
        return P(*(None,) * rank)

    def kv_cache_spec(self, shape) -> P:
        """(L, B, T, nkv, hd): batch over dp when it divides, else the
        sequence over dp; the sequence also over 'model' past 8,192."""
        _, B, T, _, _ = shape
        dp_ok = B % _size(self.mesh, self.dp) == 0
        tp_seq_ok = T % _size(self.mesh, self.tp) == 0 and T > 8192
        if dp_ok:
            return P(None, self.dp, self.tp if tp_seq_ok else None, None,
                     None)
        if T % _size(self.mesh, self.dp + (self.tp,)) == 0:
            return P(None, None, self.dp + (self.tp,), None, None)
        return P(None, None, None, None, None)

    def state_spec(self, shape) -> P:
        """SSM/xLSTM decode states (L, B, ...)."""
        B = shape[1]
        dp_ok = B % _size(self.mesh, self.dp) == 0
        specs = [None, self.dp if dp_ok else None]
        for d in shape[2:]:
            if d % _size(self.mesh, self.tp) == 0 and self.tp not in specs:
                specs.append(self.tp)
            else:
                specs.append(None)
        return P(*specs)

    def cache_shardings(self, cache_struct) -> Any:
        def leaf_spec(leaf):
            if len(leaf.shape) == 5:
                return self.ns(self.kv_cache_spec(leaf.shape))
            return self.ns(self.state_spec(leaf.shape))
        return tree_map(leaf_spec, cache_struct)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, lists and (Named)tuples,
    ``None`` holding no leaf; the result keeps ``tree``'s structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        out = [tree_map(fn, t, *(r[i] for r in rest))
               for i, t in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    return fn(tree, *rest)


def tree_items(tree, path: str = ""):
    """(path, leaf) of every leaf, in ``tree``'s own order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in tree_items(v, f"{path}/{k}" if path else k)]
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        names = getattr(tree, "_fields", None) or range(len(tree))
        return [kv for n, v in zip(names, tree)
                for kv in tree_items(v, f"{path}/{n}" if path else str(n))]
    return [(path, tree)]


# --------------------------------------------------------------------------
# the shard store
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Piece:
    index: Tuple[slice, ...]       # its slices of the whole leaf
    position: int                  # the flat mesh position holding it
    data: torch.Tensor


@dataclasses.dataclass
class ShardedTensor:
    """A leaf held as its distinct pieces."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    sharding: NamedSharding
    pieces: List[Piece]

    @property
    def ndim(self) -> int:
        return len(self.shape)


class ShardStore:
    """Cuts leaves into pieces on a mesh and moves them between positions,
    counting the bytes moved between positions by collective kind
    (``moved``; positions on one device count too: they are the
    reference's devices), and each position's bytes sent and received
    (``busiest``)."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.moved: Counter = Counter()
        # by position: bytes sent and received, by (kind, crosses nodes)
        self.sent: Dict[int, Counter] = {}
        self.received: Dict[int, Counter] = {}

    def device(self, position: int) -> torch.device:
        return self.mesh.devices[position]

    def _count(self, kind: str, src: int, dst: int, t: torch.Tensor):
        if src != dst:
            n = t.numel() * t.element_size()
            self.moved[kind] += n
            key = (kind, src // CARDS_PER_NODE != dst // CARDS_PER_NODE)
            self.sent.setdefault(src, Counter())[key] += n
            self.received.setdefault(dst, Counter())[key] += n

    def reset_counts(self) -> None:
        self.moved.clear()
        self.sent.clear()
        self.received.clear()

    def busiest(self) -> Counter:
        """The position whose links carry the most: for each (kind,
        crosses nodes), the larger of its bytes sent and received (a
        link carries both directions at once)."""
        best: Counter = Counter()
        for pos in set(self.sent) | set(self.received):
            s, r = self.sent.get(pos, Counter()), self.received.get(
                pos, Counter())
            load = Counter({k: max(s[k], r[k]) for k in set(s) | set(r)})
            if sum(load.values()) > sum(best.values()):
                best = load
        return best

    def shard(self, t: torch.Tensor, sharding: NamedSharding,
              src: Optional[int] = None) -> ShardedTensor:
        """``t`` cut into its pieces, each a copy on its position's device
        (``src``: the position ``t`` comes from, for the count; ``None``
        counts nothing, as for a load from the host)."""
        pieces = []
        for index, pos in sharding.pieces(t.shape):
            part = t[index].to(device=self.device(pos), copy=True)
            if src is not None:
                self._count("reduce-scatter", src, pos, part)
            pieces.append(Piece(index, pos, part))
        return ShardedTensor(tuple(t.shape), t.dtype, sharding, pieces)

    def zeros(self, shape, dtype, sharding: NamedSharding) -> ShardedTensor:
        """A zero leaf made as its pieces (nothing whole is allocated)."""
        local = sharding.shard_shape(shape)
        return ShardedTensor(tuple(shape), dtype, sharding, [
            Piece(index, pos, torch.zeros(local, dtype=dtype,
                                          device=self.device(pos)))
            for index, pos in sharding.pieces(shape)])

    def like(self, st: ShardedTensor, fn) -> ShardedTensor:
        """A leaf of ``st``'s layout whose pieces are ``fn(piece data)``."""
        return ShardedTensor(st.shape, st.dtype, st.sharding, [
            Piece(p.index, p.position, fn(p.data)) for p in st.pieces])

    def gather(self, st: ShardedTensor, position: int = 0,
               kind: str = "all-gather") -> torch.Tensor:
        """The whole leaf on ``position``'s device, bit for bit (a leaf of
        one piece on that device: a new tensor on the piece's storage)."""
        dev = self.device(position)
        if len(st.pieces) == 1:
            p = st.pieces[0]
            self._count(kind, p.position, position, p.data)
            return p.data.detach().to(dev)
        out = torch.empty(st.shape, dtype=st.dtype, device=dev)
        for p in st.pieces:
            self._count(kind, p.position, position, p.data)
            out[p.index] = p.data.to(dev)
        return out

    def gather_groups(self, st: ShardedTensor, axis: str,
                      kind: str = "all-gather"
                      ) -> List[Tuple[int, torch.Tensor, int]]:
        """The leaf cut along ``axis`` only: for each coordinate of
        ``axis``, (its dim's offset, the block gathered over every other
        axis, the position holding it: the others at 0). The expert
        stacks run so, a block a ``model`` coordinate, never whole."""
        dims = st.sharding.dim_axes(st.ndim)
        d = next(i for i, a in enumerate(dims) if axis in a)
        groups: Dict[int, List[Piece]] = {}
        for p in st.pieces:
            groups.setdefault(p.index[d].start, []).append(p)
        n = st.shape[d] // len(groups)
        out = []
        for start in sorted(groups):
            ps = groups[start]
            pos = position_of(self.mesh, {axis: coords_of(
                self.mesh, ps[0].position)[axis]})
            dev = self.device(pos)
            if len(ps) == 1:
                self._count(kind, ps[0].position, pos, ps[0].data)
                out.append((start, ps[0].data.detach().to(dev), pos))
                continue
            shape = list(st.shape)
            shape[d] = n
            block = torch.empty(shape, dtype=st.dtype, device=dev)
            for p in ps:
                self._count(kind, p.position, pos, p.data)
                idx = list(p.index)
                idx[d] = slice(0, n)
                block[tuple(idx)] = p.data.to(dev)
            out.append((start, block, pos))
        return out

    def scatter_add(self, st: ShardedTensor, full: torch.Tensor, src: int,
                    offset: Optional[Dict[int, int]] = None,
                    kind: str = "reduce-scatter") -> None:
        """Add ``full`` (on ``src``: the whole leaf, or with ``offset``
        {dim: start} the block of it that starts there along those dims)
        into the parts of ``st``'s pieces it covers, in place (the
        reduce-scatter of a gradient)."""
        offset = offset or {}
        for p in st.pieces:
            dst, part = [], []
            for d, s in enumerate(p.index):
                if d not in offset:
                    dst.append(slice(None))
                    part.append(s)
                    continue
                start = offset[d]
                lo, hi = max(s.start, start), min(s.stop,
                                                  start + full.shape[d])
                if lo >= hi:
                    break
                dst.append(slice(lo - s.start, hi - s.start))
                part.append(slice(lo - start, hi - start))
            else:
                x = full[tuple(part)]
                self._count(kind, src, p.position, x)
                p.data[tuple(dst)] += x.to(p.data.device, p.data.dtype)

    def resident_bytes(self, tree) -> Dict[torch.device, int]:
        """Bytes of ``tree``'s pieces resident on each ``torch.device``."""
        out: Counter = Counter()
        for _, st in tree_items(tree):
            if isinstance(st, ShardedTensor):
                for p in st.pieces:
                    out[p.data.device] += p.data.numel() * \
                        p.data.element_size()
        return dict(out)


def shard_tensor(t: torch.Tensor, sharding: NamedSharding) -> ShardedTensor:
    """``t`` cut into its distinct pieces on ``sharding``'s mesh."""
    return ShardStore(sharding.mesh).shard(t, sharding)


def gather(st: ShardedTensor, position: int = 0) -> torch.Tensor:
    """``st`` whole again on ``position``'s device, bit for bit."""
    return ShardStore(st.sharding.mesh).gather(st, position)
