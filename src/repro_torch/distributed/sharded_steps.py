"""Train, prefill and serve steps on a mesh, in one process.

The execution model of ``core.distributed`` (PR 22) for the LM: one
process, no process group, mesh positions that are ``torch.device``s (by
default all the one card). The parameters and the optimizer state live
as pieces in a ``ShardStore``, cut by the reference's plan
(``ShardingRules.params_shardings`` with ``_fsdp_augment``), each piece
held once.

A step runs a ``meta``-device ``LM`` (nothing allocated) with the store's
tensors put in its parameters' places (:func:`bound_tensors`):

* **gather at use** — each dp slice of the batch runs on its dp
  position's device, with every leaf sharded over ``model`` or the fsdp
  axes gathered there (the reference's all-gather); a stacked leaf's
  layer i is ``leaf[i]`` of the gathered leaf, whichever dim was cut;
* **experts over ``model``** (the EP rule) are never gathered whole: each
  ``model`` coordinate's block of an expert stack, gathered over the
  other axes only, runs its own experts on the slots routed to them
  (``models.moe.MoE.expert_pieces``);
* **train** — the slices' losses are weighted by their token counts
  (their sum is the global batch's mean), their gradients added into
  float32 pieces (the dp all-reduce and the reduce-scatter), the clip's
  norm summed over all pieces, and the optimizer run piece by piece;
  Adafactor's factored moments and its RMS clip are reduced over the
  pieces of a sharded dim before use (:func:`adafactor_pieces`);
* **serve** — the cache lives in pieces (``ShardingRules.
  cache_shardings``); each dp slice decodes its rows. A cache cut along
  the sequence is attended piece by piece (``models.attention.
  sdpa_pieces``), never gathered; a state cut over ``model`` on another
  dim is gathered for the step and written back.

Where the reference's GSPMD computes tensor-parallel, this gathers the
weights and computes the slice whole: the results agree within the
tolerances the tests state (ROADMAP C12).
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..models import convert
from ..models.attention import StackedPieces
from ..models.lm import LM
from ..optim import optimizers as opt
from .sharding import (NamedSharding, P, Piece, ShardedTensor,
                       ShardingRules, ShardStore, _size, entry_axes,
                       position_of, tree_items, tree_map)

EXPERT_STACKS = ("w_gate", "w_up", "w_down")


# --------------------------------------------------------------------------
# the sharder hook
# --------------------------------------------------------------------------
class Sharder:
    """The reference's ``make_sharder`` hook. It computes the spec the
    reference would pass to ``with_sharding_constraint`` for ``x``'s
    global shape (the batch dim times ``batch_slices``, since a step runs
    a dp slice at a time), records it in ``last_specs[kind]`` (``None``
    where the reference leaves ``x`` unconstrained) and returns ``x``."""

    def __init__(self, rules: ShardingRules, cfg):
        self.rules, self.cfg = rules, cfg
        self.batch_slices = 1
        self.last_specs: Dict[str, Optional[P]] = {}

    def spec(self, shape, kind: str) -> Optional[P]:
        rules, cfg, mesh = self.rules, self.cfg, self.rules.mesh
        dp, ndim = rules.dp, len(shape)
        model = mesh.axis_size("model")
        b_ok = shape[0] % _size(mesh, dp) == 0
        all_ax = tuple(dp) + ("model",)
        if kind == "attn_heads":
            return P(dp if b_ok else None, None,
                     "model" if shape[2] % model == 0 else None, None)
        if kind == "moe_group" or (kind == "moe_buf" and not cfg.moe_ep):
            if shape[0] % _size(mesh, all_ax) == 0:
                return P(all_ax, *(None,) * (ndim - 1))
            return None
        if kind == "moe_buf3":
            return P(dp if b_ok else None, None, None)
        if kind == "moe_buf":
            moe_ok = cfg.moe is not None and cfg.moe.n_experts % model == 0
            return P(dp if b_ok else None, "model" if moe_ok else None,
                     None, None)
        if kind == "logits":
            return P(dp if b_ok else None, None,
                     "model" if cfg.vocab % model == 0 else None)
        if kind == "hidden":
            return P(dp if b_ok else None, *(None,) * (ndim - 1))
        return None

    def __call__(self, x, kind: str):
        shape = (x.shape[0] * self.batch_slices,) + tuple(x.shape[1:])
        self.last_specs[kind] = self.spec(shape, kind)
        return x


# --------------------------------------------------------------------------
# fsdp and the optimizer state's shardings (the reference's steps.py)
# --------------------------------------------------------------------------
def fsdp_augment(rules: ShardingRules, shardings, params_struct):
    """With ``cfg.fsdp``: the dp axes on the largest free dim divisible by
    the dp size of every leaf of at least 2^20 elements (ZeRO-3)."""
    if not rules.fsdp:
        return shardings
    dpsz = _size(rules.mesh, rules.dp)

    def aug(ns, leaf):
        if ns is None or leaf is None or leaf.numel() < (1 << 20):
            return ns
        spec = list(ns.spec) + [None] * (len(leaf.shape) - len(ns.spec))
        used = {a for s in spec for a in entry_axes(s)}
        if any(a in used for a in rules.dp):
            return ns
        cands = [(leaf.shape[i], i) for i in range(len(leaf.shape))
                 if spec[i] is None and leaf.shape[i] % dpsz == 0]
        if not cands:
            return ns
        _, i = max(cands)
        spec[i] = rules.dp if len(rules.dp) > 1 else rules.dp[0]
        return NamedSharding(rules.mesh, P(*spec))

    return tree_map(aug, shardings, params_struct)


def opt_state_shardings(rules: ShardingRules, params_shardings, opt_struct):
    """AdamW's moments mirror the parameters; Adafactor's ``vr`` drops the
    last dim's entry and ``vc`` the one before; the step is replicated."""
    mesh = rules.mesh
    rep = NamedSharding(mesh, P())

    def mirror(p_ns, s_leaf):
        spec = list(p_ns.spec) + [None] * 8
        return NamedSharding(mesh, P(*spec[:len(s_leaf.shape)]))

    inner = opt_struct.inner
    if isinstance(inner, opt.AdamState):
        return opt.OptState(rep, opt.AdamState(
            tree_map(mirror, params_shardings, inner.m),
            tree_map(mirror, params_shardings, inner.v)))

    def drop_middle(p_ns, s_leaf):
        n = len(s_leaf.shape)
        if n == 0 or tuple(s_leaf.shape) == (1,):
            return NamedSharding(mesh, P(*(None,) * n))
        spec = list(p_ns.spec) + [None] * 8
        return NamedSharding(mesh, P(*(spec[:n - 1] + [spec[n]])))

    return opt.OptState(rep, opt.FactorState(
        tree_map(mirror, params_shardings, inner.vr),
        tree_map(drop_middle, params_shardings, inner.vc)))


# --------------------------------------------------------------------------
# a model's pieces
# --------------------------------------------------------------------------
@contextlib.contextmanager
def bound_tensors(model: torch.nn.Module, tensors: Dict[str, torch.Tensor],
                  experts: Dict[str, list]):
    """Run ``model`` with ``tensors`` (by parameter name) in its
    parameters' places and ``experts`` (by MoE module name) as its expert
    blocks; restored on exit. The backward pass (and remat's recompute)
    runs inside."""
    saved = []
    for name, t in tensors.items():
        mod_name, _, attr = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        saved.append((mod, attr, mod._parameters[attr]))
        mod._parameters[attr] = t
    for name, blocks in experts.items():
        model.get_submodule(name).expert_pieces = blocks
    try:
        yield
    finally:
        for mod, attr, old in saved:
            mod._parameters[attr] = old
        for name in experts:
            model.get_submodule(name).expert_pieces = None


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


class MeshModel:
    """One architecture's pieces on a mesh: the rules, the plan, the
    store, and a ``meta`` ``LM`` to run them through."""

    def __init__(self, cfg, mesh):
        self.cfg, self.mesh = cfg, mesh
        self.rules = ShardingRules(mesh, cfg)
        self.sharder = Sharder(self.rules, cfg)
        self.model = LM(cfg, device="meta", sharder=self.sharder)
        self.leaves = convert.reference_leaves(self.model)
        self.p_struct = convert.reference_params(self.model)
        self.p_shard = fsdp_augment(
            self.rules, self.rules.params_shardings(self.p_struct),
            self.p_struct)
        self.store = ShardStore(mesh)
        self.expert = {leaf.path: self._expert_dim(leaf)
                       for leaf in self.leaves}
        # entered around each dp slice's work (the dry-run's tracker)
        self.slice_context = contextlib.nullcontext

    def _expert_dim(self, leaf) -> Optional[int]:
        """The expert dim of an expert stack sharded over ``model`` (its
        blocks run where they are), else ``None``."""
        if len(leaf.path) < 2 or leaf.path[-2] != "moe" \
                or leaf.path[-1] not in EXPERT_STACKS:
            return None
        ns = _at(self.p_shard, leaf.path)
        d = len(ns.spec) - 3
        if d >= 0 and "model" in entry_axes(ns.spec[d]):
            return d
        return None

    def sharding(self, path) -> NamedSharding:
        return _at(self.p_shard, path)

    # ---- placing parameters ----
    def shard_model(self, model: LM, free: bool = True) -> dict:
        """A built model's parameters as pieces in the reference layout,
        leaf by leaf; with ``free`` each leaf's parameters are released
        (made ``meta``) once its pieces exist, so the peak is the pieces
        plus one leaf."""
        out: dict = {}
        leaves = convert.reference_leaves(model)
        while leaves:
            leaf = leaves.pop(0)
            ns = self.sharding(leaf.path)
            p0 = leaf.params[0]
            shape = ((len(leaf.params),) if leaf.stacked else ()) + \
                tuple(p0.shape)
            pieces = [Piece(index, pos, _cut(leaf, index,
                                              self.store.device(pos)))
                      for index, pos in ns.pieces(shape)]
            node = out
            for k in leaf.path[:-1]:
                node = node.setdefault(k, {})
            node[leaf.path[-1]] = ShardedTensor(shape, p0.dtype, ns, pieces)
            if free:
                for name in leaf.names:
                    mod_name, _, attr = name.rpartition(".")
                    mod = model.get_submodule(mod_name)
                    old = mod._parameters[attr]
                    mod._parameters[attr] = torch.nn.Parameter(
                        torch.empty(old.shape, dtype=old.dtype,
                                    device="meta"), requires_grad=False)
                del old
            del leaf, p0
        if self.cfg.block_pattern == "zamba" and "tail" not in out:
            out["tail"] = None
        return out

    def zeros(self, struct, shardings) -> Any:
        return tree_map(lambda t, ns: self.store.zeros(t.shape, t.dtype, ns),
                        struct, shardings)

    def gather_tree(self, tree, position: int = 0) -> Any:
        return tree_map(lambda st: self.store.gather(st, position), tree)

    # ---- running ----
    def batch_slices(self, batch: int) -> List[Tuple[slice, int]]:
        """(rows, position) of each dp slice: the batch over the dp axes
        where ``batch_spec`` cuts it, else one slice on position 0."""
        spec = self.rules.batch_spec(batch, 2)
        if spec[0] is None:
            return [(slice(None), 0)]
        axes = entry_axes(spec[0])
        n = _size(self.mesh, axes)
        rows = batch // n
        out = []
        for d in range(n):
            coords, rest = {}, d
            for a in reversed(axes):
                coords[a] = rest % self.mesh.axis_size(a)
                rest //= self.mesh.axis_size(a)
            out.append((slice(d * rows, (d + 1) * rows),
                        position_of(self.mesh, coords)))
        return out

    def bind(self, params, position: int, grad: bool = False):
        """(the swap's tensors, the gathered layers by path): every leaf
        but the expert stacks gathered on
        ``position``; a stacked leaf's layers each a tensor of its own on
        the gathered storage (a leaf of the graph when ``grad``, so each
        layer's gradient is the layer's size)."""
        tensors, full = {}, {}
        for leaf in self.leaves:
            if self.expert[leaf.path] is not None:
                continue
            t = self.store.gather(_at(params, leaf.path), position)
            layers = ([t[i].detach() for i in range(len(leaf.names))]
                      if leaf.stacked else [t])
            for x, name in zip(layers, leaf.names):
                tensors[name] = x.requires_grad_(grad)
            full[leaf.path] = layers
        return tensors, full

    def expert_blocks(self, params, grad: bool = False):
        """By MoE module name, its layer's ``(first expert, w_gate, w_up,
        w_down)`` block a ``model`` coordinate; and by path each block's
        (first expert, its layers, position) for the gradients. With
        ``grad`` every layer's block is a leaf whose gradient is made
        here, zero, on its position (the backward adds into it)."""
        stacks: Dict[Tuple[str, ...], list] = {}
        for leaf in self.leaves:
            if self.expert[leaf.path] is None:
                continue
            groups = []
            for e0, b, pos in self.store.gather_groups(
                    _at(params, leaf.path), "model"):
                layers = ([b[i].detach() for i in range(len(leaf.names))]
                          if leaf.stacked else [b.detach()])
                for x in layers:
                    x.requires_grad_(grad)
                    if grad:
                        x.grad = torch.zeros_like(x)
                groups.append((e0, layers, pos))
            stacks[leaf.path] = groups
        by_module: Dict[str, list] = {}
        for leaf in self.leaves:
            if leaf.path[-1] != "w_gate" or leaf.path not in stacks:
                continue
            trio = [stacks[leaf.path[:-1] + (n,)] for n in EXPERT_STACKS]
            for i, name in enumerate(leaf.names):
                by_module[name.rpartition(".")[0]] = [
                    (e0, g[i], u[i], d[i]) for (e0, g, _), (_, u, _),
                    (_, d, _) in zip(*trio)]
        return by_module, stacks

    def slice_bytes(self, batch) -> int:
        """Bytes of one dp slice of a batch's tensors."""
        ts = [t for _, t in tree_items(batch) if isinstance(t, torch.Tensor)]
        if not ts:
            return 0
        n = len(self.batch_slices(ts[0].shape[0]))
        return sum(t.numel() * t.element_size() for t in ts) // n

    @contextlib.contextmanager
    def running(self, tensors, experts, n_slices: int):
        self.sharder.batch_slices = n_slices
        with bound_tensors(self.model, tensors, experts[0]):
            yield self.model


def _cut(leaf, index, dev) -> torch.Tensor:
    """One piece of a reference leaf, a copy on ``dev``, from the port's
    parameters (a stacked leaf's layers in ``index[0]``)."""
    if leaf.stacked:
        return torch.stack([p.detach()[index[1:]] for p in
                            leaf.params[index[0]]]).to(dev)
    return leaf.params[0].detach()[index].to(dev, copy=True)


def _zeros_like(tree, device):
    return tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                          device=device), tree)


def _kv_marks(cache):
    """``cache``'s structure with True at its K/V leaves (``KVCache``
    fields and the cross K/V), False at the recurrent states."""
    from ..models.attention import KVCache

    def walk(node, kv=False):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: walk(v, k == "cross") for k, v in node.items()}
        if isinstance(node, tuple):
            kv = kv or isinstance(node, KVCache)
            out = [walk(v, kv) for v in node]
            return type(node)(*out) if hasattr(node, "_fields") \
                else type(node)(out)
        return kv
    return walk(cache)


def _slice_batch(batch, rows, device):
    return {k: None if v is None else v[rows].to(device)
            for k, v in batch.items()}


# --------------------------------------------------------------------------
# train
# --------------------------------------------------------------------------
class MeshTrainStep:
    """``step(params, opt_state, batch) -> (params, opt_state, {"loss",
    "grad_norm"})`` with the parameters and the optimizer state as pieces
    (trees of ``ShardedTensor``), ``batch`` whole on position 0's device."""

    def __init__(self, mm: MeshModel, grad_compression: bool = False):
        self.mm = mm
        self.cfg = mm.cfg
        self.grad_compression = grad_compression
        self.init_fn, self.update_fn = opt.make_optimizer(mm.cfg.optimizer)
        self.o_struct = self.init_fn(mm.p_struct)
        self.o_shard = opt_state_shardings(mm.rules, mm.p_shard,
                                           self.o_struct)
        self.only_first_slice = False     # the dry-run's one position

    def init_opt(self):
        """The optimizer's initial state as pieces (zeros)."""
        return self.mm.zeros(self.o_struct, self.o_shard)

    def plan_bytes(self, p_struct, o_struct, batch) -> int:
        """The plan's argument bytes a position."""
        return (planned_bytes(p_struct, self.mm.p_shard)
                + planned_bytes(o_struct, self.o_shard)
                + self.mm.slice_bytes(batch))

    def place(self, p_struct, o_struct, batch):
        """Zero pieces and a zero batch for ``build_train_step``'s
        stand-ins (under ``FakeTensorMode`` for the dry-run)."""
        return (self.mm.zeros(p_struct, self.mm.p_shard),
                self.mm.zeros(o_struct, self.o_shard),
                _zeros_like(batch, self.mm.store.device(0)))

    def __call__(self, params, opt_state, batch):
        mm, store = self.mm, self.mm.store
        n_total = batch["labels"].numel()
        slices = mm.batch_slices(batch["labels"].shape[0])
        run = slices[:1] if self.only_first_slice else slices
        dev0 = store.device(0)
        grads = tree_map(lambda st: store.like(
            st, lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                      device=t.device)), params)
        experts = mm.expert_blocks(params, grad=True)
        loss_sum = None
        for rows, pos in run:
            dev = store.device(pos)
            with mm.slice_context():
                sub = _slice_batch(batch, rows, dev)
                w = sub["labels"].numel() / n_total
                tensors, full = mm.bind(params, pos, grad=True)
                with mm.running(tensors, experts, len(slices)) as model:
                    loss = model.loss(sub)
                    (loss * w).backward()
                part = (loss.detach().float() * w).to(dev0)
                loss_sum = part if loss_sum is None else loss_sum + part
                for path, layers in full.items():
                    _scatter_layers(store, _at(grads, path), layers, pos)
                del tensors, full
        for path, groups in experts[1].items():
            g = _at(grads, path)
            for e0, layers, where in groups:
                _scatter_layers(store, g, layers, where,
                                {mm.expert[path]: e0})
        grads = tree_map(lambda g, p: store.like(
            g, lambda t: t.to(p.dtype)), grads, params)
        if self.grad_compression:
            grads = compress_pieces(grads, dev0)
        grads, gnorm = clip_pieces(grads, dev0)
        params, opt_state = self._update(params, grads, opt_state)
        return params, opt_state, {"loss": loss_sum, "grad_norm": gnorm}

    def _update(self, params, grads, state):
        mm = self.mm
        items = [(path, p, _at(grads, tuple(path.split("/"))))
                 for path, p in tree_items(params)]
        step = state.step.pieces[0].data
        if isinstance(state.inner, opt.AdamState):
            moments = [dict(tree_items(state.inner.m)),
                       dict(tree_items(state.inner.v))]
            by_dev: Dict[torch.device, list] = {}
            for path, p, g in items:
                m, v = moments[0][path], moments[1][path]
                for i, pc in enumerate(p.pieces):
                    by_dev.setdefault(pc.data.device, []).append(
                        (pc.data, g.pieces[i].data, m.pieces[i].data,
                         v.pieces[i].data, (path, i)))
            new = {}
            for dev, rows in by_dev.items():
                cols = list(zip(*rows))
                new_p, st = self.update_fn(
                    list(cols[0]), list(cols[1]),
                    opt.OptState(step.to(dev), opt.AdamState(
                        list(cols[2]), list(cols[3]))))
                for j, key in enumerate(cols[4]):
                    new[key] = (new_p[j], st.inner.m[j], st.inner.v[j])
            new_step = step + 1
            out = [_rebuilt(params, new, 0), _rebuilt(state.inner.m, new, 1),
                   _rebuilt(state.inner.v, new, 2)]
            return out[0], opt.OptState(_scalar(state.step, new_step),
                                        opt.AdamState(out[1], out[2]))
        new_step = step + 1
        lr = self.update_fn.keywords["lr_fn"](new_step)
        vr = dict(tree_items(state.inner.vr))
        vc = dict(tree_items(state.inner.vc))
        new = {}
        for path, p, g in items:
            new[path] = adafactor_pieces(mm.store, p, g, vr[path], vc[path],
                                         lr)
        return (_from_paths(params, new, 0), opt.OptState(
            _scalar(state.step, new_step), opt.FactorState(
                _from_paths(state.inner.vr, new, 1),
                _from_paths(state.inner.vc, new, 2))))


def _scatter_layers(store: ShardStore, g: ShardedTensor, layers, src: int,
                    offset=None) -> None:
    """Add the layers' gradients (stacked, for a stacked leaf) into the
    pieces of ``g``."""
    grad = (torch.stack([x.grad for x in layers]) if g.ndim > layers[0].ndim
            else layers[0].grad)
    store.scatter_add(g, grad, src, offset)


def _scalar(st: ShardedTensor, value: torch.Tensor) -> ShardedTensor:
    return ShardedTensor(st.shape, st.dtype, st.sharding,
                         [Piece(st.pieces[0].index, st.pieces[0].position,
                                 value)])


def _rebuilt(tree, new, k):
    return tree_map_paths(tree, lambda path, st: ShardedTensor(
        st.shape, st.dtype, st.sharding,
        [Piece(pc.index, pc.position, new[(path, i)][k])
         for i, pc in enumerate(st.pieces)]))


def _from_paths(tree, new, k):
    return tree_map_paths(tree, lambda path, st: new[path][k])


def tree_map_paths(tree, fn, path: str = ""):
    """``fn(path, leaf)`` over a nested-dict tree's leaves."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_paths(v, fn, f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    return fn(path, tree)


def compress_pieces(grads, dev0):
    """The int8 round trip of every leaf with one scale a leaf, max|g| over
    all its pieces / 127 (the single-device leaf's scale)."""
    def leaf(st):
        amax = max(p.data.float().abs().max().to(dev0) for p in st.pieces)
        scale = torch.clamp(amax, min=1e-12) / 127.0
        return ShardedTensor(st.shape, st.dtype, st.sharding, [Piece(
            p.index, p.position,
            (torch.clamp(torch.round(p.data.float() / scale.to(p.data.device)),
                         -127, 127) * scale.to(p.data.device)).to(st.dtype))
            for p in st.pieces])
    return tree_map(leaf, grads)


def clip_pieces(grads, dev0, max_norm: float = 1.0):
    """``clip_by_global_norm`` with the squares summed over every piece
    (each element once)."""
    g2 = sum(torch.sum(torch.square(p.data.float())).to(dev0)
             for _, st in tree_items(grads) for p in st.pieces)
    norm = torch.sqrt(g2)
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return tree_map(lambda st: ShardedTensor(
        st.shape, st.dtype, st.sharding, [Piece(
            p.index, p.position,
            (p.data.float() * scale.to(p.data.device)).to(st.dtype))
            for p in st.pieces]), grads), norm


def _key(index, drop):
    return tuple((s.start, s.stop) for i, s in enumerate(index)
                 if i not in drop)


def adafactor_pieces(store: ShardStore, p: ShardedTensor, g: ShardedTensor,
                     vr: ShardedTensor, vc: ShardedTensor, lr,
                     decay=0.99, eps=1e-30, clip_thresh=1.0):
    """``optim.adafactor_update`` of one leaf held as pieces: the row and
    column means of g^2, the row mean of ``vr`` and the update's RMS are
    summed over the pieces along a sharded dim before use (the
    all-reduces). Returns (new param, new vr, new vc) as pieces."""
    n = p.ndim
    g2 = [torch.square(pc.data.float()) + eps for pc in g.pieces]
    if n >= 2:
        def reduce_to(target, drop, dim):
            acc = {}
            for pc, x in zip(p.pieces, g2):
                key = _key(pc.index, drop)
                tp = next(t for t in target.pieces
                          if _key(t.index, ()) == key)
                store._count("all-reduce", pc.position, tp.position, x)
                s = x.sum(dim).to(tp.data.device)
                acc[key] = s if key not in acc else acc[key] + s
            return acc
        rows = reduce_to(vr, (n - 1,), -1)
        cols = reduce_to(vc, (n - 2,), -2)
        vr_new = {_key(t.index, ()): decay * t.data.float() + (1 - decay)
                  * rows[_key(t.index, ())] / p.shape[-1] for t in vr.pieces}
        vc_new = {_key(t.index, ()): decay * t.data.float() + (1 - decay)
                  * cols[_key(t.index, ())] / p.shape[-2] for t in vc.pieces}
        row_mean = {}
        for t in vr.pieces:
            key = _key(t.index, (n - 2,))
            s = vr_new[_key(t.index, ())].sum(-1, keepdim=True)
            row_mean[key] = s if key not in row_mean else \
                row_mean[key] + s.to(row_mean[key].device)
        updates = []
        for pc, x in zip(p.pieces, g.pieces):
            dev = pc.data.device
            r = vr_new[_key(pc.index, (n - 1,))].to(dev)
            c = vc_new[_key(pc.index, (n - 2,))].to(dev)
            rm = row_mean[_key(pc.index, (n - 2, n - 1))].to(dev) \
                / p.shape[-2]
            denom = r[..., None] * c[..., None, :] / torch.clamp(
                rm[..., None], min=eps)
            updates.append(x.data.float() * torch.rsqrt(
                torch.clamp(denom, min=eps)))
        vr_out = [vr_new[_key(t.index, ())].to(t.data.dtype)
                  for t in vr.pieces]
        vc_out = [vc_new[_key(t.index, ())].to(t.data.dtype)
                  for t in vc.pieces]
    else:
        vr_out, updates = [], []
        for pc, x, v, gg in zip(p.pieces, g.pieces, vr.pieces, g2):
            v_new = decay * v.data + (1 - decay) * gg
            vr_out.append(v_new.to(v.data.dtype))
            updates.append(x.data.float() * torch.rsqrt(
                torch.clamp(v_new, min=eps)))
        vc_out = [t.data for t in vc.pieces]
    dev0 = store.device(0)
    sq = sum(torch.sum(torch.square(u)).to(dev0) for u in updates)
    rms = torch.sqrt(sq / math.prod(p.shape) + 1e-12)
    div = torch.clamp(rms / clip_thresh, min=1.0)
    new_p = [(pc.data.float() - lr.to(pc.data.device)
              * (u / div.to(u.device))).to(p.dtype)
             for pc, u in zip(p.pieces, updates)]

    def rebuilt(st, datas):
        return ShardedTensor(st.shape, st.dtype, st.sharding,
                             [Piece(t.index, t.position, d)
                              for t, d in zip(st.pieces, datas)])
    return rebuilt(p, new_p), rebuilt(vr, vr_out), rebuilt(vc, vc_out)


# --------------------------------------------------------------------------
# prefill and serve
# --------------------------------------------------------------------------
class MeshPrefillStep:
    """``step(params, tokens, extra=None) -> logits``, each dp slice's
    forward on its position; the logits on position 0's device."""

    def __init__(self, mm: MeshModel):
        self.mm = mm
        self.only_first_slice = False

    def plan_bytes(self, p_struct, tokens, extra) -> int:
        return (planned_bytes(p_struct, self.mm.p_shard)
                + self.mm.slice_bytes((tokens, extra)))

    def place(self, p_struct, tokens, extra):
        dev = self.mm.store.device(0)
        return (self.mm.zeros(p_struct, self.mm.p_shard),
                *_zeros_like((tokens, extra), dev))

    @torch.inference_mode()
    def __call__(self, params, tokens, extra=None):
        mm = self.mm
        slices = mm.batch_slices(tokens.shape[0])
        run = slices[:1] if self.only_first_slice else slices
        dev0 = mm.store.device(0)
        experts = mm.expert_blocks(params)
        outs = []
        for rows, pos in run:
            dev = mm.store.device(pos)
            with mm.slice_context():
                tensors, _ = mm.bind(params, pos)
                with mm.running(tensors, experts, len(slices)) as model:
                    ex = None if extra is None else extra[rows].to(dev)
                    outs.append(model.forward(tokens[rows].to(dev), ex)
                                .to(dev0))
                del tensors
        return torch.cat(outs, dim=0)

    @torch.inference_mode()
    def encode(self, params, frames):
        """encdec: each slice's encoder output and cross K/V; the cross
        K/V stacked (L, B, T, nkv, hd) on position 0's device."""
        mm = self.mm
        slices = mm.batch_slices(frames.shape[0])
        dev0 = mm.store.device(0)
        ks, vs = [], []
        for rows, pos in slices:
            tensors, _ = mm.bind(params, pos)
            with mm.running(tensors, ({}, {}), len(slices)) as model:
                _, (k, v) = model.encode(frames[rows].to(
                    mm.store.device(pos)))
            ks.append(k.to(dev0))
            vs.append(v.to(dev0))
        return torch.cat(ks, dim=1), torch.cat(vs, dim=1)


class MeshServeStep:
    """``step(params, cache, tokens, pos) -> (logits, cache)``, the cache
    as pieces (``init_cache``), written in place."""

    def __init__(self, mm: MeshModel):
        self.mm = mm
        self.only_first_slice = False

    def cache_shardings(self, cache_struct):
        return self.mm.rules.cache_shardings(cache_struct)

    def plan_bytes(self, p_struct, cache, tokens, pos) -> int:
        return (planned_bytes(p_struct, self.mm.p_shard)
                + planned_bytes(cache, self.cache_shardings(cache))
                + self.mm.slice_bytes(tokens))

    def place(self, p_struct, cache, tokens, pos):
        mm = self.mm
        return (mm.zeros(p_struct, mm.p_shard),
                mm.zeros(cache, self.cache_shardings(cache)),
                _zeros_like(tokens, mm.store.device(0)), pos)

    def init_cache(self, batch: int, max_len: int, cross=None):
        """The zero cache of ``batch`` rows and ``max_len`` slots as
        pieces; ``cross`` (encdec): the whole cross K/V, cut by the
        cache's rules."""
        struct = self.mm.model.init_cache(batch, max_len)
        if cross is not None:
            struct["cross"] = cross
        shard = self.cache_shardings(struct)
        store = self.mm.store

        def place(t, ns):
            if t.device.type == "meta":
                return store.zeros(t.shape, t.dtype, ns)
            return store.shard(t, ns)
        return tree_map(place, struct, shard)

    def _local(self, st: ShardedTensor, rows: slice, pos: int, writes,
               kv: bool):
        """The slice's view of one cache leaf: a piece itself where it
        covers the rows whole, ``StackedPieces`` where a K/V leaf's
        sequence is cut, else a gathered copy that ``writes`` sends
        back."""
        batch = st.shape[1]
        start = 0 if rows.start is None else rows.start
        stop = batch if rows.stop is None else rows.stop
        mine = [p for p in st.pieces
                if p.index[1].start <= start and stop <= p.index[1].stop]
        if len(mine) == 1 and all(
                p.index[i] == slice(0, st.shape[i])
                for p in mine for i in range(st.ndim) if i != 1):
            p = mine[0]
            return p.data[:, start - p.index[1].start:
                          stop - p.index[1].start]
        dims = st.sharding.dim_axes(st.ndim)
        if kv and dims[2] and not dims[3] and not dims[4]:
            return StackedPieces(sorted(
                (p.index[2].start, p.data[:, start - p.index[1].start:
                                          stop - p.index[1].start])
                for p in mine))
        full = self.mm.store.gather(st, pos)[:, start:stop].contiguous()
        writes.append((st, full, start))
        return full

    @torch.inference_mode()
    def __call__(self, params, cache, tokens, pos):
        mm = self.mm
        store = mm.store
        slices = mm.batch_slices(tokens.shape[0])
        run = slices[:1] if self.only_first_slice else slices
        dev0 = store.device(0)
        experts = mm.expert_blocks(params)
        outs = []
        for rows, where in run:
            dev = store.device(where)
            with mm.slice_context():
                writes: list = []
                local = tree_map(lambda st, kv: self._local(
                    st, rows, where, writes, kv), cache, _kv_marks(cache))
                tensors, _ = mm.bind(params, where)
                with mm.running(tensors, experts, len(slices)) as model:
                    logits, _ = model.decode_step(local, tokens[rows].to(dev),
                                                  pos)
                outs.append(logits.to(dev0))
                for st, full, start in writes:
                    for p in st.pieces:
                        lo = max(p.index[1].start, start)
                        hi = min(p.index[1].stop, start + full.shape[1])
                        if lo >= hi:
                            continue
                        idx = list(p.index)
                        idx[1] = slice(lo - start, hi - start)
                        part = full[tuple(idx)]
                        store._count("all-gather", where, p.position, part)
                        p.data[:, lo - p.index[1].start:hi - p.index[1].start] \
                            = part.to(p.data.device)
                del tensors, local
        return torch.cat(outs, dim=0), cache


# --------------------------------------------------------------------------
# admission: the plan against the cards' memory
# --------------------------------------------------------------------------
def device_memory(dev: torch.device) -> int:
    """A card's memory, or the host's for a CPU position."""
    if dev.type == "cuda":
        return torch.cuda.get_device_properties(dev).total_memory
    import os
    return os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def planned_bytes(struct, shardings) -> int:
    """Bytes a position holds of ``struct`` under ``shardings``."""
    return sum(ns.planned_bytes(t.shape, t.dtype) for (_, t), (_, ns) in
               zip(tree_items(struct), tree_items(shardings)))


def plan_parts(mm: MeshModel, kind: str, rows: int, seq: int,
               o_struct=None, o_shard=None, cache_struct=None
               ) -> Dict[str, int]:
    """The plan's bytes a position by part: parameters, optimizer state
    and gradients (train), the cache (serve), the batch slice and the
    float32 logits of one dp slice (vocab over ``model`` where it
    divides)."""
    model = mm.mesh.axis_size("model")
    vocab = mm.cfg.vocab
    if vocab % model == 0:
        vocab //= model
    parts = {"params": planned_bytes(mm.p_struct, mm.p_shard)}
    if kind == "train":
        parts["optimizer"] = planned_bytes(o_struct, o_shard)
        parts["gradients"] = parts["params"]
        parts["batch"] = 2 * rows * seq * 4
        parts["logits"] = rows * seq * vocab * 4
    else:
        parts["cache"] = planned_bytes(
            cache_struct, mm.rules.cache_shardings(cache_struct))
        parts["logits"] = rows * vocab * 4
    return parts


def admit(mesh, parts: Dict[str, int]) -> None:
    """Raise, before anything is allocated, where the plan's bytes of the
    positions that share a device exceed its memory."""
    per_pos = sum(parts.values())
    counts: Dict[torch.device, int] = {}
    for d in mesh.devices:
        counts[d] = counts.get(d, 0) + 1
    for dev, n in counts.items():
        cap = device_memory(dev)
        if per_pos * n > cap:
            what = ", ".join(f"{k} {v / 1e9:.3f}" for k, v in parts.items())
            raise MemoryError(
                f"the plan places {per_pos * n / 1e9:.1f} GB on {dev}: {n} "
                f"positions x {per_pos / 1e9:.3f} GB ({what} GB a position) "
                f"> its {cap / 1e9:.1f} GB")
