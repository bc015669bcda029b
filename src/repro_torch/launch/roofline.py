"""Cost and roofline arithmetic for the dry-run, with the H100's constants.

The counterpart of ``repro.launch.roofline``. The arithmetic
(``CellCosts``, ``units_of``, ``with_units``, ``seq_fit``,
``extrapolate``, ``slstm_flops_correction``, ``model_flops``,
``Roofline``, ``make_roofline``) is the reference's. Where the reference
reads XLA's ``cost_analysis`` and parses collectives from the compiled
HLO, the port has no compiler to ask: ``costs_of_step`` runs one
position's share of the step on fake tensors (``FakeTensorMode``: shapes
and dtypes, no data, no device) under ``FlopCounterMode`` and a peak
memory tracker, and takes the collective bytes from the shard store,
which counts the bytes it moves between positions as it moves them.

FLOPs a position are the slice's FLOPs over the ``model`` axis size (the
plan's even tensor-parallel split; the one-process step computes a dp
slice whole, ROADMAP C12). ``FlopCounterMode`` counts the matmuls,
attention and convolutions, not the elementwise ops.

Hardware constants: NVIDIA H100 SXM5 80GB (NVIDIA H100 Tensor Core GPU
datasheet): bf16 dense 989.4 TF/s, HBM3 3.35 TB/s, NVLink 4 at 900 GB/s a
card both ways (450 GB/s a direction) inside an 8-card node, 400 Gb/s
NDR InfiniBand (50 GB/s) a card across nodes, 80 GB a card. A mesh
position is a card; positions are laid out row-major,
``distributed.sharding.CARDS_PER_NODE`` (8) a node.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import weakref
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

PEAK_FLOPS = 989.4e12        # bf16 dense tensor-core FLOP/s
HBM_BW = 3.35e12             # HBM3 bytes/s
NVLINK_BW = 450e9            # bytes/s a direction, inside a node
NET_BW = 50e9                # bytes/s a card across nodes (400 Gb/s NDR)
CARD_BYTES = 80e9            # device memory a card


@dataclasses.dataclass
class CellCosts:
    flops: float                  # per device
    bytes_accessed: float         # per device
    coll_bytes: Dict[str, int]    # per device, by kind
    net_bytes: float = 0.0        # of coll_bytes, those crossing nodes

    @property
    def coll_total(self) -> float:
        return float(sum(self.coll_bytes.values()))

    def scale_add(self, other: "CellCosts", k: float) -> "CellCosts":
        cb = dict(self.coll_bytes)
        for kk, v in other.coll_bytes.items():
            cb[kk] = cb.get(kk, 0) + int(k * v)
        return CellCosts(self.flops + k * other.flops,
                         self.bytes_accessed + k * other.bytes_accessed, cb,
                         self.net_bytes + k * other.net_bytes)

    def sub(self, other: "CellCosts") -> "CellCosts":
        cb = {k: max(0, v - other.coll_bytes.get(k, 0))
              for k, v in self.coll_bytes.items()}
        return CellCosts(max(0.0, self.flops - other.flops),
                         max(0.0, self.bytes_accessed - other.bytes_accessed),
                         cb, max(0.0, self.net_bytes - other.net_bytes))


def units_of(cfg) -> Tuple[int, int]:
    """(number of layer-scan units U, layers per unit)."""
    bp = cfg.block_pattern
    if bp == "gemma2":
        return cfg.n_layers // 2, 2
    if bp == "xlstm":
        return cfg.n_layers // 8, 8
    if bp == "zamba":
        return cfg.n_layers // cfg.attn_every, cfg.attn_every
    return cfg.n_layers, 1


def with_units(cfg, u: int):
    _, per = units_of(cfg)
    return dataclasses.replace(cfg, n_layers=u * per)


def seq_fit(cA: CellCosts, cB: CellCosts, sA: int, sB: int,
            s_target: int) -> CellCosts:
    """Fit cost(S) = a*S + b*S^2 from two sequence lengths and evaluate
    it at ``s_target`` (the cells whose sequence loops are too slow to
    run whole on fake tensors)."""
    def fit(yA, yB):
        b = (yB / sB - yA / sA) / (sB - sA)
        a = yA / sA - b * sA
        return max(a * s_target + b * s_target ** 2, yB)   # monotone guard
    keys = set(cA.coll_bytes) | set(cB.coll_bytes)
    cb = {k: int(fit(cA.coll_bytes.get(k, 0), cB.coll_bytes.get(k, 0)))
          for k in keys}
    return CellCosts(fit(cA.flops, cB.flops),
                     fit(cA.bytes_accessed, cB.bytes_accessed), cb,
                     fit(cA.net_bytes, cB.net_bytes))


def extrapolate(c1: CellCosts, c2: CellCosts, cfg) -> CellCosts:
    """total = c1 + (U-1) * (c2 - c1), plus zamba's tail layers."""
    U, per = units_of(cfg)
    delta = c2.sub(c1)
    total = c1.scale_add(delta, U - 1)
    if cfg.block_pattern == "zamba":
        tail = (cfg.n_layers - U * per) / (per + 1)
        total = total.scale_add(delta, tail)
    return total


def slstm_flops_correction(cfg, shape, per_device: int) -> float:
    """xlstm only: the sLSTM's recurrent matmuls, 4 gates x H x hd^2 x 2
    a token forward (x3 to train), over ``per_device`` devices. The
    port's step counts them (its time loop is Python), so the dry-run
    adds this only where the reference's does: never at full depth."""
    if cfg.block_pattern != "xlstm" or shape.kind == "decode":
        return 0.0
    hd = cfg.d_model // cfg.n_heads
    n_slstm = cfg.n_layers // 8
    per_tok = 4 * cfg.n_heads * hd * hd * 2
    tokens = shape.global_batch * shape.seq_len
    mult = 3 if shape.kind == "train" else 1
    return n_slstm * per_tok * tokens * mult / per_device


def model_flops(cfg, shape) -> float:
    """6*N*D to train (N active for MoE), 2*N*D to prefill, 2*N a decoded
    token."""
    n = cfg.active_param_count()
    if shape.kind == "decode":
        return 2.0 * n * shape.global_batch
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * tokens
    return 6.0 * n * tokens


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops_global: float
    logical_bytes_s: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / max(1.0, self.hlo_flops_global)

    @property
    def roofline_fraction(self) -> float:
        """The useful FLOPs' time at peak over the dominant term (at most
        1)."""
        ideal = self.model_flops / PEAK_FLOPS
        return min(1.0, ideal / max(self.bound_s, ideal, 1e-12))

    def row(self) -> Dict[str, Any]:
        return dict(compute_s=self.compute_s, memory_s=self.memory_s,
                    collective_s=self.collective_s, dominant=self.dominant,
                    useful_ratio=self.useful_ratio,
                    roofline_fraction=self.roofline_fraction)


def collective_seconds(coll_total: float, net_bytes: float) -> float:
    """Bytes inside a node over NVLink, those across nodes over the
    network."""
    return (coll_total - net_bytes) / NVLINK_BW + net_bytes / NET_BW


def make_roofline(costs: CellCosts, cfg, shape, n_chips: int,
                  traffic_bytes: Optional[float] = None) -> Roofline:
    """``traffic_bytes``: the HBM traffic estimate, 2 x (arguments +
    temporaries + outputs) a position (each buffer written and read
    once)."""
    mf = model_flops(cfg, shape)
    mem_bytes = traffic_bytes if traffic_bytes else costs.bytes_accessed
    return Roofline(
        compute_s=costs.flops / PEAK_FLOPS,
        memory_s=mem_bytes / HBM_BW,
        collective_s=collective_seconds(costs.coll_total, costs.net_bytes),
        model_flops=mf / n_chips,
        hlo_flops_global=costs.flops,
        logical_bytes_s=costs.bytes_accessed / HBM_BW,
    )


def costs_of_step(bundle) -> Tuple[CellCosts, Dict[str, int]]:
    """Run one dp position's share of ``bundle``'s step on fake tensors.
    Returns (its costs a position, its memory: ``argument_bytes`` (the
    plan's inputs a position), ``temp_bytes``, ``output_bytes`` (the new
    state's pieces, donated in place of the inputs)). ``temp_bytes`` is
    the peak of what the slice allocates on its position (the weights
    gathered there, activations, whole-leaf gradients; tracked around
    the slice's work only, new storages only) plus what a position holds
    besides: its float32 gradient pieces (train) and its expert blocks
    (and their gradients). The collective bytes are those of the
    busiest position's links in the run (the larger of its bytes sent
    and received, by kind), as the store counted them."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from ..distributed.sharded_steps import planned_bytes
    from ..models.layers import _rope_freqs_on
    step = bundle.fn
    mm = step.mm
    mesh = mm.mesh
    # the rope table cache must not keep a fake tensor across modes
    rope_cache = _rope_freqs_on.cache_clear
    rope_cache()
    with FakeTensorMode(allow_non_fake_inputs=True):
        args = step.place(*bundle.args)
        mm.store.reset_counts()
        step.only_first_slice = True
        tracker = PeakBytes()
        mm.slice_context = lambda: tracker
        gc.freeze()          # the tracker's collections scan only the step's
        try:
            with FlopCounterMode(display=False) as fc:
                out = step(*args)
        finally:
            gc.unfreeze()
            step.only_first_slice = False
            mm.slice_context = contextlib.nullcontext
        temp = tracker.peak + _held_elsewhere(step)
    rope_cache()
    arg_bytes = step.plan_bytes(*bundle.args)
    out_bytes = (planned_bytes(mm.p_struct, mm.p_shard)
                 + planned_bytes(step.o_struct, step.o_shard)
                 if hasattr(step, "o_shard") else 0)
    del out
    busiest = mm.store.busiest()
    coll: Dict[str, int] = {}
    for (kind, _), n in busiest.items():
        coll[kind] = coll.get(kind, 0) + n
    net = float(sum(n for (_, crosses), n in busiest.items() if crosses))
    flops = fc.get_total_flops() / mesh.axis_size("model")
    traffic = 2.0 * (arg_bytes + temp + out_bytes)
    return (CellCosts(float(flops), traffic, coll, net),
            {"argument_bytes": int(arg_bytes), "temp_bytes": int(temp),
             "output_bytes": int(out_bytes), "alias_bytes": int(out_bytes)})


class PeakBytes(TorchDispatchMode):
    """The peak of the bytes alive among the storages made while it is
    active (an op's output on an input's storage is none): a storage
    counted once, freed when the last tensor on it is (tensors kept by
    autograd keep theirs alive). Remat's recomputed tensors die in
    reference cycles, so a new peak is taken only after a garbage
    collection, run when the live bytes pass the peak by ``MARGIN`` (the
    peak is low by at most that share)."""
    MARGIN = 0.01

    def __init__(self):
        super().__init__()
        self.bytes: Dict[int, int] = {}
        self.refs: Dict[int, int] = {}
        self.cur = self.peak = 0

    def _release(self, key) -> None:
        self.refs[key] -= 1
        if not self.refs[key]:
            del self.refs[key]
            self.cur -= self.bytes.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        seen = {t.untyped_storage()._cdata for t in tree_leaves((args, kwargs))
                if isinstance(t, torch.Tensor)}
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key not in self.bytes:
                if key in seen:
                    continue          # a view or an in-place write
                self.bytes[key] = st.nbytes()
                self.refs[key] = 0
                self.cur += st.nbytes()
            self.refs[key] += 1
            weakref.finalize(t, self._release, key)
        if self.cur > self.peak * (1 + self.MARGIN):
            gc.collect()
            self.peak = max(self.peak, self.cur)
        return out


def _held_elsewhere(step) -> int:
    """Bytes a position holds outside its slice's work: the float32
    gradient pieces (train) and one ``model`` coordinate's expert blocks
    (and their gradients), gathered over the dp axes."""
    mm = step.mm
    train = hasattr(step, "o_shard")
    model = mm.mesh.axis_size("model")
    out = 0
    for leaf in mm.leaves:
        t = mm.p_struct
        for k in leaf.path:
            t = t[k]
        ns = mm.sharding(leaf.path)
        if train:
            out += ns.planned_bytes(t.shape, torch.float32)
        if mm.expert[leaf.path] is not None:
            out += t.numel() * t.element_size() // model * (2 if train else 1)
    return out
