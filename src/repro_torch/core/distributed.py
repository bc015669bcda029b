"""Distributed bulk-bitwise analytics: record-sharded relations on a mesh.

The counterpart of ``repro.core.distributed``. The paper's scale-out story
(PIMDB §4): a relation spans many memory modules, ONE PIM request is
broadcast to all of them, each module computes its own pages, and the host
combines their partial results.

Here a :class:`Mesh` names one ``torch.device`` per position, and a
relation is split along its packed-word (record) axis over the mesh's
shard axes (:func:`shard_relation_planes`): shard ``s`` of ``n`` owns
words ``[s*W/n, (s+1)*W/n)`` as one contiguous tensor on its device. The
reference is single-controller SPMD (``shard_map``); so is this module,
from one process with no ``torch.distributed`` group:

* **filters** — each shard runs the relation's program over its own words
  (one ``fused_program`` launch a shard, ``core.program.run_program``) and
  its masks stay on its device; the host concatenates them in shard order
  when it reads one;
* **SUM/COUNT** — the shards' per-(group, bit) popcounts are summed in
  int64 on the first shard's device (the reference's ``psum``), and the
  exact 2^b weighting stays in Python ints;
* **MIN/MAX** — every shard's per-tile candidate rows are gathered to the
  first shard's device and reduced by :func:`combine_minmax_candidates`,
  the same MSB-first combine the reference runs over tiles and then over
  shards (one level or two gives the same bits);
* **Materialize** — each shard compacts its own selected records; the
  values stay on its device and the host copies each shard's ``count``
  prefix, in shard order.

A shard that the reference replicates along mesh axes outside
``shard_axes`` is held once here, on the device where those axes are 0,
so a sharded relation takes the memory of the unsharded one.
:class:`ShardedRelation` is the sharded :class:`~repro_torch.core.engine.
PimRelation`: its per-shard tensors are the only resident copy, and a
reader that needs the whole relation (the eager engine, the DML write
path, the fault guard's scrub) gets a gathered view, one ``torch.cat`` per
attribute onto the first shard's device.

The eager wrappers (:func:`distributed_filter`,
:func:`distributed_filter_aggregate`, :func:`make_sum_where_program`) run
word-level ad-hoc programs shard by shard over the tuples
:func:`shard_relation_planes` returns.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from collections.abc import Mapping as MappingABC
from typing import (Callable, Dict, Iterator, List, Mapping, Optional,
                    Sequence, Tuple, Union)

import torch

from repro_torch.kernels import ops as kops
from . import engine as eng

Shards = Tuple[torch.Tensor, ...]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A named grid of devices, the counterpart of ``jax.sharding.Mesh``:
    ``shape`` and ``axis_names`` as the reference's, ``devices`` one
    ``torch.device`` per position in row-major order. Frozen and hashable,
    so it can key the tape cache."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    devices: Tuple[torch.device, ...]

    def axis_size(self, name: str) -> int:
        return self.shape[self.axis_names.index(name)]


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              device: Union[str, torch.device] = "cuda",
              devices: Optional[Sequence[Union[str, torch.device]]] = None
              ) -> Mesh:
    """A mesh of ``shape`` named ``axis_names``, the counterpart of
    ``jax.make_mesh``. With ``devices`` (one per position, row-major) each
    shard sits on its own device; otherwise every position is ``device``
    (default ``"cuda"``). Raises where a CUDA device is named and CUDA is
    unavailable."""
    shape = tuple(int(s) for s in shape)
    axis_names = tuple(axis_names)
    if len(shape) != len(axis_names) or len(set(axis_names)) != len(shape):
        raise ValueError(f"mesh shape {shape} needs as many distinct axis "
                         f"names, got {axis_names}")
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh shape {shape} has an empty axis")
    size = math.prod(shape)
    if devices is None:
        devs = (torch.device(device),) * size
    else:
        devs = tuple(torch.device(d) for d in devices)
        if len(devs) != size:
            raise ValueError(f"mesh {shape} has {size} positions, got "
                             f"{len(devs)} devices")
    for d in set(devs):
        if d.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"mesh on {d}: torch.cuda.is_available() is false "
                    "(pass device='cpu' for the plain PyTorch path)")
            if d.index is not None and d.index >= torch.cuda.device_count():
                raise RuntimeError(f"mesh on {d}: only "
                                   f"{torch.cuda.device_count()} GPUs")
    return Mesh(shape, axis_names, devs)


def mesh_shard_axes(mesh: Mesh,
                    axes: Optional[Sequence[str]] = None) -> Tuple[str, ...]:
    """Normalise the record-sharding axes: default = every mesh axis."""
    ax = tuple(axes) if axes else tuple(mesh.axis_names)
    unknown = [a for a in ax if a not in mesh.axis_names]
    if unknown:
        raise ValueError(f"shard axes {unknown} not in mesh axes "
                         f"{mesh.axis_names}")
    return ax


def shard_devices(mesh: Mesh, axes: Sequence[str]) -> Tuple[torch.device,
                                                           ...]:
    """The device of each shard over ``axes``, in shard order: shard ``s``
    is ``s``'s row-major coordinates over ``axes`` (in their given order),
    with every other mesh axis at 0."""
    out = []
    for coords in itertools.product(*(range(mesh.axis_size(a))
                                      for a in axes)):
        at = dict(zip(axes, coords))
        flat = 0
        for name, size in zip(mesh.axis_names, mesh.shape):
            flat = flat * size + at.get(name, 0)
        out.append(mesh.devices[flat])
    return tuple(out)


def shard_relation_planes(planes: torch.Tensor, mesh: Mesh,
                          axes: Sequence[str] = ("data",)) -> Shards:
    """Split ``(n_bits, W)`` planes or a ``(W,)`` plane along the word
    axis over ``axes``: shard ``s`` of ``n`` gets words ``[s*W/n,
    (s+1)*W/n)`` as one contiguous tensor on its device. Raises where
    ``n`` does not divide ``W`` (``W`` is a multiple of ``TILE_WORDS``, so
    any power of two up to 1,024 divides it)."""
    devs = shard_devices(mesh, axes)
    n, w = len(devs), planes.shape[-1]
    if w % n:
        raise ValueError(f"{n} shards over {tuple(axes)} do not divide "
                         f"{w} words")
    # A copy even on the same device: a view would keep the whole tensor
    # alive behind its shards.
    return tuple(p.to(device=d, copy=True,
                      memory_format=torch.contiguous_format)
                 for p, d in zip(torch.tensor_split(planes, n, dim=-1),
                                 devs))


def gather_shards(shards: Sequence[torch.Tensor]) -> torch.Tensor:
    """The whole tensor of ``shards``: one ``torch.cat`` along the word axis
    onto the first shard's device."""
    dev = shards[0].device
    return torch.cat([s.to(dev) for s in shards], dim=-1)


# --------------------------------------------------------------------------
# The sharded relation
# --------------------------------------------------------------------------
class ShardedPlanes(MappingABC):
    """``attribute -> (n_bits, W)`` planes of a sharded relation, read-only.
    Keys and membership come from the shards; reading a value gathers that
    attribute (one ``torch.cat``), so nothing is held twice."""

    def __init__(self, parts: Tuple[Dict[str, torch.Tensor], ...]):
        self.parts = parts

    def __getitem__(self, attr: str) -> torch.Tensor:
        return gather_shards([p[attr] for p in self.parts])

    def __contains__(self, attr) -> bool:
        return attr in self.parts[0]

    def __iter__(self) -> Iterator[str]:
        return iter(self.parts[0])

    def __len__(self) -> int:
        return len(self.parts[0])


@dataclasses.dataclass(eq=False, repr=False)
class ShardedRelation(eng.PimRelation):
    """A :class:`~repro_torch.core.engine.PimRelation` whose planes are split
    along the word axis over ``shard_axes`` of ``mesh``.

    ``shard_planes[s]`` / ``shard_valid[s]`` are shard ``s``'s planes and
    valid words, the only resident copy. ``planes`` and ``valid`` read as
    the whole relation: ``planes`` a :class:`ShardedPlanes` (a value is
    gathered when read), ``valid`` the gathered valid plane. Built, or
    rebuilt by ``dataclasses.replace``, from whole tensors, it splits them;
    from another relation's :class:`ShardedPlanes` over the same split it
    takes the shards as they are."""
    mesh: Optional[Mesh] = None
    shard_axes: Tuple[str, ...] = ()

    def __post_init__(self) -> None:
        n = len(shard_devices(self.mesh, self.shard_axes))
        if self.layout.n_words % n:
            raise ValueError(f"{n} shards over {self.shard_axes} do not "
                             f"divide {self.layout.n_words} words")
        planes, valid = self._planes_in, self._valid_in
        del self._planes_in, self._valid_in
        if (isinstance(planes, ShardedPlanes) and len(planes.parts) == n
                and all(p.shape[-1] * n == self.layout.n_words
                        for part in planes.parts for p in part.values())):
            self.shard_planes = planes.parts
        else:
            split = {a: shard_relation_planes(p, self.mesh, self.shard_axes)
                     for a, p in planes.items()}
            self.shard_planes = tuple({a: s[i] for a, s in split.items()}
                                      for i in range(n))
        self.shard_valid = (valid if isinstance(valid, tuple)
                            else shard_relation_planes(valid, self.mesh,
                                                       self.shard_axes))

    # The base class's ``planes`` and ``valid`` fields, as the whole
    # relation: ``__init__`` hands them to ``__post_init__`` to split.
    @property
    def planes(self) -> ShardedPlanes:
        return ShardedPlanes(self.shard_planes)

    @planes.setter
    def planes(self, value) -> None:
        if hasattr(self, "shard_planes"):
            raise AttributeError("a ShardedRelation's planes are replaced "
                                 "through dataclasses.replace")
        self._planes_in = value

    @property
    def valid(self) -> torch.Tensor:
        return gather_shards(self.shard_valid)

    @valid.setter
    def valid(self, value) -> None:
        if hasattr(self, "shard_valid"):
            raise AttributeError("a ShardedRelation's valid plane is "
                                 "replaced through dataclasses.replace")
        self._valid_in = value

    def __repr__(self) -> str:
        return (f"ShardedRelation({self.name!r}, {self.n_records} records, "
                f"{self.layout.n_words} words over {self.n_shards} shards "
                f"{self.shard_axes}, version {self.version})")

    @property
    def n_shards(self) -> int:
        return len(self.shard_valid)

    def shards(self) -> List[Tuple[Mapping[str, torch.Tensor],
                                   torch.Tensor]]:
        return list(zip(self.shard_planes, self.shard_valid))

    def gathered(self) -> eng.PimRelation:
        return eng.PimRelation(
            self.name, self.layout,
            {a: self.planes[a] for a in self.shard_planes[0]}, self.valid,
            self.n_records, self.version)

    def bumped(self) -> "ShardedRelation":
        return dataclasses.replace(self, version=self.version + 1,
                                   valid=self.shard_valid)

    def shard(self, mesh: Mesh, shard_axes=None) -> "ShardedRelation":
        ax = mesh_shard_axes(mesh, shard_axes)
        if (mesh, ax) == (self.mesh, self.shard_axes):
            return self
        return self.gathered().shard(mesh, ax)


# --------------------------------------------------------------------------
# Thin eager wrappers (word-level ad-hoc programs)
# --------------------------------------------------------------------------
def distributed_filter(mesh: Mesh,
                       predicate_fn: Callable[[torch.Tensor], torch.Tensor],
                       shard_axes: Sequence[str] = ("data",)):
    """Wrap a word-level predicate (planes -> packed mask) for a
    record-sharded relation: ``run(planes_shards, valid_shards)`` runs it
    on each shard and ANDs the shard's valid words, so padding words past
    ``n_records`` never pass. The masks stay per shard, on their devices:
    no combine at all for a pure filter."""
    n = len(shard_devices(mesh, mesh_shard_axes(mesh, shard_axes)))

    def _run(planes: Shards, valid: Shards) -> Shards:
        _check_shards(n, planes, valid)
        return tuple(predicate_fn(p) & v for p, v in zip(planes, valid))

    return _run


def distributed_filter_aggregate(mesh: Mesh,
                                 program_fn: Callable[..., torch.Tensor],
                                 shard_axes: Sequence[str] = ("data",)):
    """Filter + local aggregate + host combine (paper §4.2):
    ``run(filter_shards, agg_shards, valid_shards)`` runs
    ``program_fn(filter_planes, agg_planes, valid)`` on each shard and sums
    the partials in int64 on the first shard's device (the reference's
    ``psum``). ``program_fn`` must mask its selection with ``valid`` — see
    :func:`make_sum_where_program`."""
    n = len(shard_devices(mesh, mesh_shard_axes(mesh, shard_axes)))

    def _run(filter_planes: Shards, agg_planes: Shards,
             valid: Shards) -> torch.Tensor:
        _check_shards(n, filter_planes, agg_planes, valid)
        dev = valid[0].device
        return sum(program_fn(f, a, v).to(dev, torch.int64)
                   for f, a, v in zip(filter_planes, agg_planes, valid))

    return _run


def make_sum_where_program(imm_lo: int, imm_hi: int):
    """Example program: SUM(agg) WHERE lo <= key < hi, the canonical
    filter + aggregate shape of the paper's queries. Both comparisons go
    through ``kernels.ops.predicate_cmp_imm`` (the ``cmp_imm`` kernel on a
    CUDA shard). Returns the per-bit popcounts ``(n_bits,)`` int64; the
    caller weights them by 2^b in Python ints. The mask is ANDed with
    ``valid``, so zero-padded records past ``n_records`` (which satisfy
    ``key < hi``) add nothing."""

    def program(filter_planes, agg_planes, valid):
        lt_lo, _ = kops.predicate_cmp_imm(filter_planes, imm_lo)
        lt_hi, _ = kops.predicate_cmp_imm(filter_planes, imm_hi)
        return eng.reduce_sum_bits(agg_planes, ~lt_lo & lt_hi & valid)

    return program


def _check_shards(n: int, *stacks: Shards) -> None:
    for s in stacks:
        if len(s) != n:
            raise ValueError(f"expected {n} shards, got {len(s)}")


# --------------------------------------------------------------------------
# The host combine of the fused path
# --------------------------------------------------------------------------
def combine_minmax_candidates(bits: torch.Tensor, found: torch.Tensor,
                              is_max: bool):
    """MIN/MAX candidate combine, exact at any bit width.

    ``bits`` is ``(n_candidates, n_bits)`` int32 per-candidate extremum
    bits (LSB-first), ``found`` is ``(n_candidates,)`` bool. MSB-first
    narrowing over the candidate axis: the kernel's tiles, of every shard.
    Returns ``((n_bits,) int32 extremum bits, () bool any-found)``.
    """
    n_bits = bits.shape[1]
    cand = found
    out = [None] * n_bits
    for b in range(n_bits - 1, -1, -1):
        vb = bits[:, b] != 0
        t = cand & vb if is_max else cand & ~vb
        has = torch.any(t)
        out[b] = (has if is_max else ~has).to(torch.int32)
        cand = torch.where(has, t, cand)
    return torch.stack(out), torch.any(found)
