"""PimDatabase: the device-resident database copy + query execution.

The counterpart of ``repro.db.database``:
``PimDatabase(tables, device="cuda").execute(spec_or_specs, engine=...)``
runs one ``QuerySpec`` (one :class:`QueryResult`) or a list of them (one
result per spec, in batch order):

  * ``Engine.FUSED`` — one kernel launch per relation program
    (``core.program``; the hand-written CUDA kernels on a CUDA device,
    their plain PyTorch versions on the CPU), exact host weighting of the
    popcounts. A spec with a host stage (``spec.host``) runs end to end:
    each relation's filter and ``Materialize`` on the device, only the
    selected records copied back, then the numpy host stage
    (``db.exec``: joins, residual predicates, group-by, order/limit);
  * ``Engine.EAGER`` — the instruction-at-a-time engine
    (``core.engine.Engine``), the bit-level oracle: its immediate
    predicates launch the ``eq_imm``/``cmp_imm`` kernels on a CUDA
    device, the rest runs as torch ops, ``Materialize`` is a host
    unpack and gather;
  * ``Engine.ORACLE`` — the numpy column-store scan (paper §5.5), the
    check FUSED is held to, with the same host stage over its own scans.

A FUSED list of two or more specs is a linked batch: every spec is
compiled on its own (canonical, under a ``q<i>.`` register namespace), the
programs are grouped by relation and linked into one SSA program per
relation (``core.program.link_programs`` dedups shared subexpressions),
and each relation runs as ONE program launch (plus one materialize launch
per ``Materialize``), so N queries over ``lineitem`` stream its planes
once. The batch path is split-phase: :meth:`PimDatabase.dispatch_batch`
compiles, links and runs the device stage, :meth:`PimDatabase.finish_query`
runs one query's host stage (thread-safe).

``PimDatabase.apply`` runs a DML batch (``dml`` Insert/Delete/Update/
Compact) against the resident relations on their device and publishes
them: each mutated relation's version goes up once, ``tables`` follows
the live rows, and the accumulated write pressure reaches
``PimDatabase.report``.

``PimDatabase.report`` / :func:`cost_report` project a run to paper scale
through the analytical cost model (``core.cost_model``: cycles, read
traffic, latency, energy and endurance at any scale factor).

``serve.QueryService`` serves concurrent submissions over this class
(admission windows through :meth:`PimDatabase.dispatch_batch`, a
version-keyed result cache), and ``faults.FaultManager`` guards its
relations (parity scrubs, verify-after-write, repair and republish).
"""
from __future__ import annotations

import dataclasses
import enum
import threading
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import analysis
from repro_torch.core import cost_model as cm
from repro_torch.core import engine as eng
from repro_torch.core import isa
from repro_torch.core import program as prog
from . import exec as E
from . import queries as Q
from . import schema as S
from .compiler import And, Compiler, predicate_attrs


@dataclasses.dataclass
class RelationRun:
    """Per-relation outcome of a query.

    The ``agg_plane_reads*`` counters come from the fused executor's
    reduce plan (grouped popcounts vs one read per ReduceSum/MinMax) and
    are zero on EAGER and ORACLE runs, which have no plan.
    """
    n_records: int
    mask: np.ndarray
    trace: List[isa.PimInstruction]
    selectivity: float
    filter_attr_bits: List[int]
    filter_attr_sels: List[float]
    agg_attr_bits: List[int]
    agg_plane_reads: int = 0
    agg_plane_reads_ungrouped: int = 0
    n_reduce_jobs: int = 0


class Engine(enum.Enum):
    """Execution substrate of :meth:`PimDatabase.execute`.

    FUSED — one kernel launch per relation program (linked across the
    queries of a batch).
    EAGER — the instruction-at-a-time engine, the bit-level oracle.
    ORACLE — the numpy column-store scan baseline (paper §5.5).
    """
    FUSED = "fused"
    EAGER = "eager"
    ORACLE = "oracle"

    @classmethod
    def coerce(cls, v) -> "Engine":
        """Accept an Engine, its string value, or a legacy ``fused=``
        bool (True -> FUSED, False -> EAGER)."""
        if isinstance(v, Engine):
            return v
        if isinstance(v, str):
            return cls(v.lower())
        return cls.FUSED if v else cls.EAGER


# Result columns that are derived money at cents x percent scale.
_REVENUE_COLS = {"revenue", "promo_revenue"}


@dataclasses.dataclass
class QueryResult:
    """Result of :meth:`PimDatabase.execute`; every field is present for
    every (engine, spec).

    Mask/aggregate scope (``spec.host is None``): ``aggregates`` (group ->
    {agg: value}; an empty group's avg/min/max is ``None``) and the
    per-relation ``relations`` runs; ``columns``/``rows`` are empty.
    End-to-end scope: ``columns``/``rows`` hold the host stage's result
    table — ``rows`` the exact PIM-encoded integers (``None`` for an empty
    min/max/avg) that the ORACLE comparison uses, ``decoded_rows()`` the
    schema's presentation — and ``materialized_rows`` the records each
    relation handed the host. ``batch_stats`` holds the FUSED run's
    launch-level accounting, shared by every member of one batch (``None``
    on EAGER and ORACLE); ``cached`` is set by the serving layer
    (``serve.QueryService``) when the result came from its result cache."""
    spec: Q.QuerySpec
    engine: Engine = Engine.FUSED
    aggregates: Dict[str, Dict[str, object]] = dataclasses.field(
        default_factory=dict)
    relations: Dict[str, RelationRun] = dataclasses.field(
        default_factory=dict)
    columns: Tuple[str, ...] = ()
    rows: List[tuple] = dataclasses.field(default_factory=list)
    pim_s: float = 0.0
    host_s: float = 0.0
    wall_s: float = 0.0
    materialized_rows: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    batch_stats: Optional[Dict[str, object]] = None
    cached: bool = False

    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def kind(self) -> str:
        return self.spec.kind

    @property
    def wall_time_s(self) -> float:
        return self.wall_s

    @classmethod
    def from_table(cls, spec: Q.QuerySpec, table: E.HostTable,
                   pim_s: float, host_s: float, mat_rows: Dict[str, int],
                   engine: Engine = Engine.FUSED,
                   batch_stats: Optional[Dict[str, object]] = None
                   ) -> "QueryResult":
        cols, rows = _table_rows(table)
        return cls(spec=spec, engine=engine, columns=cols, rows=rows,
                   pim_s=pim_s, host_s=host_s, wall_s=pim_s + host_s,
                   materialized_rows=dict(mat_rows),
                   batch_stats=batch_stats)

    def decoded_rows(self) -> List[tuple]:
        out = []
        for row in self.rows:
            dec = []
            for c, v in zip(self.columns, row):
                if v is None:
                    dec.append(None)
                elif c in _REVENUE_COLS:
                    dec.append(S.decode_revenue(v))
                else:
                    dec.append(S.decode_value(c, v))
            out.append(tuple(dec))
        return out

    @property
    def total_materialized(self) -> int:
        return sum(self.materialized_rows.values())


# Legacy name of the result type.
QueryRun = QueryResult


def _table_rows(table: E.HostTable) -> Tuple[Tuple[str, ...], List[tuple]]:
    def cell(v):
        if v is None:
            return None
        if isinstance(v, (float, np.floating)):   # host-stage avg
            return float(v)
        return int(v)

    cols = tuple(table.columns)
    rows = [tuple(cell(table.columns[c][i]) for c in cols)
            for i in range(table.n_rows)]
    return cols, rows


@dataclasses.dataclass
class PendingQuery:
    """Split-phase handle between :meth:`PimDatabase.dispatch_batch` and
    :meth:`PimDatabase.finish_query`: the device stage has run (masks,
    aggregates and materialized columns demuxed); the host stage, if the
    spec has one, has not."""
    spec: Q.QuerySpec
    engine: Engine
    result: Optional[QueryResult] = None    # complete already (no host)
    host: Optional[object] = None           # E.HostStage still to run
    materialized: Dict[str, E.HostTable] = dataclasses.field(
        default_factory=dict)
    mat_rows: Dict[str, int] = dataclasses.field(default_factory=dict)
    pim_s: float = 0.0
    batch_stats: Optional[Dict[str, object]] = None

    @property
    def needs_host(self) -> bool:
        return self.result is None


@dataclasses.dataclass
class _BatchRelation:
    """One (query, relation) program's wiring inside a linked batch."""
    rel_name: str
    pred: object                            # None for scan-all stages
    compiler: Compiler
    mask_reg: str
    group_regs: List[Tuple[str, Dict]]
    mat_reg: Optional[str]
    slot: int                               # index into the relation's slots


@dataclasses.dataclass
class _BatchQuery:
    """Per-query compile product of ``PimDatabase._compile_batch``."""
    spec: Q.QuerySpec
    host: Optional[object]                  # E.HostStage when end to end
    rels: List[_BatchRelation]


class PimDatabase:
    """The PIM-resident relations of ``tables`` as bit-planes on
    ``device`` (default ``"cuda"``; it raises where CUDA is unavailable
    rather than running anywhere else). ``wear_policy`` is the DML write
    path's slot allocation policy for append segments: ``"rotate"``
    (wear-leveled) or ``"first_fit"`` (the unleveled strawman)."""

    def __init__(self, tables: Dict[str, Dict[str, np.ndarray]],
                 device: Union[str, torch.device] = "cuda",
                 wear_policy: str = "rotate"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"PimDatabase on {self.device}: torch.cuda.is_available() "
                "is false (pass device='cpu' to run the plain PyTorch path)")
        self.tables = tables
        # The lazily built per-relation mutable state (``dml``).
        self.wear_policy = wear_policy
        self._dml: Dict[str, object] = {}
        # Counters of the most recent FUSED execute() — None until one ran.
        self.last_batch_stats: Optional[Dict[str, object]] = None
        # finish_query may add host_s into shared batch stats from several
        # threads at once.
        self._stats_lock = threading.Lock()
        self.relations: Dict[str, eng.PimRelation] = {}
        for name, cols in tables.items():
            if S.SCHEMA[name].in_pim:
                enc = {a.name: a.encoding for a in S.SCHEMA[name].attrs}
                self.relations[name] = eng.PimRelation.from_columns(
                    name, cols, encodings=enc, device=self.device)

    # -- PIM execution ------------------------------------------------------
    def _compile_relation(self, rel: eng.PimRelation, spec: Q.QuerySpec,
                          pred, namespace: str = ""
                          ) -> Tuple[Compiler, str, List[Tuple[str, Dict]]]:
        """Compile the FULL program for one relation: filter, group masks,
        aggregates. Returns (compiler, filter mask register,
        [(group label, {agg name: (kind, reg)})])."""
        c = Compiler(rel, namespace=namespace)
        is_agg_rel = (spec.kind == "full" and rel.name == spec.agg_relation)
        mask_reg = c.compile_filter(pred, with_transform=not is_agg_rel)
        group_regs: List[Tuple[str, Dict]] = []
        if is_agg_rel:
            for label, gpred in (spec.groups or [("all", None)]):
                if gpred is None:
                    gmask = mask_reg
                else:
                    gm = c.compile_pred(gpred)
                    gmask = c.fresh("m")
                    c.program.append(isa.BitwiseAnd(
                        dest=gmask, src_a=mask_reg, src_b=gm))
                group_regs.append((label, c.compile_aggregates(
                    gmask, spec.aggregates)))
        return c, mask_reg, group_regs

    @staticmethod
    def _finalize_aggs(group_regs, read_scalar, read_reduce
                       ) -> Dict[str, Dict[str, object]]:
        aggs: Dict[str, Dict[str, object]] = {}
        for label, regs in group_regs:
            out: Dict[str, object] = {}
            for name, (kind, reg) in regs.items():
                if kind == "avg_pair":
                    s_reg, c_reg = reg.split("/")
                    s, c = int(read_scalar(s_reg)), int(read_scalar(c_reg))
                    # Empty-group avg is None, never a 0/0 pair.
                    out[name] = None if c == 0 else (s, c)
                elif kind == "minmax":
                    out[name] = read_reduce(reg)
                else:
                    out[name] = read_scalar(reg)
            aggs[label] = out
        return aggs

    def _relation_run(self, rel: eng.PimRelation, rel_name: str,
                      spec: Q.QuerySpec, pred, mask: np.ndarray,
                      trace: List[isa.PimInstruction],
                      cp: Optional[prog.CompiledProgram] = None
                      ) -> RelationRun:
        cols = self.tables[rel_name]
        attrs = predicate_attrs(pred)
        sels = _conjunct_selectivities(cols, pred)
        agg_bits: List[int] = []
        if spec.kind == "full" and rel_name == spec.agg_relation:
            for a in spec.aggregates:
                if a.expr is not None:
                    agg_bits += [rel.width_of(x)
                                 for x in predicate_attrs_of_expr(a.expr)]
        return RelationRun(
            n_records=rel.n_records, mask=mask, trace=trace,
            selectivity=float(mask.mean()) if mask.size else 0.0,
            filter_attr_bits=[rel.width_of(a) for a in attrs],
            filter_attr_sels=sels, agg_attr_bits=agg_bits,
            agg_plane_reads=cp.agg_plane_reads if cp else 0,
            agg_plane_reads_ungrouped=(cp.agg_plane_reads_ungrouped
                                       if cp else 0),
            n_reduce_jobs=cp.n_reduce_jobs if cp else 0)

    # -- execution entry point ------------------------------------------------
    def execute(self, spec_or_specs: Union[Q.QuerySpec,
                                           Sequence[Q.QuerySpec]], *,
                engine: Union[Engine, str, bool] = Engine.FUSED
                ) -> Union[QueryResult, List[QueryResult]]:
        """Run one :class:`~repro_torch.db.queries.QuerySpec` on ``engine``
        (an :class:`Engine`, its string value or a legacy ``fused=``
        bool): end to end when it carries a host stage, else its masks
        and aggregates. A sequence returns one result per spec in batch
        order: on FUSED, two or more specs are linked into one program
        launch per relation (:meth:`dispatch_batch`); ``[]`` returns
        ``[]`` and clears ``last_batch_stats``, and a one-element list or
        another engine runs spec by spec. ``last_batch_stats`` is set by
        FUSED runs only."""
        engine = Engine.coerce(engine)
        if isinstance(spec_or_specs, Q.QuerySpec):
            return self._execute_one(spec_or_specs, engine)
        specs = list(spec_or_specs)
        if not specs:
            # Nothing to link or launch; clear stale batch counters so no
            # caller reads a previous batch's as this one's.
            self.last_batch_stats = _empty_batch_stats()
            return []
        if len(specs) == 1 or engine is not Engine.FUSED:
            return [self._execute_one(s, engine) for s in specs]
        pendings, _ = self.dispatch_batch(specs)
        return [self.finish_query(p) for p in pendings]

    def _execute_one(self, spec: Q.QuerySpec, engine: Engine) -> QueryResult:
        if engine is Engine.ORACLE:
            return self._execute_baseline(spec)
        if spec.host is not None:
            return self._execute_host(spec, engine)
        return self._execute_pim(spec, engine)

    def _execute_pim(self, spec: Q.QuerySpec, engine: Engine
                     ) -> QueryResult:
        """Mask/aggregate scope. FUSED: one compiled launch per relation
        program — the paper's single-pass, single-readout execution
        model. EAGER: the instruction-at-a-time engine (the oracle)."""
        t_all = time.perf_counter()
        fused = engine is Engine.FUSED
        rel_runs: Dict[str, RelationRun] = {}
        aggs: Dict[str, Dict[str, object]] = {}
        rel_stats: Dict[str, Dict[str, object]] = {}
        pim_s = 0.0
        for rel_name, pred in spec.filters.items():
            rel = self.relations[rel_name]
            c, mask_reg, group_regs = self._compile_relation(rel, spec, pred)
            cp = None
            if fused:
                cp = prog.compile_program(rel, c.program,
                                          mask_outputs=(mask_reg,))
                t0 = time.perf_counter()
                res = prog.run_program(cp, rel)
                dt = time.perf_counter() - t0
                pim_s += dt
                if group_regs:
                    aggs.update(self._finalize_aggs(group_regs, res.scalar,
                                                    res.scalar))
                mask = res.mask(mask_reg)
                rel_stats[rel_name] = _single_relation_stats(c, cp, dt)
            else:
                e = eng.Engine(rel)
                e.run(c.program)
                if group_regs:
                    aggs.update(self._finalize_aggs(
                        group_regs, lambda r: int(e.read_scalar(r)),
                        e.read_reduce))
                mask = e.read_mask(mask_reg)
            rel_runs[rel_name] = self._relation_run(
                rel, rel_name, spec, pred, mask, list(c.program), cp)
        wall = time.perf_counter() - t_all
        stats = None
        if fused:
            stats = _empty_batch_stats()
            stats.update(n_queries=1, n_dispatches=len(rel_stats),
                         pim_s=pim_s, wall_s=wall, relations=rel_stats)
            self.last_batch_stats = stats
        return QueryResult(spec=spec, engine=engine, aggregates=aggs,
                           relations=rel_runs, pim_s=pim_s, wall_s=wall,
                           batch_stats=stats)

    # -- end-to-end execution (PIM stage + host stage) -----------------------
    def _execute_host(self, spec: Q.QuerySpec, engine: Engine
                      ) -> QueryResult:
        """End to end: each relation's filter (or scan-all) and
        ``Materialize`` hand the host only the selected records; the host
        stage (``db.exec``) joins, applies residual predicates,
        aggregates and orders them into TPC-H result rows. FUSED runs each
        relation as one compiled program — the program kernel, then the
        materialize kernel; EAGER runs the instruction-at-a-time engine
        (the oracle path)."""
        fused = engine is Engine.FUSED
        pim_stage, host = E.split_query(spec)
        t0 = time.perf_counter()
        materialized: Dict[str, E.HostTable] = {}
        mat_rows: Dict[str, int] = {}
        rel_stats: Dict[str, Dict[str, object]] = {}
        for rel_name, pred, cols in pim_stage:
            rel = self.relations[rel_name]
            c = Compiler(rel)
            mask_reg = (c.compile_filter(pred, with_transform=False)
                        if pred is not None else c.compile_scan_all())
            mat_reg = c.compile_materialize(mask_reg, cols)
            if fused:
                cp = prog.compile_program(rel, c.program, mask_outputs=())
                t1 = time.perf_counter()
                vals = prog.run_program(cp, rel).materialized(mat_reg)
                rel_stats[rel_name] = _single_relation_stats(
                    c, cp, time.perf_counter() - t1)
            else:
                e = eng.Engine(rel)
                e.run(c.program)
                vals = e.read_materialized(mat_reg)
            materialized[rel_name] = E.HostTable(
                {a: np.asarray(v, np.int64) for a, v in vals.items()})
            mat_rows[rel_name] = materialized[rel_name].n_rows
        pim_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        table = E.run_host_stage(host, E.ExecContext(materialized,
                                                     self.tables))
        host_s = time.perf_counter() - t0
        stats = None
        if fused:
            stats = _empty_batch_stats()
            stats.update(n_queries=1, n_dispatches=len(rel_stats),
                         pim_s=sum(s["pim_s"] for s in rel_stats.values()),
                         host_s=host_s, wall_s=pim_s + host_s,
                         relations=rel_stats)
            self.last_batch_stats = stats
        return QueryResult.from_table(spec, table, pim_s, host_s, mat_rows,
                                      engine=engine, batch_stats=stats)

    # -- batched execution (cross-query linking) ------------------------------
    def _compile_batch(self, specs) -> Tuple[
            List[_BatchQuery], Dict[str, List[Tuple[tuple, tuple]]]]:
        """Compile every spec's per-relation programs, each under its own
        ``q<i>.`` register namespace, and group them by relation for
        linking. Returns (per-query wiring, {relation: [(instrs,
        mask_outputs)] in slot order})."""
        works: List[_BatchQuery] = []
        rel_programs: Dict[str, List[Tuple[tuple, tuple]]] = {}
        for qi, spec in enumerate(specs):
            ns = f"q{qi}."
            rels: List[_BatchRelation] = []
            if spec.host is not None:
                pim_stage, host = E.split_query(spec)
                for rel_name, pred, cols in pim_stage:
                    rel = self.relations[rel_name]
                    c = Compiler(rel, namespace=ns)
                    mask_reg = (c.compile_filter(pred, with_transform=False)
                                if pred is not None else c.compile_scan_all())
                    mat_reg = c.compile_materialize(mask_reg, cols)
                    progs = rel_programs.setdefault(rel_name, [])
                    rels.append(_BatchRelation(rel_name, pred, c, mask_reg,
                                               [], mat_reg, len(progs)))
                    progs.append((tuple(c.program), ()))
                works.append(_BatchQuery(spec, host, rels))
            else:
                for rel_name, pred in spec.filters.items():
                    rel = self.relations[rel_name]
                    c, mask_reg, group_regs = self._compile_relation(
                        rel, spec, pred, namespace=ns)
                    progs = rel_programs.setdefault(rel_name, [])
                    rels.append(_BatchRelation(rel_name, pred, c, mask_reg,
                                               group_regs, None, len(progs)))
                    progs.append((tuple(c.program), (mask_reg,)))
                works.append(_BatchQuery(spec, None, rels))
        return works, rel_programs

    def dispatch_batch(self, specs: Sequence[Q.QuerySpec]
                       ) -> Tuple[List[PendingQuery], Dict[str, object]]:
        """Device stage of a FUSED batch: the specs are compiled on their
        own (canonical, namespaced), grouped by relation, linked into ONE
        SSA program per relation (``core.program.link_programs``) and run
        as one program launch per relation, plus one materialize launch
        per ``Materialize``. Each query's outputs are demuxed through the
        linked program's ``query_slots``.

        Host stages do not run here: each returned :class:`PendingQuery`
        either carries its complete :class:`QueryResult` (mask/aggregate
        specs) or holds the demuxed host tables for :meth:`finish_query`.
        Linking is deterministic, so a recurring batch records the same
        linked program and hits the tape cache. The batch counters
        (launches, plane reads, dedup, linked keys, walls) land in
        ``last_batch_stats`` and are returned."""
        t_all = time.perf_counter()
        works, rel_programs = self._compile_batch(specs)

        compiled: Dict[str, prog.CompiledProgram] = {}
        results: Dict[str, prog.ProgramResult] = {}
        linked: Dict[str, prog.LinkedProgram] = {}
        pim_wall: Dict[str, float] = {}
        for rel_name, programs in rel_programs.items():
            rel = self.relations[rel_name]
            lp = prog.link_programs(programs, relation=rel)
            cp = prog.compile_program(rel, lp.instrs,
                                      mask_outputs=lp.mask_outputs,
                                      query_slots=lp.slots)
            t0 = time.perf_counter()
            res = prog.run_program(cp, rel)
            pim_wall[rel_name] = time.perf_counter() - t0
            compiled[rel_name], results[rel_name] = cp, res
            linked[rel_name] = lp

        # Each relation's one launch is shared: attribute its time evenly
        # to the queries that read it.
        n_users: Dict[str, int] = {}
        for w in works:
            for br in w.rels:
                n_users[br.rel_name] = n_users.get(br.rel_name, 0) + 1
        share = {r: pim_wall[r] / n_users[r] for r in pim_wall}

        stats: Dict[str, object] = {
            "n_queries": len(works),
            "n_dispatches": len(rel_programs),
            "pim_s": sum(pim_wall.values()),
            "demux_s": 0.0,
            "host_s": 0.0,
            "wall_s": 0.0,
            "relations": {
                r: {"n_programs": len(rel_programs[r]),
                    "instrs_unlinked": linked[r].n_instrs_unlinked,
                    "instrs_linked": len(linked[r].instrs),
                    "instrs_deduped": linked[r].n_deduped,
                    "plane_reads": compiled[r].total_plane_reads,
                    "agg_plane_reads": compiled[r].agg_plane_reads,
                    "source_plane_reads": compiled[r].source_plane_reads,
                    "linked_key": linked[r].cache_key,
                    "pim_s": pim_wall[r]}
                for r in rel_programs},
        }

        pendings: List[PendingQuery] = []
        demux_s = 0.0
        for w in works:
            t0 = time.perf_counter()
            if w.host is not None:
                materialized: Dict[str, E.HostTable] = {}
                mat_rows: Dict[str, int] = {}
                pim_s = 0.0
                for br in w.rels:
                    view = results[br.rel_name].query(br.slot)
                    vals = view.materialized(br.mat_reg)
                    materialized[br.rel_name] = E.HostTable(
                        {a: np.asarray(v, np.int64)
                         for a, v in vals.items()})
                    mat_rows[br.rel_name] = materialized[br.rel_name].n_rows
                    pim_s += share[br.rel_name]
                pendings.append(PendingQuery(
                    w.spec, Engine.FUSED, host=w.host,
                    materialized=materialized, mat_rows=mat_rows,
                    pim_s=pim_s, batch_stats=stats))
            else:
                rel_runs: Dict[str, RelationRun] = {}
                aggs: Dict[str, Dict[str, object]] = {}
                wall = 0.0
                for br in w.rels:
                    view = results[br.rel_name].query(br.slot)
                    mask = view.mask(br.mask_reg)
                    if br.group_regs:
                        aggs.update(self._finalize_aggs(
                            br.group_regs, view.scalar, view.scalar))
                    rel = self.relations[br.rel_name]
                    rel_runs[br.rel_name] = self._relation_run(
                        rel, br.rel_name, w.spec, br.pred, mask,
                        list(br.compiler.program),
                        cp=compiled[br.rel_name])
                    wall += share[br.rel_name]
                res = QueryResult(
                    spec=w.spec, engine=Engine.FUSED, aggregates=aggs,
                    relations=rel_runs, pim_s=wall,
                    wall_s=wall + time.perf_counter() - t0,
                    batch_stats=stats)
                pendings.append(PendingQuery(w.spec, Engine.FUSED,
                                             result=res, pim_s=wall,
                                             batch_stats=stats))
            demux_s += time.perf_counter() - t0

        stats["demux_s"] = demux_s
        stats["wall_s"] = time.perf_counter() - t_all
        self.last_batch_stats = stats
        return pendings, stats

    def finish_query(self, pending: PendingQuery) -> QueryResult:
        """Host stage of one :meth:`dispatch_batch` query; a mask/aggregate
        spec's result is complete already. Thread-safe: several threads may
        finish queries of one batch at once."""
        if pending.result is not None:
            return pending.result
        t0 = time.perf_counter()
        table = E.run_host_stage(
            pending.host, E.ExecContext(pending.materialized, self.tables))
        host_s = time.perf_counter() - t0
        if pending.batch_stats is not None:
            with self._stats_lock:
                pending.batch_stats["host_s"] = (
                    pending.batch_stats.get("host_s", 0.0) + host_s)
        return QueryResult.from_table(
            pending.spec, table, pending.pim_s, host_s, pending.mat_rows,
            engine=pending.engine, batch_stats=pending.batch_stats)

    # -- baseline (numpy scan oracle) ----------------------------------------
    def _execute_baseline(self, spec: Q.QuerySpec) -> QueryResult:
        """The paper's §5.5 in-memory column-store scan. For a spec with a
        host stage the filter masks come from the same numpy scans
        (``exec.baseline_context``) and the host stage runs over them —
        full result rows, no device involved."""
        t_all = time.perf_counter()
        rel_runs: Dict[str, RelationRun] = {}
        aggs: Dict[str, Dict[str, object]] = {}
        for rel_name, pred in spec.filters.items():
            cols = self.tables[rel_name]
            n = len(next(iter(cols.values())))
            mask = Q.eval_pred(cols, pred)
            if spec.kind == "full" and rel_name == spec.agg_relation:
                for label, gpred in (spec.groups or [("all", None)]):
                    gmask = (mask if gpred is None
                             else mask & Q.eval_pred(cols, gpred))
                    aggs[label] = {a.name: Q.eval_aggregate(cols, gmask, a)
                                   for a in spec.aggregates}
            rel_runs[rel_name] = RelationRun(
                n_records=n, mask=mask, trace=[],
                selectivity=float(mask.mean()) if mask.size else 0.0,
                filter_attr_bits=[], filter_attr_sels=[], agg_attr_bits=[])
        columns: Tuple[str, ...] = ()
        rows: List[tuple] = []
        mat_rows: Dict[str, int] = {}
        host_s = 0.0
        if spec.host is not None:
            t0 = time.perf_counter()
            ctx = E.baseline_context(self.tables, spec)
            table = E.run_host_stage(spec.host, ctx)
            host_s = time.perf_counter() - t0
            columns, rows = _table_rows(table)
            mat_rows = {r: t.n_rows for r, t in ctx.materialized.items()}
        return QueryResult(spec=spec, engine=Engine.ORACLE,
                           aggregates=aggs, relations=rel_runs,
                           columns=columns, rows=rows, host_s=host_s,
                           wall_s=time.perf_counter() - t_all,
                           materialized_rows=mat_rows)

    # -- DML (``dml``): mutable relations -----------------------------------
    def dml_state(self, rel_name: str):
        """The lazily built :class:`~repro_torch.dml.RelationDml` of one
        PIM-resident relation (created on first use; the relation handle
        is republished with its append-segment capacity pinned, which
        keeps ``layout.n_words`` stable across within-capacity
        inserts)."""
        from repro_torch import dml as dml_mod   # lazy: dml imports db
        d = self._dml.get(rel_name)
        if d is None:
            if rel_name not in self.relations:
                raise KeyError(f"{rel_name!r} is not PIM-resident")
            d = dml_mod.RelationDml(self.relations[rel_name],
                                    self.tables[rel_name],
                                    policy=self.wear_policy)
            self.relations[rel_name] = d.rel
            self._dml[rel_name] = d
        return d

    def apply(self, mutations: Sequence[object]
              ) -> Dict[str, Dict[str, object]]:
        """Apply a DML batch (``dml`` Insert/Delete/Update/Compact specs) in
        order, on each relation's device, and publish the mutated
        relations (:meth:`publish`: each version goes up once per batch,
        ``self.tables`` follows the live rows). Returns per-relation
        accounting."""
        from repro_torch import dml as dml_mod
        stats: Dict[str, Dict[str, object]] = {}
        order: List[str] = []
        for m in mutations:
            name = dml_mod.mutation_relation(m)
            st = self.dml_state(name).apply(m)
            entry = stats.setdefault(name, {
                "n_mutations": 0, "n_rows": 0, "n_instructions": 0,
                "cycles": 0, "cells_written": 0})
            entry["n_mutations"] += 1
            entry["n_rows"] += st.n_rows
            entry["n_instructions"] += st.n_instructions
            entry["cycles"] += st.cycles
            entry["cells_written"] += st.cells_written
            if name not in order:
                order.append(name)
        versions = self.publish(order)
        for name in order:
            d = self._dml[name]
            entry = stats[name]
            entry["version"] = versions[name]
            entry["busiest_row_ops"] = d.segments.busiest_row_ops()
            entry["capacity_records"] = d.capacity
        return stats

    def publish(self, rel_names: Sequence[str]) -> Dict[str, int]:
        """Publish the current DML state of each named relation: bump the
        content version (version-keyed result caches miss from then on by
        construction) and re-point ``self.tables`` at the live rows
        (logical-id order), keeping the ORACLE path in step. The tables
        dict is shallow-copied first: several databases may share one.
        Returns ``{name: new_version}``."""
        self.tables = dict(self.tables)
        versions: Dict[str, int] = {}
        for name in rel_names:
            d = self._dml[name]
            version = max(d.rel.version,
                          self.relations[name].version) + 1
            rel = dataclasses.replace(d.rel, version=version)
            self.relations[name] = rel
            d.rel = rel
            self.tables[name] = d.live_columns()
            versions[name] = version
        return versions

    def dml_row_ops(self) -> Dict[str, float]:
        """Accumulated busiest-row DML cell writes per mutated relation
        (the §6.4 write pressure ``cost_report`` folds into endurance)."""
        return {name: d.segments.busiest_row_ops()
                for name, d in self._dml.items()}

    def report(self, run: QueryResult, sf_scale: float = 1.0,
               hw: cm.HwParams = cm.DEFAULT_HW) -> "QueryCostReport":
        """:func:`cost_report` with this database's state: resident and
        reserved plane bytes, and the accumulated DML write pressure."""
        return cost_report(run, sf_scale, hw, relations=self.relations,
                           dml_row_ops=self.dml_row_ops())

    # -- relation versioning -------------------------------------------------
    def bump_version(self, rel_name: str) -> int:
        """Advance a relation's monotonic content version (version-keyed
        result caches miss from then on by construction). Returns the new
        version."""
        rel = self.relations[rel_name].bumped()
        self.relations[rel_name] = rel
        return rel.version

    # -- deprecated shims ----------------------------------------------------
    def run_pim(self, spec: Q.QuerySpec, fused: bool = True) -> QueryResult:
        """Deprecated: use ``execute(spec.filter_only(), engine=...)``."""
        warnings.warn(
            "PimDatabase.run_pim is deprecated; use "
            "execute(spec.filter_only(), engine=Engine.FUSED/EAGER)",
            DeprecationWarning, stacklevel=2)
        return self.execute(spec.filter_only(), engine=Engine.coerce(fused))

    def run_query(self, spec: Q.QuerySpec, fused: bool = True
                  ) -> QueryResult:
        """Deprecated: use ``execute(spec, engine=...)``."""
        warnings.warn(
            "PimDatabase.run_query is deprecated; use "
            "execute(spec, engine=Engine.FUSED/EAGER)",
            DeprecationWarning, stacklevel=2)
        return self.execute(spec, engine=Engine.coerce(fused))

    def run_queries(self, specs, fused: bool = True) -> List[QueryResult]:
        """Deprecated: use ``execute(list_of_specs, engine=...)``."""
        warnings.warn(
            "PimDatabase.run_queries is deprecated; use "
            "execute(specs, engine=Engine.FUSED/EAGER)",
            DeprecationWarning, stacklevel=2)
        return self.execute(list(specs), engine=Engine.coerce(fused))

    def run_baseline(self, spec: Q.QuerySpec) -> QueryResult:
        """The numpy column-scan oracle at the spec's filter scope, equal
        to ``execute(spec.filter_only(), engine=Engine.ORACLE)`` (not
        deprecated: it is the oracle results are held to)."""
        return self._execute_baseline(spec.filter_only())


def _empty_batch_stats() -> Dict[str, object]:
    return {"n_queries": 0, "n_dispatches": 0, "pim_s": 0.0,
            "demux_s": 0.0, "host_s": 0.0, "wall_s": 0.0, "relations": {}}


def _single_relation_stats(c: Compiler, cp: prog.CompiledProgram,
                           pim_s: float) -> Dict[str, object]:
    """Per-relation stats of one single-query launch (zero dedup, one
    program), plus the tape's length and slot count."""
    n = len(c.program)
    return {"n_programs": 1, "instrs_unlinked": n, "instrs_linked": n,
            "instrs_deduped": 0,
            "plane_reads": cp.total_plane_reads,
            "agg_plane_reads": cp.agg_plane_reads,
            "source_plane_reads": cp.source_plane_reads,
            "linked_key": None, "pim_s": pim_s,
            "tape_len": len(cp.tape), "n_slots": cp.tape.n_slots}


def avg_value(pair) -> Optional[float]:
    """Finalize an exact avg (sum, count) pair into a float; an empty
    group (``None``) stays ``None``."""
    if pair is None:
        return None
    s, c = pair
    return s / c


def predicate_attrs_of_expr(e) -> List[str]:
    from .compiler import Col, Mul, AddE, RSubImm, Lit
    out: List[str] = []

    def walk(x):
        if isinstance(x, Col):
            out.append(x.name)
        elif isinstance(x, (Mul, AddE)):
            walk(x.a)
            if not isinstance(x.b, Lit):
                walk(x.b)
        elif isinstance(x, RSubImm):
            walk(x.e)

    walk(e)
    return list(dict.fromkeys(out))


def _conjunct_selectivities(cols, pred) -> List[float]:
    """Per-conjunct pass fractions in evaluation order (baseline model)."""
    conjs = list(pred.ps) if isinstance(pred, And) else [pred]
    sels = []
    for c in conjs:
        try:
            sels.append(float(Q.eval_pred(cols, c).mean()))
        except Exception:
            sels.append(1.0)
    return sels


# --------------------------------------------------------------------------
# Paper-scale cost report (the gem5 stand-in)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class QueryCostReport:
    """The paper's analytical projection of one query (Figs. 8/11/15):
    Table 4 cycles, modelled PIM and baseline times, read reduction,
    energy saving and the endurance needed for ten years."""
    name: str
    kind: str
    cycles: Dict[str, int]
    pim_time_s: float
    read_time_s: float
    baseline_time_s: float
    speedup: float
    read_reduction: float
    energy_saving: float
    endurance_ops_per_cell_10y: float
    intermediate_cells: int
    # Device-resident plane bytes of the relations the query touched
    # (every attribute plane plus the valid plane over the full capacity)
    # and the reserved-but-unused share; 0 without relation handles.
    bytes_resident: int = 0
    bytes_reserved: int = 0
    # Busiest-row DML cell writes folded into the endurance projection.
    dml_row_ops: float = 0.0

    def row(self) -> str:
        return (f"{self.name},{self.kind},{self.cycles['total']},"
                f"{self.speedup:.2f},{self.read_reduction:.1f},"
                f"{self.energy_saving:.2f},"
                f"{self.endurance_ops_per_cell_10y:.3g}")


def cost_report(run: QueryResult, sf_scale: float = 1.0,
                hw: cm.HwParams = cm.DEFAULT_HW, relations=None,
                dml_row_ops=None) -> QueryCostReport:
    """Project a run to paper scale (records x ``sf_scale``) and produce
    Fig. 8/11/15-comparable numbers. The PIM cycle count does not depend
    on the relation's size (requests broadcast to all pages); read and
    baseline scan traffic scale linearly with it.

    ``relations`` ({name: PimRelation}) adds resident/reserved plane
    bytes of the touched relations; ``dml_row_ops`` ({name: ops}) folds
    busiest-row DML writes into the endurance projection.
    """
    total = cm.ProgramCost()
    base_bytes = 0
    base_ops = 0.0
    pim_bytes = 0
    n_crossbars_busiest = 0
    exec_pages = 0
    trace_row_ops = 0.0
    bytes_resident = 0
    bytes_reserved = 0
    dml_ops = 0.0
    for rel_name, rr in run.relations.items():
        if relations is not None and rel_name in relations:
            bytes_resident += relations[rel_name].bytes_resident()
            bytes_reserved += relations[rel_name].bytes_reserved()
        if dml_row_ops is not None:
            dml_ops += float(dml_row_ops.get(rel_name, 0.0))
        n_scaled = int(rr.n_records * sf_scale)
        cost = cm.classify_program(rr.trace)
        for f in dataclasses.fields(cm.ProgramCost):
            setattr(total, f.name,
                    getattr(total, f.name) + getattr(cost, f.name))
        # Trace-derived §6.4 write pressure (per-instruction sums).
        trace_row_ops += analysis.write_profile(rr.trace).busiest_row_ops
        # Baseline: scan the predicate attributes (short-circuit and
        # cacheline model), then the aggregate attributes of passing rows.
        sels = rr.filter_attr_sels or [1.0] * len(rr.filter_attr_bits)
        base_bytes += cm.baseline_scan_bytes(
            n_scaled, rr.filter_attr_bits, sels, hw)
        for bits in rr.agg_attr_bits:
            base_bytes += int(n_scaled * rr.selectivity * bits / 8)
        # Host record-loop ops: predicate checks with short-circuit, then
        # the dependent chain of the aggregation arithmetic.
        pass_frac = 1.0
        for sel in sels:
            base_ops += 0.4 * n_scaled * pass_frac
            pass_frac *= sel
        n_xbars = max(1, -(-n_scaled // 1024))
        exec_pages += max(1, n_xbars // 16384)
        if run.spec.kind == "full" and rel_name == run.spec.agg_relation:
            n_aggs = sum(2 if a.op == "avg" else 1
                         for a in run.spec.aggregates)
            n_groups = len(run.spec.groups or [1])
            n_mults = sum(1 for i in rr.trace if i.kind == "Multiply")
            base_ops += n_scaled * rr.selectivity * (
                6.0 * n_aggs + 3.0 * n_mults + 2.0)
            pim_bytes += cm.pim_read_bytes_aggregate(n_xbars,
                                                     n_aggs * n_groups)
        else:
            pim_bytes += cm.pim_read_bytes_filter(n_scaled)
        n_crossbars_busiest = max(n_crossbars_busiest, n_xbars)

    timing = cm.query_timing(total, 0, n_crossbars_busiest, base_bytes,
                             pim_bytes, n_modules=min(8, exec_pages),
                             baseline_ops=base_ops, hw=hw)
    energy = cm.query_energy(total, timing, n_crossbars_busiest, hw=hw)
    endurance = cm.endurance_ops_per_cell(
        total, exec_time_s=timing.pimdb_total_s, hw=hw,
        busiest_row_ops=trace_row_ops + dml_ops)
    return QueryCostReport(
        run.spec.name, run.spec.kind,
        dict(total=total.cycles_total, **total.breakdown()),
        timing.pim_time_s, timing.read_time_s, timing.baseline_time_s,
        timing.speedup, timing.read_reduction, energy.saving, endurance,
        total.intermediate_cells_peak,
        bytes_resident=bytes_resident, bytes_reserved=bytes_reserved,
        dml_row_ops=dml_ops)
