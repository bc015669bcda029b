"""Lint driver: statically verify every TPC-H relation program.

The counterpart of ``repro.analysis.lint``: the same five collections of
programs, checked on the port's two backend schedules (``"eager"`` and
``"fused"``, ``passes.BACKENDS``) instead of the reference's three.

``python -m repro_torch.analysis.lint`` builds the full query inventory — all
19 TPC-H query specs (filter programs with their group/aggregate tails),
the end-to-end materialize variants of every query with a host stage,
a scan-all program per PIM relation, LINKED multi-query programs
(every adjacent pair plus a leading triple of the queries sharing each
relation, built exactly the way ``PimDatabase.execute`` builds them:
namespaced compile, ``core.program.link_programs``), the serving
frontend's admission-window fusions (the coalesced windows the
``serve_concurrent`` bench and CLI traces dispatch), and the write
programs of the DML path and of fault repair — and runs every analysis
pass over each program on both backend schedules. No tape is recorded:
only the static front half of the compile pipeline runs. The database
(and so the DML write programs, which execute as they are emitted) lives
on ``--device``: ``cuda`` by default, ``cpu`` for the plain path.

Exit status is non-zero when any error-severity diagnostic is produced
(or any warning, under ``--strict``).
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import List, Tuple

from repro_torch.core import engine as eng
from repro_torch.db import exec as E
from repro_torch.db import queries as Q
from repro_torch.db import tpch
from repro_torch.db.compiler import Compiler
from repro_torch.db.database import PimDatabase

from .diagnostics import Diagnostic
from .passes import BACKENDS, build_context, run_passes

Program = Tuple[str, eng.PimRelation, tuple, Tuple[str, ...]]


def collect_programs(db: PimDatabase) -> List[Program]:
    """(label, relation, instrs, mask_outputs) for every program the
    database would compile: query filters, materialize variants of the
    end-to-end queries, and per-relation scan-alls."""
    programs: List[Program] = []
    for spec in Q.all_queries():
        for rel_name, pred in spec.filters.items():
            rel = db.relations[rel_name]
            c, mask_reg, _ = db._compile_relation(rel, spec, pred)
            programs.append((f"{spec.name}/{rel_name}", rel,
                             tuple(c.program), (mask_reg,)))
        if spec.host is not None:
            pim_stage, _ = E.split_query(spec)
            for rel_name, pred, cols in pim_stage:
                rel = db.relations[rel_name]
                c = Compiler(rel)
                mask_reg = (c.compile_filter(pred, with_transform=False)
                            if pred is not None else c.compile_scan_all())
                c.compile_materialize(mask_reg, cols)
                programs.append((f"{spec.name}/{rel_name}/materialize",
                                 rel, tuple(c.program), ()))
    for rel_name, rel in sorted(db.relations.items()):
        c = Compiler(rel)
        m = c.compile_scan_all()
        programs.append((f"scan-all/{rel_name}", rel,
                         tuple(c.program), (m,)))
    return programs


def collect_linked_programs(db: PimDatabase) -> List[Program]:
    """Linked multi-query programs: for each PIM relation, every adjacent
    pair of the queries touching it plus the leading triple (and always
    the Q1+Q6+Q14 headline batch) — the same cross-query fusion products
    ``PimDatabase.execute(list)`` dispatches, so the verifier gates them
    exactly like the single-query inventory."""
    from repro_torch.core import program as prog

    specs = Q.all_queries()
    by_rel: dict = {}
    for spec in specs:
        if spec.host is not None:
            rels = {r for r, _, _ in E.split_query(spec)[0]}
        else:
            rels = set(spec.filters)
        for r in rels:
            by_rel.setdefault(r, []).append(spec)

    combos: List[Tuple[str, tuple]] = []
    for r, members in sorted(by_rel.items()):
        for i in range(len(members) - 1):
            combos.append((r, tuple(members[i:i + 2])))
        if len(members) >= 3:
            combos.append((r, tuple(members[:3])))
    combos.append(("lineitem", tuple(Q.get_query(n)
                                     for n in ("Q1", "Q6", "Q14"))))

    programs: List[Program] = []
    seen = set()
    for r, combo in combos:
        names = tuple(s.name for s in combo)
        if (r, names) in seen:
            continue
        seen.add((r, names))
        _, rel_programs = db._compile_batch(list(combo))
        if len(rel_programs.get(r, ())) < 2:
            continue
        lp = prog.link_programs(rel_programs[r], relation=db.relations[r])
        programs.append((f"linked/{'+'.join(names)}/{r}",
                         db.relations[r], lp.instrs, lp.mask_outputs))
    return programs


def collect_serve_programs(db: PimDatabase) -> List[Program]:
    """Admission-window fusion products of the serving frontend: the
    windows the reference's ``repro.serve.QueryService`` dispatches when
    the benchmark/CLI traces replay — each window's coalesced spec set
    (duplicates collapse onto one in-flight dispatch, exactly as the
    service's cache-key coalescing does) linked per relation.  These are
    the programs reachable through ``PimDatabase.execute`` that the
    static pair/triple sweep above does not cover."""
    from repro_torch.core import program as prog
    from repro_torch.db.database import Engine
    from repro_torch.serve.cache import spec_cache_key

    # The serve_concurrent bench wave + the CLI default trace's
    # distinct-query window.
    windows = [
        ("bench-wave", ["Q1", "Q6", "Q14", "Q3", "Q12", "Q19",
                        "Q6", "Q1"]),
        ("cli-trace", ["Q1", "Q6", "Q14", "Q3", "Q12", "Q19",
                       "Q3", "Q6", "Q14", "Q12", "Q1", "Q6"]),
    ]
    programs: List[Program] = []
    seen = set()
    for wname, names in windows:
        coalesced, keys = [], set()
        for n in names:
            spec = Q.get_query(n)
            k = spec_cache_key(db, spec, Engine.FUSED)
            if k not in keys:
                keys.add(k)
                coalesced.append(spec)
        _, rel_programs = db._compile_batch(coalesced)
        for r, progs in sorted(rel_programs.items()):
            if len(progs) < 2:
                continue
            lp = prog.link_programs(progs, relation=db.relations[r])
            if (r, lp.cache_key) in seen:
                continue
            seen.add((r, lp.cache_key))
            programs.append((f"serve/{wname}/{r}", db.relations[r],
                             lp.instrs, lp.mask_outputs))
    return programs


def collect_dml_programs(db: PimDatabase) -> List[Program]:
    """DML-generated write programs (``dml``): a representative
    insert / predicate delete / in-place update / compact on each of two
    relations, captured exactly as ``RelationDml`` emitted (and ran)
    them — so the PlaneWrite/ValidClear validation in the kinds pass and
    the write-aware def-use schedule gate the mutation path too."""
    import numpy as np

    from repro_torch.db.queries import get_query

    programs: List[Program] = []
    for rel_name in ("lineitem", "customer"):
        d = db.dml_state(rel_name)
        cols = db.tables[rel_name]
        take = {a: np.asarray(c[:8]) for a, c in cols.items()}
        snap = []

        def emit(op):
            snap.append((f"dml/{rel_name}/{op}", d.rel))

        emit("insert")
        d.insert(take)
        emit("delete")
        d.delete(row_ids=d.live_ids()[:4])
        if rel_name == "lineitem":
            emit("update")
            pred = get_query("Q6").filters["lineitem"]
            d.update({"l_quantity": 7}, pred=pred)
        emit("compact")
        d.compact()
        # Pair each captured (label, relation-at-emit-time) with the
        # program RelationDml recorded for that mutation.
        for (label, rel), (_, instrs) in zip(snap, d.programs):
            programs.append((label, rel, instrs, ()))
    return programs


def collect_fault_programs(db: PimDatabase) -> List[Program]:
    """Fault-recovery write programs (the reference's ``repro.faults``,
    driven here through ``RelationDml``'s repair primitives): a soft in-place
    rewrite (live row + ghost valid clear) and a hard-fault remap
    (quarantine clear + move into spare capacity) on a relation the DML
    sweep above does not mutate, captured exactly as ``RelationDml``
    emitted them — the repair path is gated by the same static passes as
    the workload path."""
    d = db.dml_state("orders")
    n_before = len(d.programs)
    live = d.live_ids()
    # Soft repair: one live slot plus a ghost slot past the watermark.
    ghost = d.capacity - 1
    d.rewrite_rows([int(d.slot_of[live[0]]), ghost])
    # Hard repair: remap two live rows off their (nominally faulty)
    # slots; retires the slots, allocates spares, moves the rows.
    d.remap_rows([int(d.slot_of[i]) for i in live[1:3]])
    programs: List[Program] = []
    for op, instrs in d.programs[n_before:]:
        programs.append((f"faults/orders/{op}", d.rel, instrs, ()))
    return programs


def lint(sf: float = 0.002, strict: bool = False,
         verbose: bool = False, device: str = "cuda") -> int:
    t0 = time.perf_counter()
    db = PimDatabase(tpch.generate(sf=sf, seed=0), device=device)
    programs = (collect_programs(db) + collect_linked_programs(db)
                + collect_serve_programs(db) + collect_dml_programs(db)
                + collect_fault_programs(db))

    totals = {"error": 0, "warning": 0, "info": 0}
    n_checked = 0
    for label, rel, instrs, mask_outputs in programs:
        for backend in BACKENDS:
            ctx = build_context(rel, instrs, mask_outputs, backend=backend)
            diags = run_passes(ctx)
            n_checked += 1
            shown: List[Diagnostic] = []
            for d in diags:
                totals[d.severity] += 1
                if d.severity != "info" or verbose:
                    shown.append(d)
            for d in shown:
                print(f"{label} [{backend}] {d.format()}")

    dt = time.perf_counter() - t0
    print(f"repro_torch.analysis.lint: {len(programs)} programs x "
          f"{len(BACKENDS)} backends = {n_checked} checks in {dt:.2f}s "
          f"-- {totals['error']} errors, {totals['warning']} warnings, "
          f"{totals['info']} info")
    if totals["error"] or (strict and totals["warning"]):
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="Statically verify all TPC-H relation programs.")
    ap.add_argument("--sf", type=float, default=0.002,
                    help="TPC-H scale factor of the generated database "
                         "(default 0.002; program shape, not data, is "
                         "what is checked)")
    ap.add_argument("--strict", action="store_true",
                    help="fail on warnings too")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="also print info-severity diagnostics")
    ap.add_argument("--device", default="cuda",
                    help="device of the database and its DML writes "
                         "(default cuda; cpu runs the plain path)")
    a = ap.parse_args(argv)
    return lint(sf=a.sf, strict=a.strict, verbose=a.verbose,
                device=a.device)


if __name__ == "__main__":
    sys.exit(main())
