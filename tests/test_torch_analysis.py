"""Port: the PIM-IR static verifier (``repro_torch.analysis``).

The cases of ``tests/test_analysis.py`` on the port's modules: the mutation
suite (every seeded corruption class caught, with the right pass and
instruction index), the property test (valid compiler output produces no
errors), the audit regressions, the localized compile errors and the
trace-derived endurance profile. The reference's backends ``"trace"`` and
``"jnp"``/``"pallas"`` are the port's ``"eager"`` and ``"fused"``
(``passes.REFERENCE_BACKEND``).

Parity with the reference (jax only through ``pytest.importorskip``): the
lint sweep at sf 0.002, seed 0, gives the same 108 programs and, for each
label and each port backend, the same formatted diagnostics as the
reference under its mapped backend; ``build_context`` on Q1's lineitem
program gives ``baseline.json``'s ``analysis_verify`` counters (78
instructions, 4 diagnostics). ``compile_program`` raises
``ProgramVerificationError`` before any tape is recorded.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st
from repro_torch import analysis
from repro_torch.analysis import lint
from repro_torch.analysis import passes as P
from repro_torch.core import cost_model as cm
from repro_torch.core import engine as eng
from repro_torch.core import isa
from repro_torch.core import program as prog
from repro_torch.db import database, queries, tpch
from repro_torch.db.compiler import Agg, And, Cmp, Col, Compiler, Lit, Mul

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def rel():
    rng = np.random.default_rng(7)
    return eng.PimRelation.from_columns("t", {
        "a": rng.integers(1, 51, size=200),       # 6 bits
        "b": rng.integers(0, 11, size=200),       # 4 bits
        "c": rng.integers(0, 4096, size=200),     # 12 bits
    }, device="cpu")


def errors(diags):
    return [d for d in diags if d.severity == "error"]


def find(diags, pass_name, needle, severity=None):
    hits = [d for d in diags
            if d.pass_name == pass_name and needle in d.message
            and (severity is None or d.severity == severity)]
    assert hits, f"no {pass_name} diagnostic containing {needle!r} in:\n" + \
        analysis.format_diagnostics(diags)
    return hits[0]


# --------------------------------------------------------------------------
# Clean programs: verifier is quiet, compile path is wired
# --------------------------------------------------------------------------
def _filter_program(rel):
    c = Compiler(rel)
    m = c.compile_filter(And(Cmp("lt", Col("a"), Lit(24)),
                             Cmp("ge", Col("b"), Lit(3))))
    return c, m


def test_valid_program_has_no_errors(rel):
    c, m = _filter_program(rel)
    for backend in P.BACKENDS:
        diags = P.verify_program(rel, c.program, (m,), backend=backend)
        assert not errors(diags)


def _unsound_program():
    # The grouped-reduce deferral is unsound: the source attr 'a' is
    # shadowed between a member and the job's exec_at.
    return [
        isa.EqualImm(dest="m0", attr="a", imm=3, n_bits=6),
        isa.ReduceSum(dest="s0", attr="a", mask="m0", n_bits=6),
        isa.AddImm(dest="a", attr="b", imm=1, n_bits=5),
        isa.ReduceSum(dest="s1", attr="a", mask="m0", n_bits=6),
    ]


def test_compile_program_runs_verifier(rel):
    # Rejected at compile time, before any tape is recorded.
    n_cached = len(prog._FN_CACHE)
    with pytest.raises(analysis.ProgramVerificationError) as ei:
        prog.compile_program(rel, _unsound_program(), mask_outputs=("m0",))
    d = find(ei.value.diagnostics, "batches", "deferred popcount")
    assert d.instr_index == 1 and d.register == "a"
    assert len(prog._FN_CACHE) == n_cached


def test_compile_program_raises_before_any_tape_is_built(rel, monkeypatch):
    """The hook runs on the cache miss before ``_build_tape``: a corrupted
    program never reaches the recorder (nor, so, any launch)."""
    def no_tape(*args, **kwargs):
        raise AssertionError("a tape was built for an unsound program")
    monkeypatch.setattr(prog, "_build_tape", no_tape)
    with pytest.raises(analysis.ProgramVerificationError):
        prog.compile_program(rel, _unsound_program(), mask_outputs=("m0",))
    # A sound program on the same path does reach the recorder (a
    # program no other test compiles, so its tape is not cached).
    c = Compiler(rel)
    m = c.compile_filter(And(Cmp("lt", Col("a"), Lit(37)),
                             Cmp("ne", Col("b"), Lit(9))))
    with pytest.raises(AssertionError, match="tape was built"):
        prog.compile_program(rel, c.program, mask_outputs=(m,))


# --------------------------------------------------------------------------
# Mutation suite: seeded corruptions of valid programs
# --------------------------------------------------------------------------
def test_mutation_free_moved_earlier_is_use_after_free(rel):
    c, m = _filter_program(rel)
    ctx = P.build_context(rel, c.program, (m,), backend="fused")
    # Find a register freed at its last use and move the free to the
    # instruction right after its definition.
    target = next(r for i, fs in enumerate(ctx.frees) for r in fs)
    def_at = next(i for i, ins in enumerate(ctx.instrs)
                  if ins.dest == target)
    frees = [tuple(r for r in fs if r != target) for fs in ctx.frees]
    frees[def_at] = frees[def_at] + (target,)
    bad = dataclasses.replace(ctx, frees=tuple(frees))
    d = find(P.run_passes(bad), "defuse", "after its free", "error")
    assert d.register == target and d.instr_index > def_at


def test_mutation_double_free(rel):
    c, m = _filter_program(rel)
    ctx = P.build_context(rel, c.program, (m,), backend="fused")
    free_at, target = next((i, fs[0])
                           for i, fs in enumerate(ctx.frees) if fs)
    frees = list(ctx.frees)
    frees[-1] = frees[-1] + (target,)
    bad = dataclasses.replace(ctx, frees=tuple(frees))
    d = find(P.run_passes(bad), "defuse", "double free", "error")
    assert d.register == target
    assert f"first freed at instruction {free_at}" in d.message


def test_mutation_free_of_kept_output(rel):
    c, m = _filter_program(rel)
    ctx = P.build_context(rel, c.program, (m,), backend="fused")
    frees = list(ctx.frees)
    frees[-1] = frees[-1] + (m,)
    bad = dataclasses.replace(ctx, frees=tuple(frees))
    assert find(P.run_passes(bad), "defuse", "kept output",
                "error").register == m


def test_mutation_widened_imm_past_n_bits(rel):
    instrs = [isa.AddImm(dest="d0", attr="a", imm=1 << 9, n_bits=6),
              isa.GreaterThanImm(dest="m0", attr="d0", imm=1, n_bits=6),
              isa.BitwiseAnd(dest="m1", src_a="m0", src_b="__valid__")]
    diags = P.run_passes(P.build_context(rel, instrs, ("m1",)))
    d = find(diags, "kinds", "wider than n_bits", "warning")
    assert d.instr_index == 0 and d.instr_kind == "AddImm"
    find(diags, "kinds", "possible overflow", "warning")


def test_mutation_unrepresentable_comparison_imm(rel):
    instrs = [isa.EqualImm(dest="m0", attr="b", imm=4000, n_bits=4),
              isa.BitwiseAnd(dest="m1", src_a="m0", src_b="__valid__")]
    d = find(P.run_passes(P.build_context(rel, instrs, ("m1",))),
             "kinds", "unrepresentable", "warning")
    assert d.instr_index == 0


def test_mutation_batch_member_reads_member_dest(rel):
    instrs = (isa.AddImm(dest="d0", attr="a", imm=1, n_bits=7),
              isa.AddImm(dest="d1", attr="d0", imm=1, n_bits=8),
              isa.GreaterThanImm(dest="m0", attr="d1", imm=5, n_bits=8),
              isa.BitwiseAnd(dest="m1", src_a="m0", src_b="__valid__"))
    ctx = P.build_context(rel, instrs, ("m1",), backend="fused")
    assert ctx.arith.batches == ()       # the planner refuses this batch
    forged = dataclasses.replace(
        ctx, arith=dataclasses.replace(ctx.arith, batches=((0, 1),)))
    d = find(P.run_passes(forged), "batches", "another member", "error")
    assert d.instr_index == 1 and d.register == "d0"


def test_mutation_batch_member_reads_post_anchor_operand(rel):
    instrs = (isa.AddImm(dest="d0", attr="a", imm=1, n_bits=7),
              isa.EqualImm(dest="m0", attr="b", imm=2, n_bits=4),
              isa.AddImm(dest="d1", attr="m0", imm=1, n_bits=2),
              isa.BitwiseAnd(dest="m1", src_a="m0", src_b="__valid__"))
    ctx = P.build_context(rel, instrs, ("m1",), backend="fused")
    assert ctx.arith.batches == ()       # m0 postdates the would-be anchor
    forged = dataclasses.replace(
        ctx, arith=dataclasses.replace(ctx.arith, batches=((0, 2),)))
    d = find(P.run_passes(forged), "batches", "at/after the batch anchor",
             "error")
    assert d.instr_index == 2 and d.register == "m0"


def test_mutation_sum_job_deferred_past_mask_overwrite(rel):
    instrs = (isa.EqualImm(dest="m0", attr="a", imm=3, n_bits=6),
              isa.ReduceSum(dest="s0", attr="c", mask="m0", n_bits=12),
              isa.EqualImm(dest="m1", attr="b", imm=2, n_bits=4),
              isa.ReduceSum(dest="s1", attr="c", mask="m1", n_bits=12))
    ctx = P.build_context(rel, instrs, (), backend="fused")
    job = next(j for j in ctx.plan.sum_jobs if j.attr == "c")
    assert job.exec_at == 3              # legal deferral, verifier quiet
    assert not errors(P.run_passes(ctx))
    # Corrupt: instruction 2 now overwrites member 1's group mask, making
    # the program non-SSA — a grouped (multi-mask, deferred) plan forged
    # onto it is unsound and must be rejected.
    bad = (instrs[0], instrs[1],
           isa.EqualImm(dest="m0", attr="b", imm=2, n_bits=4),
           isa.ReduceSum(dest="s1", attr="c", mask="m0", n_bits=12))
    forged = dataclasses.replace(
        P.build_context(rel, bad, (), backend="fused"),
        plan=ctx.plan)                   # stale plan, still grouped
    d = find(P.run_passes(forged), "batches", "non-SSA", "error")
    assert d.instr_index == job.exec_at and d.register == "c"


def test_mutation_mask_logic_on_derived_operand(rel):
    instrs = [isa.AddImm(dest="d0", attr="a", imm=1, n_bits=7),
              isa.BitwiseAnd(dest="m0", src_a="d0", src_b="__valid__")]
    d = find(P.run_passes(P.build_context(rel, instrs, ("m0",))),
             "kinds", "mask-logic operand", "error")
    assert d.instr_index == 1 and d.register == "d0"


def test_mutation_materialize_mask_unpinned(rel):
    c = Compiler(rel)
    m = c.compile_filter(Cmp("lt", Col("a"), Lit(24)),
                         with_transform=False)
    c.compile_materialize(m, ("a", "b"))
    ctx = P.build_context(rel, c.program, (), backend="fused")
    assert not errors(P.run_passes(ctx))     # build_context pins it
    unpinned = dataclasses.replace(ctx, keep=frozenset())
    d = find(P.run_passes(unpinned), "defuse", "not pinned in keep",
             "error")
    assert d.register == m


def test_mutation_duplicate_dest_downgrades_plans(rel):
    instrs = (isa.EqualImm(dest="m0", attr="a", imm=3, n_bits=6),
              isa.EqualImm(dest="m0", attr="b", imm=2, n_bits=4),
              isa.BitwiseAnd(dest="m1", src_a="m0", src_b="__valid__"))
    ctx = P.build_context(rel, instrs, ("m1",), backend="fused")
    d = find(P.run_passes(ctx), "defuse", "duplicate dest", "warning")
    assert d.instr_index == 1 and d.register == "m0"
    assert not errors(P.run_passes(ctx))     # planners degrade soundly


def test_mutation_dead_register_warning(rel):
    instrs = (isa.EqualImm(dest="m0", attr="a", imm=3, n_bits=6),
              isa.EqualImm(dest="m9", attr="b", imm=2, n_bits=4),
              isa.BitwiseAnd(dest="m1", src_a="m0", src_b="__valid__"))
    d = find(P.run_passes(P.build_context(rel, instrs, ("m1",))),
             "defuse", "dead register", "warning")
    assert d.register == "m9"


# --------------------------------------------------------------------------
# Audit regressions: what the passes flagged in the real programs
# --------------------------------------------------------------------------
def test_plan_reduces_no_longer_frees_source_attrs(rel):
    """Regression: grouped-reduce liveness extension used to add SOURCE
    attributes to last_use, scheduling phantom frees of the relation's
    own planes (defuse flagged Q1/Q22)."""
    instrs = (isa.EqualImm(dest="m0", attr="a", imm=3, n_bits=6),
              isa.BitwiseAnd(dest="m1", src_a="m0", src_b="__valid__"),
              isa.ReduceSum(dest="s0", attr="c", mask="m1", n_bits=12),
              isa.ReduceSum(dest="s1", attr="c", mask="m0", n_bits=12))
    ctx = P.build_context(rel, instrs, (), backend="fused")
    assert "c" not in ctx.plan.last_use
    assert all("c" not in fs for fs in ctx.frees)
    assert not any(d.pass_name == "defuse" and "relation attribute"
                   in d.message for d in P.run_passes(ctx))


def test_all_query_programs_verify_clean():
    """Every TPC-H program the database emits passes all passes with zero
    errors and zero defuse/kinds/batches warnings on every backend
    (endurance hotspot warnings are legitimate findings, not defects)."""
    db = database.PimDatabase(tpch.generate(sf=0.002, seed=123),
                              device="cpu")
    for label, r, instrs, mask_outputs in lint.collect_programs(db):
        for backend in P.BACKENDS:
            diags = P.run_passes(
                P.build_context(r, instrs, mask_outputs, backend=backend))
            bad = [d for d in diags if d.severity != "info"
                   and d.pass_name != "endurance"]
            assert not bad, f"{label} [{backend}]:\n" + \
                analysis.format_diagnostics(bad)


# --------------------------------------------------------------------------
# Localized compile errors
# --------------------------------------------------------------------------
def test_analyze_program_error_names_instruction(rel):
    instrs = [isa.EqualImm(dest="m0", attr="a", imm=3, n_bits=6),
              isa.BitwiseAnd(dest="m1", src_a="nope", src_b="m0")]
    with pytest.raises(ValueError) as ei:       # PVE is a ValueError
        prog.analyze_program(instrs, rel)
    assert isinstance(ei.value, analysis.ProgramVerificationError)
    (d,) = ei.value.diagnostics
    assert (d.instr_index, d.instr_kind, d.register) == \
        (1, "BitwiseAnd", "nope")


def test_classify_program_error_names_instruction():
    trace = [isa.SetReset(dest="m", value=1),
             isa.ColumnTransform(dest="t", mask="m"),
             isa.Materialize(dest="v", attrs=("a",), mask="m", n_bits=6)]

    @dataclasses.dataclass(frozen=True)
    class Bogus(isa.PimInstruction):
        def cycles(self):
            return 1

        def intermediate_cells(self):
            return 0

    with pytest.raises(ValueError) as ei:
        cm.classify_program(trace + [Bogus(dest="x")])
    (d,) = ei.value.diagnostics
    assert (d.instr_index, d.instr_kind, d.register) == (3, "Bogus", "x")


def test_classify_lowering_error_names_step():
    with pytest.raises(ValueError) as ei:
        cm.classify_lowering([("csa_compress", 4), ("warp_drive", 1)])
    (d,) = ei.value.diagnostics
    assert d.instr_index == 1 and d.instr_kind == "warp_drive"


# --------------------------------------------------------------------------
# Endurance / write pressure
# --------------------------------------------------------------------------
def test_write_profile_tracks_aggregate_formula():
    """The per-instruction row_write_ops sums must stay within 1% of the
    §6.4 class-aggregate approximation on a real query trace."""
    db = database.PimDatabase(tpch.generate(sf=0.002, seed=123),
                              device="cpu")
    run = db.execute(queries.get_query("Q1").filter_only(), engine="eager")
    trace = run.relations["lineitem"].trace
    profile = analysis.write_profile(trace)
    cost = cm.classify_program(trace)
    approx = (cost.cycles_filter + cost.cycles_arith +
              cost.cycles_reduce_col + cost.cycles_reduce_row // 100 +
              cost.cycles_col_transform // 1024)
    assert profile.busiest_row_ops == pytest.approx(approx, rel=0.01)
    # And the override reaches the endurance model:
    full = cm.endurance_ops_per_cell(cost, exec_time_s=1.0)
    traced = cm.endurance_ops_per_cell(
        cost, exec_time_s=1.0, busiest_row_ops=profile.busiest_row_ops)
    assert traced == pytest.approx(full, rel=0.01)
    rep = database.cost_report(run)
    assert rep.endurance_ops_per_cell_10y > 0


def test_endurance_pass_reports_hotspots(rel):
    instrs = (isa.EqualImm(dest="m0", attr="c", imm=3, n_bits=12),
              isa.Multiply(dest="d0", attr_a="c", imm=999_999, n_bits=22,
                           m_bits=20),
              isa.ReduceSum(dest="s0", attr="c", mask="m0", n_bits=12),
              isa.BitwiseAnd(dest="m1", src_a="m0", src_b="__valid__"))
    diags = P.run_passes(P.build_context(rel, instrs, ("m1",)),
                         names=("endurance",))
    find(diags, "endurance", "trace write pressure", "info")
    d = find(diags, "endurance", "absorbs", "warning")
    assert d.register == "d0"            # the multiply accumulator


# --------------------------------------------------------------------------
# Property test: the compiler only emits verifiable programs
# --------------------------------------------------------------------------
@settings(max_examples=12, deadline=None)
@given(st.integers(1, 50), st.integers(0, 10),
       st.sampled_from(["lt", "le", "gt", "ge", "eq", "ne"]),
       st.booleans(), st.booleans())
def test_random_compiler_programs_have_no_errors(a_imm, b_imm, op,
                                                 with_agg, with_mat):
    # The shim's @given hides the signature from pytest, so no fixtures:
    # build the relation inline (cheap at this size).
    rng = np.random.default_rng(11)
    rel = eng.PimRelation.from_columns("p", {
        "a": rng.integers(1, 51, size=96),
        "b": rng.integers(0, 11, size=96),
        "c": rng.integers(0, 4096, size=96)}, device="cpu")
    c = Compiler(rel)
    pred = And(Cmp(op, Col("a"), Lit(a_imm)),
               Cmp("ge", Col("b"), Lit(b_imm)))
    m = c.compile_filter(pred, with_transform=not (with_agg or with_mat))
    if with_agg:
        c.compile_aggregates(m, (Agg("sum", Mul(Col("a"), Col("b")), "s"),
                                 Agg("count", None, "n"),
                                 Agg("min", Col("c"), "lo")))
    if with_mat:
        c.compile_materialize(m, ("a", "c"))
    for backend in P.BACKENDS:
        diags = P.run_passes(
            P.build_context(rel, c.program, (m,), backend=backend))
        assert not errors(diags), analysis.format_diagnostics(errors(diags))


# --------------------------------------------------------------------------
# Parity with the reference verifier
# --------------------------------------------------------------------------
def _lint_programs(lint_mod, db):
    return (lint_mod.collect_programs(db)
            + lint_mod.collect_linked_programs(db)
            + lint_mod.collect_serve_programs(db)
            + lint_mod.collect_dml_programs(db)
            + lint_mod.collect_fault_programs(db))


def test_lint_sweep_diagnostics_equal_reference():
    """All 108 programs of the lint sweep (sf 0.002, seed 0): the same
    labels and instructions as the reference's sweep, and for each label
    and port backend the same formatted diagnostics as the reference
    gives under the mapped backend."""
    pytest.importorskip("jax")
    from repro.analysis import lint as rlint
    from repro.analysis import passes as RP
    from repro.db import database as rdb
    tables = tpch.generate(sf=0.002, seed=0)
    ours = _lint_programs(lint, database.PimDatabase(tables, device="cpu"))
    theirs = _lint_programs(rlint, rdb.PimDatabase(tables))
    assert len(ours) == len(theirs) == 108
    assert set(P.REFERENCE_BACKEND.values()) <= set(RP.BACKENDS)
    for (label, rel_, instrs, outs), (rlabel, rrel, rinstrs, routs) in zip(
            ours, theirs):
        assert label == rlabel
        assert [repr(i) for i in instrs] == [repr(i) for i in rinstrs]
        assert tuple(outs) == tuple(routs)
        for backend in P.BACKENDS:
            got = P.run_passes(P.build_context(rel_, instrs, outs,
                                               backend=backend))
            want = RP.run_passes(RP.build_context(
                rrel, rinstrs, routs,
                backend=P.REFERENCE_BACKEND[backend]))
            assert [d.format() for d in got] == \
                [d.format() for d in want], (label, backend)


def test_q1_verify_matches_baseline_counters():
    """``baseline.json``'s ``analysis_verify`` (sf 0.005, taken under the
    reference's ``"jnp"``): 78 instructions, 4 diagnostics. Q1 has no
    Materialize, so the Pallas rules the fused backend shares give the
    same."""
    base = json.loads((ROOT / "benchmarks/baseline.json").read_text())
    meta = base["rows"]["analysis_verify"]["meta"]
    db = database.PimDatabase(tpch.generate(sf=0.005, seed=0), device="cpu")
    spec = queries.get_query("Q1")
    rel_ = db.relations["lineitem"]
    c, mask_reg, _ = db._compile_relation(rel_, spec,
                                          spec.filters["lineitem"])
    diags = P.run_passes(P.build_context(rel_, tuple(c.program),
                                         (mask_reg,), backend="fused"))
    assert (len(c.program), len(diags)) == \
        (meta["n_instrs"], meta["n_diags"]) == (78, 4)


def test_lint_cli_on_cpu(capsys):
    """``python -m repro_torch.analysis.lint --device cpu``: exit 0, 108
    programs on both backends, 0 errors."""
    assert lint.main(["--device", "cpu"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("repro_torch.analysis.lint: 108 programs x 2 "
                           "backends = 216 checks")
    assert "-- 0 errors," in last


@pytest.mark.cuda
def test_lint_and_verify_compile_on_card():
    """The lint sweep with its database and DML writes on the card: exit 0
    with 0 errors; the DML write programs ran on CUDA planes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "false")
    assert lint.lint(device="cuda") == 0
    db = database.PimDatabase(tpch.generate(sf=0.002, seed=0))
    assert len(_lint_programs(lint, db)) == 108
    d = db.dml_state("lineitem")
    assert d.rel.valid.is_cuda
    assert all(p.is_cuda for p in d.rel.planes.values())
