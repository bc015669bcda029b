"""Port: the fused-program lowering and its kernel module.

* ``fused_program_torch`` (the kernel's plain version) equals the
  reference Pallas kernel ``repro.kernels.program.fused_program`` in
  interpret mode — masks, popcount totals and combined MIN/MAX, exactly.
* An executor written here, with the CUDA kernel's memory model
  (persistent blocks looping over tiles, each tile's rows staged with
  zeros past W, K words per thread, a fixed slot array per block written
  in place, int32 accumulators per block, one MIN/MAX row per tile), runs
  every recorded tape and equals the plain version: this checks the tape
  itself (folding, dead-entry removal, scheduling, slot reuse).
* The schedule keeps Q6 within 32 slots and Q1 within 192; packed
  entries round-trip and overflowing fields raise.
* The planner counters equal the reference's.
* The wrapper never falls back: a CUDA tensor without a kernel raises.
* On a card, the kernel equals the plain version (``cuda`` marker).
"""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import engine as te
from repro_torch.core import program as tprog
from repro_torch.db import database as tdb
from repro_torch.db import queries as tq
from repro_torch.db import tpch as ttpch
from repro_torch.kernels import program as kp

SF, SEED = 0.002, 123
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def tables():
    return ttpch.generate(sf=SF, seed=SEED)


@pytest.fixture(scope="module")
def tdb_cpu(tables):
    return tdb.PimDatabase(tables, device="cpu")


def _minmax_specs(Q=tq, C=None):
    """The hand-built MIN/MAX programs: over a derived expression, and
    over an empty selection (found flag -> None). ``Q``/``C``: the
    queries and compiler modules whose AST classes to build them from."""
    if C is None:
        from repro_torch.db import compiler as C
    return [
        Q.QuerySpec(
            "Qmm_expr", "full",
            filters={"lineitem": C.Cmp("lt", C.Col("l_quantity"),
                                       C.Lit(10))},
            agg_relation="lineitem",
            aggregates=[C.Agg("max", C.Mul(C.Col("l_extendedprice"),
                                           C.RSubImm(100,
                                                     C.Col("l_discount"))),
                              "mx"),
                        C.Agg("min", C.Col("l_quantity"), "mn")]),
        Q.QuerySpec(
            "Qmm_empty", "full",
            filters={"customer": C.Cmp("gt", C.Col("c_acctbal"),
                                       C.Lit(1 << 40))},
            agg_relation="customer",
            aggregates=[C.Agg("min", C.Col("c_acctbal"), "mn"),
                        C.Agg("max", C.Col("c_acctbal"), "mx"),
                        C.Agg("sum", C.Col("c_acctbal"), "s"),
                        C.Agg("count", None, "c")])]


def _spec(name, Q=tq, C=None):
    return {s.name: s for s in _minmax_specs(Q, C)}.get(name) or \
        Q.get_query(name)


def _compiled(db, spec):
    """(relation, CompiledProgram) for every relation program of a spec."""
    out = []
    for rel_name, pred in spec.filters.items():
        rel = db.relations[rel_name]
        c, mask_reg, _ = db._compile_relation(rel, spec, pred)
        out.append((rel, tprog.compile_program(rel, c.program,
                                               mask_outputs=(mask_reg,))))
    return out


def _multi_tile():
    """100,000 records: 4096 words, several blocks and Pallas tiles."""
    rng = np.random.default_rng(7)
    n = 100_000
    return {"k": rng.integers(0, 1 << 12, n), "v": rng.integers(0, 1 << 9, n)}


def _multi_tile_program(rel, C=None):
    """SUM/COUNT/MAX where 500 <= k <= 3000, built with compiler module
    ``C`` (the port's by default)."""
    if C is None:
        from repro_torch.db import compiler as C
    c = C.Compiler(rel)
    m = c.compile_filter(C.Between(C.Col("k"), 500, 3000),
                         with_transform=False)
    c.compile_aggregates(m, [C.Agg("sum", C.Col("v"), "s"),
                             C.Agg("count", None, "c"),
                             C.Agg("max", C.Col("v"), "mx")])
    return c.program, (m,)


# --------------------------------------------------------------------------
# Plain version vs the reference Pallas kernel (interpret mode)
# --------------------------------------------------------------------------
def _reference_kernel(rrel, instrs, mask_outputs):
    import jax.numpy as jnp
    from repro.core import program as rprog
    from repro.core.distributed import combine_minmax_candidates
    from repro.kernels import program as rk
    cp = rprog.compile_program(rrel, instrs, mask_outputs=mask_outputs,
                               backend="pallas", interpret=True)
    attr_rows, rows, r0 = {}, [], 0
    for a in cp.analysis.source_attrs:
        p = rrel.planes[a]
        attr_rows[a] = (r0, r0 + p.shape[0])
        rows.append(p)
        r0 += p.shape[0]
    stacked = jnp.concatenate(rows + [rrel.valid[None]], axis=0)
    frees = rprog.frees_by_instr(len(cp.instrs), cp.plan.last_use,
                                 frozenset(mask_outputs))
    masks, pc, mm = rk.fused_program(
        stacked, instrs=cp.instrs, attr_rows=attr_rows, valid_row=r0,
        mask_outputs=mask_outputs, sum_jobs=cp.plan.sum_jobs,
        mm_jobs=cp.plan.mm_jobs, frees=frees,
        arith_batches=cp.arith.batches, n_pc_cols=cp.plan.n_pc_cols,
        n_mm_cols=cp.plan.n_mm_cols, interpret=True)
    minmax = {}
    for mj in cp.plan.mm_jobs:
        bits, found = combine_minmax_candidates(
            mm[:, mj.col_start:mj.col_start + mj.width],
            mm[:, mj.col_start + mj.width] != 0, mj.is_max)
        minmax[mj.dest] = (np.asarray(bits).tolist(), bool(found))
    return (np.asarray(masks)[:len(mask_outputs)],
            np.asarray(pc)[0, :cp.plan.n_pc_cols], minmax)


def _port_plain(trel, cp):
    masks, pc, mm = kp.fused_program_torch(tprog.stack_sources(cp, trel),
                                           cp.tape)
    minmax = {}
    for mj in cp.plan.mm_jobs:
        bits, found = tprog.combine_minmax_candidates(
            mm[:, mj.col_start:mj.col_start + mj.width],
            mm[:, mj.col_start + mj.width] != 0, mj.is_max)
        minmax[mj.dest] = (bits.tolist(), bool(found))
    return te.to_words(masks), pc.numpy(), minmax


def _assert_plain_matches_reference(trel, tinstrs, rrel, rinstrs, outs):
    cp = tprog.compile_program(trel, tinstrs, mask_outputs=outs)
    t_masks, t_pc, t_mm = _port_plain(trel, cp)
    r_masks, r_pc, r_mm = _reference_kernel(rrel, tuple(rinstrs), outs)
    np.testing.assert_array_equal(t_masks, r_masks)
    np.testing.assert_array_equal(t_pc, r_pc)
    assert t_mm == r_mm
    return t_mm


@pytest.mark.parametrize("qname", ["Q6", "Q22_sub", "Qmm_expr",
                                   "Qmm_empty"])
def test_plain_matches_reference_pallas_kernel(tables, tdb_cpu, qname):
    pytest.importorskip("jax")
    from repro.db import compiler as rc_mod, database as rdb, queries as rq
    rdb_ = rdb.PimDatabase(tables)
    spec, rspec = _spec(qname), _spec(qname, rq, rc_mod)
    for rel_name, pred in spec.filters.items():
        tc, tmask, _ = tdb_cpu._compile_relation(
            tdb_cpu.relations[rel_name], spec, pred)
        rc, rmask, _ = rdb_._compile_relation(
            rdb_.relations[rel_name], rspec, rspec.filters[rel_name])
        mm = _assert_plain_matches_reference(
            tdb_cpu.relations[rel_name], tc.program,
            rdb_.relations[rel_name], rc.program, (tmask,))
        if qname == "Qmm_empty":
            assert mm and all(found is False for _, found in mm.values())
        if qname == "Qmm_expr":
            assert mm and all(found for _, found in mm.values())


def test_plain_matches_reference_multi_tile():
    pytest.importorskip("jax")
    from repro.core import engine as reng
    from repro.db import compiler as rc_mod
    cols = _multi_tile()
    trel = te.PimRelation.from_columns("t", cols, device="cpu")
    rrel = reng.PimRelation.from_columns("t", cols)
    assert trel.layout.n_words == 4096
    tinstrs, outs = _multi_tile_program(trel)
    rinstrs, _ = _multi_tile_program(rrel, rc_mod)
    cp = tprog.compile_program(trel, tinstrs, mask_outputs=outs)
    assert -(-trel.layout.n_words // cp.tape.tile) > 1      # several tiles
    _assert_plain_matches_reference(trel, tinstrs, rrel, rinstrs, outs)


def test_multi_tile_program_end_to_end():
    """run_program over several blocks: masks land in the right words,
    per-block popcounts and MIN/MAX candidates combine exactly."""
    cols = _multi_tile()
    rel = te.PimRelation.from_columns("t", cols, device="cpu")
    instrs, (m,) = _multi_tile_program(rel)
    cp = tprog.compile_program(rel, instrs, mask_outputs=(m,))
    res = tprog.run_program(cp, rel)
    sel = (cols["k"] >= 500) & (cols["k"] <= 3000)
    np.testing.assert_array_equal(res.mask(m), sel)
    scalars = {ins.dest: res.scalar(ins.dest) for ins in instrs
               if ins.kind in ("ReduceSum", "ReduceMinMax")}
    assert sorted(scalars.values()) == sorted(
        [int(cols["v"][sel].sum()), int(sel.sum()),
         int(cols["v"][sel].max())])


# --------------------------------------------------------------------------
# The tape under the kernel's memory model
# --------------------------------------------------------------------------
def run_tape_like_kernel(stacked: np.ndarray, tape: kp.Tape, grid: int):
    """Execute a tape the way ``csrc/fused_program.cu`` does: ``grid``
    persistent blocks of ``tape.launch.threads`` threads, block ``i``
    running tiles ``i, i + grid, ...``; each tile's rows staged, words
    past W zero; thread ``t`` on its own ``k`` consecutive words; the
    slots a fixed ``[slot][thread][k]`` array per block, written in place
    and poisoned at the start (a read before a write in a tile would
    show); int32 popcount accumulators per block, added to the int64
    totals at the end; one MIN/MAX row per tile."""
    lc = tape.launch
    rows, w = stacked.shape
    t, k, tile, n_rows = lc.threads, lc.k, lc.tile, tape.n_rows
    n_tiles = -(-w // tile)
    src = np.zeros((rows, n_tiles * tile), np.uint32)
    src[:, :w] = stacked
    masks = np.zeros((tape.n_masks, w), np.uint32)
    pc = np.zeros(tape.n_pc, np.int64)
    mm = np.zeros((n_tiles, tape.n_mm), np.int32)
    for block in range(grid):
        S = np.full((tape.n_slots, t, k), 0xDEADBEEF, np.uint32)
        acc = np.zeros(tape.n_pc, np.int64)
        for ti in range(block, n_tiles, grid):
            staged = src[:, ti * tile:(ti + 1) * tile].reshape(n_rows, t, k)
            words = ti * tile + np.arange(tile).reshape(t, k)
            inb = words < w

            def get(v):
                return staged[v] if v < n_rows else S[v - n_rows]

            for op, d, a, b, c in tape.ops.tolist():
                assert op in (kp.STORE, kp.POPC, kp.ANY) or d >= n_rows, \
                    "an entry writes a staged row"
                if op == kp.STORE:
                    masks[c, words[inb]] = get(a)[inb]
                elif op == kp.CONST0:
                    S[d - n_rows] = 0
                elif op == kp.CONST1:
                    S[d - n_rows] = 0xFFFFFFFF
                elif op == kp.NOT:
                    S[d - n_rows] = ~get(a)
                elif op == kp.AND:
                    S[d - n_rows] = get(a) & get(b)
                elif op == kp.OR:
                    S[d - n_rows] = get(a) | get(b)
                elif op == kp.XOR:
                    S[d - n_rows] = get(a) ^ get(b)
                elif op == kp.POPC:
                    acc[c] += int(np.bitwise_count(get(a) & get(b))[inb].sum())
                    assert acc[c] < 2**31
                elif op in (kp.MAXSTEP, kp.MINSTEP):
                    cand = get(a).copy()
                    x = cand & (get(b) if op == kp.MAXSTEP else ~get(b))
                    x[~inb] = 0
                    has = bool(x.any())
                    S[d - n_rows] = x if has else cand
                    mm[ti, c] = has if op == kp.MAXSTEP else not has
                elif op == kp.ANY:
                    mm[ti, c] = bool((get(a)[inb] != 0).any())
                else:
                    raise AssertionError(f"unknown opcode {op}")
        pc += acc
    return masks, pc, mm


def _assert_tape_matches_plain(stacked: torch.Tensor, tape: kp.Tape,
                               grid: int = 2):
    want = run_tape_like_kernel(te.to_words(stacked), tape, grid)
    got = kp.fused_program_torch(stacked, tape)
    np.testing.assert_array_equal(te.to_words(got[0]), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[2].numpy(), want[2])


@pytest.mark.parametrize("qname", [q.name for q in tq.all_queries()])
def test_tape_executor_matches_plain(tdb_cpu, qname):
    for rel, cp in _compiled(tdb_cpu, tq.get_query(qname)):
        tape = cp.tape
        assert tape.n_rows == cp.source_plane_reads + 1
        assert 0 < tape.n_slots <= len(tape)
        assert (tape.ops[:, 0] == kp.STORE).sum() == tape.n_masks == 1
        _assert_tape_matches_plain(tprog.stack_sources(cp, rel), tape)


def test_tape_tail_words_are_guarded(tdb_cpu):
    """A word count that no block size divides: the tail block's missing
    words must reach no mask, popcount or MIN/MAX output."""
    rel, cp = _compiled(tdb_cpu, _spec("Qmm_expr"))[0]
    stacked = tprog.stack_sources(cp, rel)[:, :1000].contiguous()
    assert 1000 % cp.tape.tile
    _assert_tape_matches_plain(stacked, cp.tape)


def test_tape_folds_constants_and_reuses_slots(tdb_cpu):
    """Q1's tape: immediates never reach the tape (no CONST entries), the
    slot count stays far below the entry count, and the source planes
    are operands of their own (staged once per tile): no entry writes
    one, and every one is read."""
    rel, cp = _compiled(tdb_cpu, tq.get_query("Q1"))[0]
    ops = cp.tape.ops
    assert not np.isin(ops[:, 0], (kp.CONST0, kp.CONST1)).any()
    writes = ~np.isin(ops[:, 0], (kp.STORE, kp.POPC, kp.ANY))
    assert (ops[writes, 1] >= cp.tape.n_rows).all()
    read = set(ops[:, 2].tolist()) | set(ops[np.isin(
        ops[:, 0], (kp.AND, kp.OR, kp.XOR, kp.POPC, kp.MAXSTEP,
                    kp.MINSTEP)), 3].tolist())
    assert set(range(cp.tape.n_rows)) <= read
    assert cp.tape.n_slots < len(cp.tape) // 5
    assert (ops[:, 0] == kp.POPC).sum() <= cp.plan.n_pc_cols


@pytest.mark.parametrize("sf", [SF, 0.01])
def test_schedule_bounds_slots(sf, tdb_cpu):
    """The depth-first schedule: Q6 within 32 slots and Q1 within 192 (at
    SF 0.01 the tapes have SF 1's shapes; at a smaller SF widths can only
    shrink), each below the slots of the recorded order."""
    db = tdb_cpu if sf == SF else tdb.PimDatabase(
        ttpch.generate(sf=sf, seed=SEED), device="cpu")
    for qname, most in (("Q6", 32), ("Q1", 192)):
        (_, cp), = _compiled(db, tq.get_query(qname))
        assert cp.tape.n_slots <= most < cp.tape.slots_recorded, qname


def test_schedule_is_a_topological_order_of_the_same_entries(tdb_cpu,
                                                            monkeypatch):
    """Scheduling only re-orders: the recorded and the scheduled tape have
    the same entries (up to slot names) and give the same outputs."""
    rel, cp = _compiled(tdb_cpu, tq.get_query("Q1"))[0]
    monkeypatch.setattr(kp, "_schedule",
                        lambda ops, b_first: list(range(len(ops))))
    recorded = tprog._build_tape(cp.instrs, cp.kernel_masks,
                                 cp.kernel_attrs, cp.source_plane_counts,
                                 cp.plan, cp.arith)
    assert recorded.n_slots == cp.tape.slots_recorded > cp.tape.n_slots
    assert sorted(map(tuple, cp.tape.ops[:, [0, 4]].tolist())) == sorted(
        map(tuple, recorded.ops[:, [0, 4]].tolist()))
    stacked = tprog.stack_sources(cp, rel)
    same_tiles = dataclasses.replace(recorded, launch=cp.tape.launch)
    for got, want in zip(kp.fused_program_torch(stacked, cp.tape),
                         kp.fused_program_torch(stacked, same_tiles)):
        assert torch.equal(got, want)


def test_packed_entries_round_trip_and_overflow_raises(tdb_cpu):
    rng = np.random.default_rng(SEED)
    ops = np.stack([rng.integers(0, 1 << bits, 1000)
                    for _, _, bits in kp._FIELDS], axis=1)
    ops[0] = [(1 << bits) - 1 for _, _, bits in kp._FIELDS]
    code = kp.pack_entries(ops)
    assert code.dtype == np.uint64
    np.testing.assert_array_equal(kp.unpack_entries(code), ops)
    for _, cp in _compiled(tdb_cpu, tq.get_query("Q1")):
        tape = cp.tape
        want = tape.ops.copy()
        want[want[:, 0] == kp.NOT, 3] = want[want[:, 0] == kp.NOT, 2]
        want[:, 1:4] *= tape.tile // 4         # byte offsets / 16
        np.testing.assert_array_equal(kp.unpack_entries(tape.code), want)
    for j, (name, _, bits) in enumerate(kp._FIELDS):
        for bad in (1 << bits, -1):
            wide = ops[:3].copy()
            wide[1, j] = bad
            with pytest.raises(ValueError, match=f"field {name}"):
                kp.pack_entries(wide)


def test_recorder_raises_when_a_tape_outgrows_its_fields():
    """A popcount column past 14 bits does not fit its field: the
    recorder refuses the tape."""
    rec = kp.TapeRecorder()
    rec.popcount(rec.row(0), rec.row(1), 1 << 14)
    with pytest.raises(ValueError, match="tape field c"):
        rec.finish(n_rows=2, n_masks=0, n_pc=(1 << 14) + 1, n_mm=0)


@pytest.mark.parametrize("qname", ["Q1", "Q6", "Q15", "Qmm_expr",
                                   "Qmm_empty"])
@pytest.mark.parametrize("k", [None, 1])
def test_tape_executor_matches_plain_over_many_tiles(tdb_cpu, qname, k):
    """Random words, W a multiple of neither 4 nor the tile, several tiles
    per block (two blocks), with the tape's own K and with K = 1: the
    kernel's memory model equals the plain version."""
    rel, cp = _compiled(tdb_cpu, _spec(qname))[0]
    tape = cp.tape if k is None else cp.tape.with_words_per_thread(k)
    w = 5 * tape.tile + 7
    rng = np.random.default_rng(SEED)
    stacked = torch.from_numpy(rng.integers(
        -(1 << 31), 1 << 31, (tape.n_rows, w), dtype=np.int64
    ).astype(np.int32))
    assert w % 4 and -(-w // tape.tile) >= 2 * 2
    _assert_tape_matches_plain(stacked, tape, grid=2)


# --------------------------------------------------------------------------
# Planner counters
# --------------------------------------------------------------------------
def test_counters_match_reference():
    pytest.importorskip("jax")
    from repro.core import program as rprog
    from repro.db import database as rdb, queries as rq
    tables = ttpch.generate(sf=0.005, seed=SEED)
    tdb_ = tdb.PimDatabase(tables, device="cpu")
    rdb_ = rdb.PimDatabase(tables)
    want = {"Q6": {"peak_live_planes": 29, "total_reg_planes": 38,
                   "paper_cycles": 68609},
            "Q1": {"agg_plane_reads": 110, "agg_plane_reads_ungrouped": 678,
                   "n_reduce_jobs": 11, "arith_depth_csa": 85,
                   "arith_depth_ripple": 474}}
    for qname, counters in want.items():
        spec = tq.get_query(qname)
        (rel, cp), = _compiled(tdb_, spec)
        rrel = rdb_.relations[rel.name]
        rspec = rq.get_query(qname)
        rc, rmask, _ = rdb_._compile_relation(rrel, rspec,
                                              rspec.filters[rel.name])
        rcp = rprog.compile_program(rrel, rc.program, mask_outputs=(rmask,))
        for name, value in counters.items():
            got = getattr(cp, name)
            got = got() if callable(got) else got
            ref = getattr(rcp, name)
            ref = ref() if callable(ref) else ref
            assert got == ref == value, (qname, name, got, ref)
        assert cp.n_dispatches == 1
        assert cp.source_plane_reads == rcp.source_plane_reads
        assert [(j.attr, j.masks, j.width, j.exec_at, j.col_start)
                for j in cp.plan.sum_jobs] == \
            [(j.attr, j.masks, j.width, j.exec_at, j.col_start)
             for j in rcp.plan.sum_jobs]
        assert cp.arith.batches == rcp.arith.batches


# --------------------------------------------------------------------------
# The tape cache and the capacity limits
# --------------------------------------------------------------------------
def _lru_compiler(C, prog_mod, rel):
    """``compile_for(imm)``: compile ``a < imm`` on ``rel`` with the
    compiler module ``C`` and the program module ``prog_mod``; returns the
    compiled program and its mask register."""
    def compile_for(imm):
        c = C.Compiler(rel)
        m = c.compile_filter(C.Cmp("lt", C.Col("a"), C.Lit(imm)),
                             with_transform=False)
        return prog_mod.compile_program(rel, c.program,
                                        mask_outputs=(m,)), m
    return compile_for


def test_fn_cache_lru_eviction(monkeypatch):
    """The reference's test, on the port's tape cache: filling it past
    capacity evicts the least-recently-used tape, a hit rebuilds nothing,
    an evicted signature is rebuilt and still exact, and shrinking the
    capacity evicts at once."""
    from repro_torch.db import compiler as tc
    small = tprog.LruFnCache(capacity=2)
    monkeypatch.setattr(tprog, "_FN_CACHE", small)
    rng = np.random.default_rng(3)
    cols = {"a": rng.integers(0, 1 << 8, 2000)}
    rel = te.PimRelation.from_columns("lru_t", cols, device="cpu")
    compile_for = _lru_compiler(tc, tprog, rel)

    compile_for(10)
    compile_for(20)
    assert len(small) == 2 and small.evictions == 0
    compile_for(30)                      # pushes imm=10 out
    assert len(small) == 2 and small.evictions == 1
    misses = small.misses
    compile_for(30)                      # LRU hit: no rebuild
    assert small.misses == misses and small.hits >= 1
    cp1, m1 = compile_for(10)            # evicted sig: rebuilt, still exact
    assert small.evictions >= 2
    res = tprog.run_program(cp1, rel)
    np.testing.assert_array_equal(res.mask(m1), cols["a"] < 10)
    small.set_capacity(1)                # shrinking evicts immediately
    assert len(small) == 1
    with pytest.raises(ValueError):
        small.set_capacity(0)
    small.clear()
    assert len(small) == 0 and tprog.program_cache_stats()["size"] == 0


def test_program_cache_stats_match_reference(monkeypatch):
    """The same compiles through both packages' caches (capacity 2 via
    ``set_program_cache_capacity``) give the same ``program_cache_stats``:
    the same keys, hits, misses, evictions, size and capacity."""
    pytest.importorskip("jax")
    from repro.core import engine as reng
    from repro.core import program as rprog
    from repro.db import compiler as rc
    from repro_torch.db import compiler as tc
    rng = np.random.default_rng(4)
    cols = {"a": rng.integers(0, 1 << 8, 3000)}
    stats = []
    for prog_mod, C, rel in (
            (tprog, tc, te.PimRelation.from_columns("lru_s", cols,
                                                    device="cpu")),
            (rprog, rc, reng.PimRelation.from_columns("lru_s", cols))):
        monkeypatch.setattr(prog_mod, "_FN_CACHE", prog_mod.LruFnCache(8))
        prog_mod.set_program_cache_capacity(2)
        compile_for = _lru_compiler(C, prog_mod, rel)
        for imm in (10, 20, 10, 30, 20, 20, 10):
            compile_for(imm)
        stats.append(prog_mod.program_cache_stats())
    assert stats[0] == stats[1]
    assert stats[0] == {"hits": 2, "misses": 5, "evictions": 3, "size": 2,
                        "capacity": 2}


def test_cache_capacity_is_read_from_the_environment():
    """The reference's setting: ``REPRO_PROGRAM_CACHE_CAPACITY`` sizes the
    module's cache when it is imported (default 128, as here, where the
    test environment leaves it unset)."""
    import os
    import subprocess
    import sys
    if "REPRO_PROGRAM_CACHE_CAPACITY" not in os.environ:
        assert tprog._FN_CACHE.capacity == 128
    code = ("from repro_torch.core import program as p; "
            "print(p.program_cache_stats()['capacity'])")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_PROGRAM_CACHE_CAPACITY="7")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "7"


def test_pack_entries_limit_message():
    """A field value of ``1 << bits`` is refused with the field's name,
    its range and the values found."""
    for name, _, bits in kp._FIELDS:
        ops = np.zeros((3, 5), np.int64)
        ops[1, [n for n, _, _ in kp._FIELDS].index(name)] = 1 << bits
        with pytest.raises(ValueError, match=(
                rf"^tape field {name} out of range \[0, {1 << bits}\): "
                rf"0\.\.{1 << bits}$")):
            kp.pack_entries(ops)


def test_plan_launch_limit_message():
    """A tape whose planes do not fit one block's shared memory even at
    one warp and one word per thread is refused, naming the planes, the
    accumulators and the 227 KB limit; one plane fewer than that fits."""
    from repro_torch.kernels import common as kc
    fit = (kc.SMEM_BYTES // 4 - 5) // 32       # planes of a 32-word tile
    assert kc.plan_launch(fit, 5).tile == 32
    with pytest.raises(ValueError, match=(
            rf"^{fit + 1} planes x 32 words \+ 5 accumulators exceed "
            rf"{kc.SMEM_BYTES} bytes of shared memory$")):
        kc.plan_launch(fit + 1, 5)


# --------------------------------------------------------------------------
# No fallback: a CUDA tensor launches the kernel or raises
# --------------------------------------------------------------------------
@pytest.mark.parametrize("broken", ["no_nvcc", "loader"])
def test_wrapper_raises_without_kernel(tdb_cpu, monkeypatch, tmp_path,
                                       broken):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import build as kbuild
    rel, cp = _compiled(tdb_cpu, tq.get_query("Q6"))[0]
    monkeypatch.setattr(kbuild, "_libs", {})
    if broken == "no_nvcc":
        monkeypatch.setattr(kbuild, "_BUILD_DIR", tmp_path)
        monkeypatch.setenv("PATH", str(tmp_path))
        monkeypatch.delenv("CUDA_HOME", raising=False)
        match = "nvcc not found"
    else:
        def fail():
            raise OSError("cannot load the fused_program library")
        monkeypatch.setattr(kp, "_library", fail)
        match = "cannot load"
    with FakeTensorMode():
        stacked = torch.empty((cp.tape.n_rows, rel.layout.n_words),
                              dtype=torch.int32, device="cuda")
    assert stacked.device.type == "cuda"
    before = kp.launches
    with pytest.raises((RuntimeError, OSError), match=match):
        kp.fused_program(stacked, cp.tape)
    assert kp.launches == before


# --------------------------------------------------------------------------
# On the card: the kernel against its plain version
# --------------------------------------------------------------------------
@pytest.mark.cuda
def test_kernel_matches_plain_on_card(tdb_cpu):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is "
                    "false)")
    cases = [cp_rel for q in tq.all_queries() + _minmax_specs()
             for cp_rel in _compiled(tdb_cpu, q)]
    for rel, cp in cases:
        stacked = tprog.stack_sources(cp, rel).cuda()
        for x in (stacked, stacked[:, :1000].contiguous()):
            before = kp.launches
            got = kp.fused_program(x, cp.tape)
            want = kp.fused_program_torch(x, cp.tape)
            torch.cuda.synchronize()
            assert kp.launches == before + 1
            for g, w in zip(got, want):
                assert torch.equal(g, w)
    with pytest.raises(ValueError, match="rows"):
        kp.fused_program(stacked[1:], cp.tape)


def test_pure_opcodes_are_their_truth_tables():
    """The kernel computes every pure op as ((x & y) & A) ^ ((x ^ y) & X)
    ^ N, A, X, N the opcode's bits 0-2 spread over the word, with NOT
    reading its operand twice: each opcode gives its op."""
    rng = np.random.default_rng(SEED)
    x, y = rng.integers(0, 1 << 32, (2, 1000), dtype=np.uint64).astype(
        np.uint32)
    want = {kp.CONST0: np.zeros_like(x), kp.CONST1: ~np.zeros_like(x),
            kp.AND: x & y, kp.OR: x | y, kp.XOR: x ^ y, kp.NOT: ~x}
    for op, w in want.items():
        assert op < kp.POPC
        b = x if op == kp.NOT else y
        m = [np.uint32(0xFFFFFFFF * ((op >> i) & 1)) for i in range(3)]
        np.testing.assert_array_equal(
            ((x & b) & m[0]) ^ ((x ^ b) & m[1]) ^ m[2], w)
