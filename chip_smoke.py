"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases (any failure exits non-zero before the last line):

1. Device: require CUDA; print the card's name and power limit.
2. Build: compile every ``src/repro_torch/kernels/csrc/*.cu`` with nvcc
   from the checkout's sources, all at once; print the seconds and the
   compiler's resource reports.
3. Kernels vs plain, TPC-H SF 0.01, bit for bit:
   ``fused_program`` against ``fused_program_torch`` on all 34 relation
   programs of the 19 TPC-H specs, on two MIN/MAX programs (over a
   derived expression; over an empty selection) and on a multi-tile
   relation whose record count is a multiple of neither 32 nor the
   tile; ``materialize`` against ``materialize_torch`` (the count and
   the count prefix) on the 16 ``Materialize`` programs of the six
   host-stage specs, on random plane stacks of widths 1, 7, 8, 9, 16, 17,
   31, 32 and 33 at mask densities 0, 0.001, 0.5 and 1 (an all-ones
   word, bit 31) and at 1, 100,003 and 250,001 words (both layouts, both
   decodes), on all nine widths together under one selected record and
   under an all-ones mask, and from four host threads at once on one
   stream;
   ``bitpack``/``bitunpack`` against their plain versions on random
   words at 4, 5, 100,003 and 250,001 words (a multiple of no tile),
   all-ones and bit-31 words and 3 words, the round trip and any-uint32
   pack input, each from the tensors as allocated and from 4-byte
   aligned copies (``bitpack``'s scalar path; ``bitunpack`` reads its
   words with scalar loads either way);
   ``eq_imm``/``cmp_imm``/``range_mask`` against their plain versions on
   every immediate predicate operand the eager engine hands them over the
   34 programs and on random stacks of
   widths 1, 7, 8, 9, 16, 17, 31, 32, 33, 64 and the widest operand
   (immediates 0, 2^n - 1, bit 31 set, bits above the width), ``eq_imm``
   also at W % 4 = 0, 1, 2, 3 (each on a copy 4- but not 8-byte aligned
   too) and at width 1,024, ``cmp_imm`` so at widths 1, 4, 8, 9, 16, 17,
   21, 32, 33, 64 and 1,024 (immediates 0, all-ones, the top bit alone,
   negative, too wide); ``filter_sum`` at (nf, na) (9, 0), (5, 1),
   (17, 12), (24, 20), (12, 24), (32, 33), (32, 64), (33, 64) and
   (17, 1,024) over word counts 1, 255, 256, 257, 100,003, 188,416 and
   1,100,000 (beyond one wave of its persistent grid), with an aligned
   and a misaligned valid plane, from
   four host threads on one stream and on two streams; one warm
   ``filter_sum`` call must enqueue exactly one CUDA kernel, counted as
   the kernel nodes of the call captured into a CUDA graph (no CUPTI; a
   capture that fails stops the run with the method named). The word
   counts there are not a multiple of any kernel's block.
4. Main paths, TPC-H SF 1, each driven with the launch counts set to 0
   just before it and read just after:
   a. ``PimDatabase(tables).execute(spec)`` for the 19 ``filter_only()``
      specs and the two MIN/MAX specs on FUSED, every mask and aggregate
      equal to ``Engine.ORACLE``; ``fused_program`` launches once per
      relation program;
   b. ``execute(spec)`` end to end for the six host-stage specs: result
      rows and materialized record counts equal ``Engine.ORACLE``'s;
      ``fused_program`` and ``materialize`` each launch once per relation
      program (16);
   c. the column transform of Q6's lineitem mask through
      ``kernels.ops.unpack_mask``/``pack_mask``: the unpacked bits equal
      the ORACLE's selection and packing them gives the mask back;
   d. the eager engine: the specs of a. and the six host-stage specs on
      ``engine="eager"``, every mask, aggregate and result row equal to
      ORACLE's (and FUSED's); ``eq_imm``/``cmp_imm`` launch once per
      immediate predicate with a representable immediate in the traces,
      every other kernel 0 times; then, stepping the engine through the
      same programs, ``eq_imm``/``cmp_imm``/``range_mask`` against their
      plain versions on every operand and immediate the path handed
      them; a table of eager execute_ms;
   e. the kernel API on lineitem: ``ops.predicate_range`` over
      ``l_shipdate`` with Q6's bounds and ``ops.fused_filter_sum`` with
      ``l_extendedprice`` (exact count and sum), ``predicate_eq_imm``/
      ``predicate_cmp_imm`` on ``l_quantity``, all against numpy over the
      encoded columns; each launches once;
   f. linked batches through ``execute(list)``: (i) Q1 + Q6 + Q14 (Q14
      with its host stage), (ii) the specs of a., (iii) every spec of
      ``queries.all_queries()``, host stages included. Every result equals
      the same spec's sequential FUSED result of a. or b. and its ORACLE
      result; ``fused_program`` launches once per relation a batch
      touches, ``materialize`` once per host-stage relation program. Per
      batch: launches against the sequential count, plane reads against
      the singles' sum, deduped instructions, the linked tapes' card time
      (each kernel == plain) against the single programs', and the
      batch's warm execute time against the summed execute_ms.
   g. the HTAP stream of ``benchmarks/bench_kernels.py::bench_htap_stream``
      on a fresh ``PimDatabase`` over a.'s tables, lineitem resident on
      the card: first the static verifier's ms on Q1's cold compile; then
      6 rounds, each one ``db.apply([Insert(64 rows drawn by
      default_rng(7)), Delete(the previous round's rows)])`` and Q1 and Q6
      ``filter_only()`` on FUSED, Q6 equal to the mutable-table oracle and
      Q1 to ORACLE, no tape-cache miss after round 1; rotate's busiest row
      at most half a first-fit replay's; then an ``Update`` of l_quantity
      under Q6's predicate, an ``Insert`` of 32,768 rows (past the spare
      slots: the planes grow one tile), Q6 and Q14 on FUSED and Q6 on
      EAGER against ORACLE, kernels == plain at those shapes, ``Compact``
      and Q6 once more. ``db.apply`` launches nothing and keeps every
      plane on the card; ``fused_program`` launches once per relation
      program, ``materialize`` once per ``Materialize``, the eager Q6 only
      ``eq_imm``/``cmp_imm``. It prints each ``db.apply``'s wall ms, bytes
      moved to the card, instructions and cells written, the wear and the
      cost report's bytes and endurance; then the lint sweep
      (``repro_torch.analysis.lint``) runs on the card at SF 0.002.
   h. the query service over a.'s database: the trace of
      ``benchmarks/bench_kernels.py::bench_serve`` (4 waves of Q1, Q6,
      Q14, Q3, Q12, Q19, Q6, Q1) through ``launch.serve.serve_trace`` at
      concurrency 8 (max_window 8, max_wait 2 ms, max_pending 8), a fresh
      ``QueryService`` per replay, one cold replay and three warm, each
      result equal to the spec's sequential FUSED result of a./b. and its
      ORACLE result; every distinct spec dispatched once a replay,
      ``fused_program`` once per relation of each window and ``materialize``
      once per ``Materialize``; a table of qps against the sequential loop,
      p50/p99, dispatches, plane reads, cache hits, coalesced requests and
      windows; then ``DEFAULT_TRACE`` through ``serve_trace`` against a
      sequential ``execute`` loop (``--compare``'s parity); then the two
      service scenarios of ``tests/test_faults.py`` with a
      ``faults.FaultManager`` on a fresh database: a transient dispatch
      fault retried once, and retries exhausted -> two windows degraded to
      EAGER on the card (only ``eq_imm``/``cmp_imm``) -> a FUSED probe
      that closes the breaker, their counters equal to the reference's.
   i. the chaos soak (``faults.chaos.run_chaos`` on the card): at sf
      0.005 its counters equal ``benchmarks/baseline.json``'s
      ``chaos_soak`` field by field; at SF 1 (its own
      ``tpch.generate(sf=1, seed=0)``) it is ``ok`` with every injected
      fault detected, the breaker closed after one trip and one recovery;
      it prints the counters, each scrub's wall and bytes copied off the
      card and those of each verify-after-write. ``fused_program``
      launches once per FUSED dispatch, ``eq_imm``/``cmp_imm`` only in
      degraded windows, nothing else.
   Then every kernel against its plain version bit for bit at those SF 1
   shapes, and the times: first the timing floor (an empty kernel timed
   the same way, after a 64 MB write flush, a read flush and none); per
   query the warm median of ``execute``; per kernel its device time (CUDA
   events, cold L2, the launch queued behind a spin kernel), one call's
   time with the host's launch time in it, the plain version's time, the
   bound and what sets it; ``materialize`` at each path-b program;
   ``eq_imm``/``cmp_imm`` timed and
   bounded on each of path d's operands, summed. The fused
   tables give each program's tape and launch: entries, slots in the
   recorded order and after scheduling, the tile (threads x K words per
   thread), blocks per SM (the occupancy API) and registers per thread
   (as ``nvcc -Xptxas -v`` counts them); a K study runs Q1's and Q15's
   lineitem programs with K = 1, 2 and 4, each against plain.
5. The paper-scale cost report (``db.report``, SF 1 x 1000) of the 19
   specs, equal on FUSED and EAGER (the same traces, and masks path d
   found equal): the paper's analytical model, not a measurement of the
   card.
6. One ``{"kernels": [...]}`` JSON line (eight kernels; ``fused_program``
   over the programs of paths a, b, f and g; launches of paths a-i), then
   ``{"ok": true, ...}`` last.

Seeds fix the data; nothing is read from outside the checkout.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

import numpy as np
import torch

SEED = 123
SMOKE_SF = 0.01
MAIN_SF = 1.0
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
# Results per clock per SM on compute capability 9.0 (CUDA C++ Programming
# Guide, "Arithmetic Instructions" throughput table): 32-bit bitwise
# AND/OR/XOR and integer add 64, population count 16.
LOGIC_PER_CLOCK_SM = 64
POPC_PER_CLOCK_SM = 16
CSRC = "src/repro_torch/kernels/csrc/"
HOST_SPECS = ("Q3", "Q5", "Q10", "Q12", "Q14", "Q19")
# Random materialize widths: each decode bucket's edges (8, 16, 32), and
# 33 (planes past 32 add nothing).
MAT_WIDTHS = (1, 7, 8, 9, 16, 17, 31, 32, 33)
N_HOST_PROGRAMS = 16
# Column transform word counts: short of a tile (128 rows), a multiple of
# none, and more tiles than the card holds at once.
COLUMN_WORDS = (4, 5, 100_003, 250_001)
# A spin of about 2.5 ms at the H100's 1,980 MHz: long enough for the host
# to queue a wrapper's launches behind it (tens of microseconds).
AHEAD_CYCLES = 5_000_000


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int, flush: torch.Tensor | None = None,
            ahead: bool = False, read_flush: bool = False) -> float:
    """Median milliseconds of ``fn`` between two CUDA events, after one
    warm-up call; ``flush`` is overwritten (read, with ``read_flush``)
    before each timed call so the 50 MB L2 cache starts cold. Without
    ``ahead`` the interval includes the host's time to launch (the device
    waits for it); with ``ahead`` a spin kernel runs first, so ``fn``'s
    launches are queued before the start event is reached and the interval
    is the device's own time."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            if read_flush:
                flush.sum()
            else:
                flush.zero_()
        if ahead:
            torch.cuda._sleep(AHEAD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def timing_floor(flush) -> dict:
    """The card time of a kernel that does nothing (``csrc/timing.cu``, one
    block), timed as every kernel here is: queued behind a spin, after a 64
    MB write flush (the method's own), a 64 MB read flush, and none."""
    import ctypes
    from repro_torch.kernels import build

    def bind(lib):
        lib.empty_launch.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.empty_launch.restype = ctypes.c_int
    lib = build.library("timing", bind)

    def empty():
        if lib.empty_launch(1, torch.cuda.current_stream().cuda_stream):
            fail("empty kernel launch failed")
    floor = {"write": cuda_ms(empty, 21, flush, ahead=True),
             "read": cuda_ms(empty, 21, flush, ahead=True, read_flush=True),
             "none": cuda_ms(empty, 21, ahead=True)}
    print(f"timing floor (empty kernel, 1 block, queued behind a spin, "
          f"median of 21): {floor['write']:.4f} ms after a 64 MB write "
          f"flush, {floor['read']:.4f} ms after a 64 MB read flush, "
          f"{floor['none']:.4f} ms with no flush", flush=True)
    return floor


def host_profile(db, spec, top: int = 8) -> None:
    """Where one warm ``execute`` spends its host time: cProfile's own
    time per function (the profiler's overhead included)."""
    import cProfile
    import pstats
    db.execute(spec)
    prof = cProfile.Profile()
    prof.enable()
    db.execute(spec)
    torch.cuda.synchronize()
    prof.disable()
    st = pstats.Stats(prof)
    rows = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:top]
    print(f"host profile {spec.name}: total {st.total_tt * 1e3:.1f} ms; "
          + "; ".join(f"{Path(f).name}:{ln}:{fn} {tt * 1e3:.1f} ms"
                      for (f, ln, fn), (_, _, tt, _, _) in rows), flush=True)


def programs(db, specs):
    """(query, relation, CompiledProgram) for every relation program."""
    from repro_torch.core import program as prog
    out = []
    for spec in specs:
        for rel_name, pred in spec.filters.items():
            rel = db.relations[rel_name]
            c, mask_reg, _ = db._compile_relation(rel, spec, pred)
            out.append((spec.name, rel, prog.compile_program(
                rel, c.program, mask_outputs=(mask_reg,))))
    return out


def minmax_specs():
    from repro_torch.db import queries as Q
    from repro_torch.db.compiler import Agg, Cmp, Col, Lit, Mul, RSubImm
    return [
        Q.QuerySpec("Qmm_expr", "full",
                    filters={"lineitem": Cmp("lt", Col("l_quantity"),
                                             Lit(10))},
                    agg_relation="lineitem",
                    aggregates=[Agg("max", Mul(Col("l_extendedprice"),
                                               RSubImm(100,
                                                       Col("l_discount"))),
                                    "mx"),
                                Agg("min", Col("l_quantity"), "mn")]),
        Q.QuerySpec("Qmm_empty", "full",
                    filters={"customer": Cmp("gt", Col("c_acctbal"),
                                             Lit(1 << 40))},
                    agg_relation="customer",
                    aggregates=[Agg("min", Col("c_acctbal"), "mn"),
                                Agg("max", Col("c_acctbal"), "mx"),
                                Agg("sum", Col("c_acctbal"), "s"),
                                Agg("count", None, "c")])]


def peak_ops_per_s() -> tuple[float, float]:
    """(logic, popcount) operations per second of card 0: the per-SM rates
    above times its SM count and its maximum SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    smi = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    hz = float(smi.stdout.strip()) * 1e6
    print(f"peaks: {sms} SMs at {hz / 1e6:.0f} MHz: logic "
          f"{LOGIC_PER_CLOCK_SM * sms * hz:.4g}/s, popcount "
          f"{POPC_PER_CLOCK_SM * sms * hz:.4g}/s, memory "
          f"{HBM_BYTES_PER_S:.4g} B/s", flush=True)
    return LOGIC_PER_CLOCK_SM * sms * hz, POPC_PER_CLOCK_SM * sms * hz


def bound_s(bytes_: int, logic: int, popc: int, peaks) -> tuple[float, str]:
    """The least time for a launch and what sets it: its bytes over the
    memory rate, or its operations over their pipes' peaks."""
    byte_s = bytes_ / HBM_BYTES_PER_S
    op_s = max(logic / peaks[0], popc / peaks[1])
    return max(byte_s, op_s), "bytes" if byte_s >= op_s else "operations"


def max_abs_diff(got, want) -> int:
    return max((int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                if g.numel() else 0) for g, w in zip(got, want))


def phase_kernel_vs_plain() -> int:
    """Kernel vs plain on the card; returns the largest difference seen."""
    from repro_torch.core import engine as eng
    from repro_torch.core import program as prog
    from repro_torch.db import database as D
    from repro_torch.db import queries as Q
    from repro_torch.db import tpch
    from repro_torch.db.compiler import Agg, Between, Col, Compiler
    from repro_torch.kernels import program as kp

    db = D.PimDatabase(tpch.generate(sf=SMOKE_SF, seed=SEED))
    cases = [(name, rel, cp) for name, rel, cp in
             programs(db, [s.filter_only() for s in Q.all_queries()])]
    if len(cases) != 34:
        fail(f"expected 34 relation programs, got {len(cases)}")
    cases += programs(db, minmax_specs())

    rng = np.random.default_rng(SEED)
    n = 100_003
    cols = {"k": rng.integers(0, 1 << 12, n), "v": rng.integers(0, 1 << 9, n)}
    rel = eng.PimRelation.from_columns("t", cols)
    c = Compiler(rel)
    m = c.compile_filter(Between(Col("k"), 500, 3000), with_transform=False)
    regs = c.compile_aggregates(m, [Agg("sum", Col("v"), "s"),
                                    Agg("count", None, "c"),
                                    Agg("max", Col("v"), "mx")])
    cp = prog.compile_program(rel, c.program, mask_outputs=(m,))
    t = cp.tape.tile
    if n % 32 == 0 or n % t == 0 or rel.layout.n_words <= t:
        fail(f"multi-tile case is not ragged: n={n}, tile={t}")
    cases.append(("multi_block", rel, cp))

    worst = 0
    for name, rel, cp in cases:
        stacked = prog.stack_sources(cp, rel)
        for x in (stacked, stacked[:, :stacked.shape[1] - 7].contiguous()):
            got = kp.fused_program(x, cp.tape)
            want = kp.fused_program_torch(x, cp.tape)
            torch.cuda.synchronize()
            diff = max_abs_diff(got, want)
            if diff:
                fail(f"kernel != plain on {name}/{rel.name} "
                     f"(W={x.shape[1]}): max abs diff {diff}")
            worst = max(worst, diff)
    sel = (cols["k"] >= 500) & (cols["k"] <= 3000)
    res = prog.run_program(cp, rel)
    if not (np.array_equal(res.mask(m), sel)
            and res.scalar(regs["s"][1]) == int(cols["v"][sel].sum())
            and res.scalar(regs["c"][1]) == int(sel.sum())
            and res.scalar(regs["mx"][1]) == int(cols["v"][sel].max())):
        fail("multi-block program disagrees with numpy")
    mm = db.execute(minmax_specs()[1])
    if mm.aggregates != {"all": {"mn": None, "mx": None, "s": 0, "c": 0}}:
        fail(f"empty-selection MIN/MAX: {mm.aggregates}")
    print(f"phase 3 ok: kernel == plain on {len(cases)} programs "
          f"(x2 word counts) at SF {SMOKE_SF}", flush=True)
    return worst


def phase_main_path(peaks, flush):
    """The 19 specs and the two MIN/MAX specs at SF 1 on FUSED, checked
    against ORACLE; then kernel vs plain at every program's SF 1 shape and
    the per-query and per-kernel timings. Returns the database and the
    path's fused_program record."""
    from repro_torch.db import database as D
    from repro_torch.db import queries as Q
    from repro_torch.db import tpch
    from repro_torch.kernels import program as kp

    t0 = time.perf_counter()
    tables = tpch.generate(sf=MAIN_SF, seed=SEED)
    t1 = time.perf_counter()
    db = D.PimDatabase(tables)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    print(f"SF {MAIN_SF}: generate {t1 - t0:.1f} s, pack + copy to the "
          f"card {t2 - t1:.1f} s; lineitem {db.relations['lineitem'].n_records}"
          f" records, {db.relations['lineitem'].layout.n_words} words/plane",
          flush=True)
    specs = [s.filter_only() for s in Q.all_queries()]
    run = specs + minmax_specs()

    kp.launches = 0
    results = [db.execute(s) for s in run]
    launches = kp.launches
    n_programs = sum(len(s.filters) for s in run)
    if launches != n_programs:
        fail(f"fused_program launched {launches} times for {n_programs} "
             "relation programs")
    oracles = {}
    for spec, fused in zip(run, results):
        oracle = oracles[spec.name] = db.execute(spec, engine=D.Engine.ORACLE)
        for rel in spec.filters:
            if not np.array_equal(fused.relations[rel].mask,
                                  oracle.relations[rel].mask):
                fail(f"{spec.name}/{rel}: FUSED mask != ORACLE")
        if fused.aggregates != oracle.aggregates:
            fail(f"{spec.name}: FUSED aggregates {fused.aggregates} != "
                 f"ORACLE {oracle.aggregates}")
    print(f"phase 4 ok: {len(run)} specs at SF {MAIN_SF} == ORACLE, "
          f"{launches} launches for {n_programs} relation programs",
          flush=True)

    per_prog = {}
    worst = 0
    for name, rel, cp in programs(db, run):
        per_prog.setdefault(name, []).append(fused_timing(cp, rel, flush))
        worst = max(worst, per_prog[name][-1]["diff"])
    print(f"phase 4 ok: kernel == plain on {sum(map(len, per_prog.values()))}"
          f" programs at SF {MAIN_SF}", flush=True)

    print("query   execute_ms  kernel_ms   call_ms busy_%  stack_ms   "
          "plain_ms  bound_ms bound_by   per relation: entries/slots "
          "recorded>scheduled/tile=threads*K/blocks per SM/registers")
    exec_all = {}
    for spec in run:
        ps = per_prog[spec.name]
        exec_ms = exec_all[spec.name] = cuda_ms(lambda: db.execute(spec), 3)
        kernel_ms = sum(p["kernel_ms"] for p in ps)
        bounds = [bound_s(p["bytes"], p["logic"], p["popc"], peaks)
                  for p in ps]
        by = {b for _, b in bounds}
        print(f"{spec.name:9s} {exec_ms:11.3f} {kernel_ms:10.4f} "
              f"{sum(p['call_ms'] for p in ps):9.4f} "
              f"{100 * kernel_ms / exec_ms:6.2f} "
              f"{sum(p['stack_ms'] for p in ps):9.4f} "
              f"{sum(p['plain_ms'] for p in ps):10.3f} "
              f"{sum(b for b, _ in bounds) * 1e3:9.5f} "
              f"{by.pop() if len(by) == 1 else 'mixed':10s} "
              + " ".join(tape_shape(p) for p in ps), flush=True)
    for name in ("Q6", "Q12"):
        host_profile(db, next(s for s in specs if s.name == name))

    progs = [p for ps in per_prog.values() for p in ps]
    print_fused_total(f"the {len(progs)} programs of path a", progs, peaks)
    worst = max(worst, words_per_thread_study(db, flush))
    return db, {"launches": launches, "max_abs_err": worst, "progs": progs,
                "results": {s.name: r for s, r in zip(run, results)},
                "oracle": oracles, "exec_ms": exec_all, "by_query": per_prog}


def fused_totals(progs, peaks) -> dict:
    """``fused_program``'s summed times and bound over ``progs``."""
    total_s, total_by = bound_s(sum(p["bytes"] for p in progs),
                                sum(p["logic"] for p in progs),
                                sum(p["popc"] for p in progs), peaks)
    return {"ms": sum(p["kernel_ms"] for p in progs),
            "plain_ms": sum(p["plain_ms"] for p in progs),
            "bound_ms": total_s * 1e3, "bound_by": total_by}


def print_fused_total(what, progs, peaks) -> None:
    t = fused_totals(progs, peaks)
    print(f"fused_program over {what}: kernel {t['ms']:.4f} ms, call "
          f"{sum(p['call_ms'] for p in progs):.4f} ms, plain "
          f"{t['plain_ms']:.3f} ms, bound {t['bound_ms']:.5f} ms "
          f"({t['bound_by']})", flush=True)


def fused_entry(paths, peaks) -> dict:
    """The ``fused_program`` kernels entry over the main paths' programs."""
    return {"name": "fused_program", "route": "cuda",
            "source": CSRC + "fused_program.cu",
            "replaces": "src/repro/kernels/program.py:147",
            "launches": sum(path["launches"] for path in paths),
            "max_abs_err": max(path["max_abs_err"] for path in paths),
            **fused_totals([p for path in paths for p in path["progs"]],
                           peaks),
            "library_ms": None}


def fused_timing(cp, rel, flush, tape=None) -> dict:
    """``fused_program`` at one program's shape (with ``tape``'s launch if
    given): kernel vs plain bit for bit (fails otherwise), its times,
    bytes and operations, and the tape's shape and launch."""
    from repro_torch.core import program as prog
    from repro_torch.kernels import program as kp
    tape = tape or cp.tape
    stacked = prog.stack_sources(cp, rel)
    diff = max_abs_diff(kp.fused_program(stacked, tape),
                        kp.fused_program_torch(stacked, tape))
    if diff:
        fail(f"fused_program != plain on {rel.name} at SF {MAIN_SF}: "
             f"max abs diff {diff}")
    w = stacked.shape[1]
    logic, popc = tape.word_ops()
    per_sm, regs = kp.occupancy(tape, stacked.device)
    return {
        "relation": rel.name, "diff": diff,
        "kernel_ms": cuda_ms(lambda: kp.fused_program(stacked, tape), 5,
                             flush, ahead=True),
        "call_ms": cuda_ms(lambda: kp.fused_program(stacked, tape), 5,
                           flush),
        "plain_ms": cuda_ms(lambda: kp.fused_program_torch(stacked, tape),
                            2),
        "stack_ms": cuda_ms(lambda: prog.stack_sources(cp, rel), 5, flush,
                            ahead=True),
        "bytes": (tape.n_rows + tape.n_masks) * w * 4,
        "logic": logic * w, "popc": popc * w,
        "tape_len": len(tape), "slots_recorded": tape.slots_recorded,
        "n_slots": tape.n_slots, "threads": tape.launch.threads,
        "k": tape.launch.k, "blocks_per_sm": per_sm, "regs": regs}


def tape_shape(p) -> str:
    """One program's tape and launch, as the fused tables print it."""
    return (f"{p['relation']}:{p['tape_len']}/{p['slots_recorded']}>"
            f"{p['n_slots']}/{p['threads'] * p['k']}={p['threads']}*"
            f"{p['k']}/{p['blocks_per_sm']}/{p['regs']}")


def words_per_thread_study(db, flush) -> int:
    """Q1's and Q15's lineitem programs at SF 1 with K = 1, 2 and 4 words
    per thread (each with the tile the block choice gives that K): kernel
    == plain and the card time of each. Returns the largest difference."""
    from repro_torch.db import queries as Q
    worst = 0
    for name in ("Q1", "Q15"):
        (_, rel, cp), = programs(db, [Q.get_query(name).filter_only()])
        for k in (1, 2, 4):
            p = fused_timing(cp, rel, flush, cp.tape.with_words_per_thread(k))
            worst = max(worst, p["diff"])
            print(f"K study {name} {tape_shape(p)}: kernel "
                  f"{p['kernel_ms']:.4f} ms"
                  + (" (chosen)" if k == cp.tape.launch.k else ""),
                  flush=True)
    return worst


def host_programs(db):
    """(query, relation, CompiledProgram, Materialize instruction) for each
    relation program of the six host-stage specs, compiled as
    ``PimDatabase.execute`` compiles them."""
    from repro_torch.core import program as prog
    from repro_torch.db import exec as E
    from repro_torch.db import queries as Q
    from repro_torch.db.compiler import Compiler
    out = []
    for name in HOST_SPECS:
        for rel_name, pred, cols in E.split_query(Q.get_query(name))[0]:
            rel = db.relations[rel_name]
            c = Compiler(rel)
            m = (c.compile_filter(pred, with_transform=False)
                 if pred is not None else c.compile_scan_all())
            c.compile_materialize(m, cols)
            cp = prog.compile_program(rel, c.program, mask_outputs=())
            out.append((name, rel, cp, c.program[-1]))
    if len(out) != N_HOST_PROGRAMS:
        fail(f"expected {N_HOST_PROGRAMS} Materialize programs, got "
             f"{len(out)}")
    return out


def materialize_inputs(rel, cp, ins):
    """The materialize kernel's inputs in a program: its attributes'
    planes and the mask the program kernel stores (or the valid plane)."""
    from repro_torch.core import program as prog
    from repro_torch.kernels import program as kp
    masks, _, _ = kp.fused_program(prog.stack_sources(cp, rel), cp.tape)
    mask = (rel.valid if ins.mask == "__valid__"
            else masks[cp.kernel_masks.index(ins.mask)])
    return [rel.planes[a] for a in ins.attrs], mask


def check_materialize(what, planes, mask) -> tuple[int, int]:
    """materialize vs materialize_torch on the card: the count and the
    count prefix, bit for bit. Returns (max abs diff, count)."""
    from repro_torch.kernels import materialize as km
    want, wcnt = km.materialize_torch(planes, mask)
    n = int(wcnt)
    got, cnt = km.materialize_kernel(planes, mask)
    torch.cuda.synchronize()
    if int(cnt) != n:
        fail(f"materialize count {int(cnt)} != plain {n} on {what}")
    diff = max_abs_diff([got[:, :n]], [want[:, :n]])
    if diff:
        fail(f"materialize != plain on {what}: max abs diff {diff}")
    return diff, n


def check_materialize_threads(planes, mask, n_threads=4, calls=25) -> None:
    """materialize from ``n_threads`` host threads at once, all on the
    default stream, ``calls`` each: every result equals plain (the
    look-back kernel's state is shared by the stream's launches)."""
    import threading
    from repro_torch.kernels import materialize as km
    want, wcnt = km.materialize_torch(planes, mask)
    n = int(wcnt)
    results, errors = [], []

    def run():
        try:
            for _ in range(calls):
                results.append(km.materialize_kernel(planes, mask))
        except Exception as e:          # reported below, fails the run
            errors.append(e)
    threads = [threading.Thread(target=run) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    if errors:
        fail(f"materialize from {n_threads} threads raised: {errors[0]}")
    for got, cnt in results:
        if int(cnt) != n or max_abs_diff([got[:, :n]], [want[:, :n]]):
            fail(f"materialize from {n_threads} threads on one stream != "
                 "plain")


def check_column_transform(what, words, gen) -> int:
    """bitunpack and bitpack vs their plain versions on ``words``, from
    the tensors as they are (16-byte aligned: bitpack's vector loads) and
    from 4-byte aligned copies (its scalar path); the round trip must
    give the words back, and random any-uint32 rows (from ``gen``) pack to
    the plain version's wrapped sum. Returns the max abs diff."""
    from repro_torch.kernels import bitpack as kb
    want = kb.bitunpack_torch(words)
    wide = torch.randint(-(1 << 31), 1 << 31, (words.shape[0], 32),
                         dtype=torch.int32, generator=gen).cuda()
    want_wide = kb.bitpack_torch(wide)
    diff = 0
    for place in (torch.Tensor.contiguous, misaligned):
        got = [kb.bitunpack(place(words)), kb.bitpack(place(want)),
               kb.bitpack(place(wide))]
        diff = max(diff, max_abs_diff(got, [want, words, want_wide]))
    torch.cuda.synchronize()
    if diff:
        fail(f"bitpack/bitunpack != plain on {what}: max abs diff {diff}")
    return diff


def phase_new_kernels_vs_plain() -> tuple[int, int]:
    """materialize, bitpack and bitunpack vs plain at SF 0.01 and on
    random data. Returns (materialize, column transform) max abs diffs."""
    from repro_torch.db import database as D
    from repro_torch.db import tpch
    from repro_torch.kernels import bitpack as kb

    db = D.PimDatabase(tpch.generate(sf=SMOKE_SF, seed=SEED))
    worst = 0
    for name, rel, cp, ins in host_programs(db):
        planes, mask = materialize_inputs(rel, cp, ins)
        worst = max(worst, check_materialize(f"{name}/{rel.name}", planes,
                                             mask)[0])
    g = torch.Generator().manual_seed(SEED)
    # Word counts that are a multiple of no block (256, 8): 250,001 words
    # are more tiles than the card holds at once (the two-pass layout),
    # 100,003 and 1 fewer (the look-back). Density 0.001 leaves every warp
    # sparse (the lane-by-lane decode), 0.5 and 1 dense (the transpose).
    big, n_words = 250_001, 100_003
    for width in MAT_WIDTHS:
        planes = torch.randint(-(1 << 31), 1 << 31, (width, big),
                               dtype=torch.int32, generator=g)
        planes[-1, ::3] |= -(1 << 31)   # bit 31 set in every third word
        planes[:, 5] = -1               # an all-ones word
        for density in (0.0, 0.001, 0.5, 1.0):
            bits = (torch.rand((big, 32), generator=g) < density)
            mask = kb.bitpack_torch(bits.to(torch.int32))
            for w in (big, n_words, 1):
                worst = max(worst, check_materialize(
                    f"random width {width} density {density} W={w}",
                    [planes[:, :w].contiguous().cuda()],
                    mask[:w].contiguous().cuda())[0])
    one = torch.zeros(n_words, dtype=torch.int32)
    one[n_words // 2] = -(1 << 31)      # a single selected record
    mixed = [torch.randint(-(1 << 31), 1 << 31, (width, n_words),
                           dtype=torch.int32, generator=g).cuda()
             for width in MAT_WIDTHS]
    for what, mask in (("one record", one), ("all-ones mask",
                                             torch.full_like(one, -1))):
        worst = max(worst, check_materialize(
            f"widths {MAT_WIDTHS} together, {what}", mixed, mask.cuda())[0])
    check_materialize_threads(mixed, torch.full_like(one, -1).cuda())
    col = 0
    cases = [(f"{w} random words", torch.randint(
        -(1 << 31), 1 << 31, (w,), dtype=torch.int32, generator=g))
        for w in COLUMN_WORDS]
    cases += [("all-ones words", torch.full((n_words,), -1,
                                            dtype=torch.int32)),
              ("bit-31 words", torch.full((n_words,), -(1 << 31),
                                          dtype=torch.int32)),
              ("3 words", torch.tensor([0, -1, -(1 << 31)],
                                       dtype=torch.int32))]
    for what, words in cases:
        col = max(col, check_column_transform(what, words.cuda(), g))
    print(f"phase 3 ok: materialize == plain on {N_HOST_PROGRAMS} programs "
          f"at SF {SMOKE_SF}, {12 * len(MAT_WIDTHS) + 2} random cases "
          f"(widths {MAT_WIDTHS}) and from 4 threads on one stream; "
          f"bitpack/bitunpack == plain on {len(cases)} cases (random at "
          f"{COLUMN_WORDS} words, all-ones, bit 31, 3 words; any-uint32 "
          "pack input), each aligned and from a 4-byte aligned copy",
          flush=True)
    return worst, col


def phase_host_path(db, peaks, flush):
    """Path b: the six host-stage specs end to end at SF 1 against ORACLE,
    their launches, then each kernel against plain at every program's
    shape and the per-query timings. Returns (fused path record,
    materialize entry)."""
    from repro_torch.db import database as D
    from repro_torch.db import queries as Q
    from repro_torch.kernels import materialize as km
    from repro_torch.kernels import program as kp

    specs = [Q.get_query(n) for n in HOST_SPECS]
    kp.launches = 0
    km.launches = 0
    results = [db.execute(s) for s in specs]
    launches, mat_launches = kp.launches, km.launches
    if (launches, mat_launches) != (N_HOST_PROGRAMS, N_HOST_PROGRAMS):
        fail(f"host specs: fused_program launched {launches} and "
             f"materialize {mat_launches} times for {N_HOST_PROGRAMS} "
             "relation programs")
    oracles = {}
    for spec, fused in zip(specs, results):
        oracle = oracles[spec.name] = db.execute(spec, engine=D.Engine.ORACLE)
        if not fused.rows or fused.rows != oracle.rows:
            fail(f"{spec.name}: FUSED rows != ORACLE ({len(fused.rows)} vs "
                 f"{len(oracle.rows)} rows)")
        if fused.materialized_rows != oracle.materialized_rows:
            fail(f"{spec.name}: materialized {fused.materialized_rows} != "
                 f"ORACLE {oracle.materialized_rows}")
    print(f"phase 4b ok: {len(specs)} host-stage specs at SF {MAIN_SF} == "
          f"ORACLE rows, {launches} fused_program and {mat_launches} "
          f"materialize launches for {N_HOST_PROGRAMS} relation programs",
          flush=True)

    per_prog = {}
    fused_progs = []
    mat_worst = 0
    fused_worst = 0
    for name, rel, cp, ins in host_programs(db):
        f = fused_timing(cp, rel, flush)
        fused_worst = max(fused_worst, f["diff"])
        fused_progs.append(f)
        planes, mask = materialize_inputs(rel, cp, ins)
        diff, n = check_materialize(f"{name}/{rel.name} at SF {MAIN_SF}",
                                    planes, mask)
        mat_worst = max(mat_worst, diff)
        w = mask.shape[0]
        per_prog.setdefault(name, []).append({
            "relation": rel.name, "fused": f, "count": n,
            "mat_ms": cuda_ms(lambda: km.materialize(planes, mask), 5, flush,
                              ahead=True),
            "mat_call_ms": cuda_ms(lambda: km.materialize(planes, mask), 5,
                                   flush),
            "mat_plain_ms": cuda_ms(
                lambda: km.materialize_torch(planes, mask), 2),
            "mat_bytes": (sum(p.shape[0] for p in planes) + 1) * w * 4
            + n * len(planes) * 4})
    print(f"phase 4b ok: fused_program and materialize == plain on "
          f"{N_HOST_PROGRAMS} programs at SF {MAIN_SF}", flush=True)

    print("query   execute_ms  pim_ms   host_ms  fused_ms  mat_ms  "
          "mat_call_ms  mat_plain_ms  mat_bound_ms  rows  "
          "relation:materialized rows/mat_ms")
    exec_all = {}
    for spec in specs:
        ps = per_prog[spec.name]
        exec_ms = exec_all[spec.name] = cuda_ms(lambda: db.execute(spec), 3)
        res = db.execute(spec)
        print(f"{spec.name:7s} {exec_ms:10.3f} {res.pim_s * 1e3:8.3f} "
              f"{res.host_s * 1e3:9.3f} "
              f"{sum(p['fused']['kernel_ms'] for p in ps):8.4f} "
              f"{sum(p['mat_ms'] for p in ps):8.4f} "
              f"{sum(p['mat_call_ms'] for p in ps):11.4f} "
              f"{sum(p['mat_plain_ms'] for p in ps):12.3f} "
              f"{sum(p['mat_bytes'] for p in ps) / HBM_BYTES_PER_S * 1e3:13.5f}"
              f" {len(res.rows):5d}  "
              + " ".join(f"{p['relation']}:{p['count']}/{p['mat_ms']:.4f}"
                         for p in ps),
              flush=True)
    for name in ("Q3", "Q12"):
        host_profile(db, Q.get_query(name))
    print_fused_total(f"the {len(fused_progs)} programs of path b",
                      fused_progs, peaks)

    progs = [p for ps in per_prog.values() for p in ps]
    mat = {"name": "materialize", "route": "cuda",
           "source": CSRC + "materialize.cu",
           "replaces": "src/repro/kernels/materialize.py:109",
           "launches": mat_launches, "max_abs_err": mat_worst,
           "ms": sum(p["mat_ms"] for p in progs),
           "plain_ms": sum(p["mat_plain_ms"] for p in progs),
           "bound_ms": sum(p["mat_bytes"] for p in progs)
           / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes", "library_ms": None}
    fused = {"launches": launches, "max_abs_err": fused_worst,
             "progs": fused_progs,
             "results": {s.name: r for s, r in zip(specs, results)},
             "oracle": oracles, "exec_ms": exec_all,
             "by_query": {n: [p["fused"] for p in ps]
                          for n, ps in per_prog.items()}}
    return fused, mat


def phase_column_transform(db, peaks, flush):
    """Path c: Q6's SF 1 lineitem mask through ``ops.unpack_mask`` and
    ``ops.pack_mask``, checked against ORACLE's selection; then both
    kernels against plain at that shape and their times. Returns the two
    kernels entries."""
    from repro_torch.core import program as prog
    from repro_torch.db import database as D
    from repro_torch.db import queries as Q
    from repro_torch.kernels import bitpack as kb
    from repro_torch.kernels import ops
    from repro_torch.kernels import program as kp

    spec = Q.get_query("Q6")
    (_, rel, cp), = programs(db, [spec])
    mask = kp.fused_program(prog.stack_sources(cp, rel), cp.tape)[0][0]
    kb.bitpack_launches = 0
    kb.bitunpack_launches = 0
    bits = ops.unpack_mask(mask)
    words = ops.pack_mask(bits)
    torch.cuda.synchronize()
    launches = {"bitpack": kb.bitpack_launches,
                "bitunpack": kb.bitunpack_launches}
    if launches != {"bitpack": 1, "bitunpack": 1}:
        fail(f"column transform launches {launches}, expected one each")
    want = db.execute(spec, engine=D.Engine.ORACLE).relations["lineitem"].mask
    got = bits.reshape(-1)[:rel.n_records].cpu().numpy().astype(bool)
    if not (np.array_equal(got, want) and torch.equal(words, mask)):
        fail("column transform of Q6's mask disagrees with ORACLE")
    diff = check_column_transform("Q6 lineitem mask", mask,
                                  torch.Generator().manual_seed(SEED))
    w = mask.shape[0]
    print(f"phase 4c ok: Q6 lineitem mask ({w}, 32) through unpack_mask/"
          f"pack_mask == ORACLE, kernels == plain", flush=True)
    entries = []
    for name, line, fn, plain, x in (
            ("bitpack", 27, kb.bitpack, kb.bitpack_torch, bits),
            ("bitunpack", 48, kb.bitunpack, kb.bitunpack_torch, mask)):
        # A shift and an add (pack) or an and (unpack) per element.
        t = kernel_timing(f"{name} at ({w}, 32)", partial(fn, x),
                          partial(plain, x), w * 4 + w * 32 * 4, 2 * 32 * w,
                          0, peaks, flush)
        entries.append({
            "name": name, "route": "cuda", "source": CSRC + "bitpack.cu",
            "replaces": f"src/repro/kernels/bitpack.py:{line}",
            "launches": launches[name], "max_abs_err": diff, "ms": t["ms"],
            "read_flush_ms": t["read_flush_ms"], "call_ms": t["call_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None})
    return entries


IMM_KINDS = ("EqualImm", "NotEqualImm", "LessThanImm", "GreaterThanImm")
FILTER_WIDTHS = (1, 7, 8, 9, 16, 17, 31, 32, 33, 64)
# eq_imm alone: stacks as wide as the kernels take, at W % 4 = 0..3.
EQ_WIDE = (1024,)
# cmp_imm at W % 4 = 0..3, aligned and not: each instance's edges (8, 16,
# 32 planes; wider 16 at a time), path d's widths (4-21) and the widest.
CMP_WIDTHS = (1, 4, 8, 9, 16, 17, 21, 32, 33, 64, 1024)
# filter_sum: (nf, na) reaching both filter chunk sizes (8, 16; wider
# stacks in several chunks) and na 0-1,024, at word counts of one word, a
# block's edges, a multiple of no block, lineitem at SF 1 and beyond one
# wave of the persistent grid (132 SMs x 8 blocks x 256 threads x 2 words
# = 540,672); a case with na x W above 2e8 (800 MB of aggregate planes)
# takes 188,416 words instead.
FILTER_SUM_SHAPES = ((9, 0), (5, 1), (17, 12), (24, 20), (12, 24),
                     (32, 33), (32, 64), (33, 64), (17, 1024))
FILTER_SUM_WORDS = (1, 255, 256, 257, 100_003, 188_416, 1_100_000)


def reset_launches() -> None:
    """Set every kernel wrapper's launch count to 0."""
    from repro_torch.kernels import bitpack as kb
    from repro_torch.kernels import bitwise_filter as kbf
    from repro_torch.kernels import filter_aggregate as kfa
    from repro_torch.kernels import materialize as km
    from repro_torch.kernels import program as kp
    kp.launches = km.launches = kfa.launches = 0
    kb.bitpack_launches = kb.bitunpack_launches = 0
    kbf.eq_imm_launches = kbf.cmp_imm_launches = 0
    kbf.range_mask_launches = 0


def read_launches() -> dict:
    """Every kernel wrapper's launch count, by kernel name."""
    from repro_torch.kernels import bitpack as kb
    from repro_torch.kernels import bitwise_filter as kbf
    from repro_torch.kernels import filter_aggregate as kfa
    from repro_torch.kernels import materialize as km
    from repro_torch.kernels import program as kp
    return {"fused_program": kp.launches, "materialize": km.launches,
            "eq_imm": kbf.eq_imm_launches, "cmp_imm": kbf.cmp_imm_launches,
            "range_mask": kbf.range_mask_launches, "filter_sum": kfa.launches,
            "bitpack": kb.bitpack_launches,
            "bitunpack": kb.bitunpack_launches}


def imm_predicates(instrs) -> tuple[int, int]:
    """(eq_imm, cmp_imm) launches an eager run of ``instrs`` makes: one per
    immediate predicate whose immediate its operand's width (``n_bits``,
    the compiler's operand width) can represent."""
    eq = cmp = 0
    for i in instrs:
        if i.kind in IMM_KINDS and i.imm < 1 << i.n_bits:
            if i.kind in ("EqualImm", "NotEqualImm"):
                eq += 1
            else:
                cmp += 1
    return eq, cmp


def check_filter_kernels(what, planes, imms) -> int:
    """eq_imm, cmp_imm and range_mask vs their plain versions on the card,
    bit for bit, for each immediate (range: ``[imm >> 3, imm)`` and
    ``[0, imm)``). Returns the max abs diff (0, or the run fails)."""
    from repro_torch.kernels import bitwise_filter as kbf
    worst = 0
    for imm in imms:
        got = [kbf.eq_imm(planes, imm), *kbf.cmp_imm(planes, imm),
               kbf.range_mask(planes, imm >> 3, imm),
               kbf.range_mask(planes, 0, imm)]
        want = [kbf.eq_imm_torch(planes, imm),
                *kbf.cmp_imm_torch(planes, imm),
                kbf.range_mask_torch(planes, imm >> 3, imm),
                kbf.range_mask_torch(planes, 0, imm)]
        torch.cuda.synchronize()
        diff = max_abs_diff(got, want)
        if diff:
            fail(f"eq_imm/cmp_imm/range_mask != plain on {what}, imm "
                 f"{imm:#x}: max abs diff {diff}")
        worst = max(worst, diff)
    return worst


def check_ragged(name, what, planes, imms) -> int:
    """``name`` (``eq_imm`` or ``cmp_imm``) vs its plain version on the
    card for the stack cut to each word count W - k, k = 0..3, so W % 4
    takes every value (two words a thread where W is even, one else), each
    also from a copy whose data pointer is 4- but not 8-byte aligned (one
    word a thread). Returns the max abs diff (0, or the run fails)."""
    from repro_torch.kernels import bitwise_filter as kbf
    kernel, plain = getattr(kbf, name), getattr(kbf, f"{name}_torch")
    worst = 0
    for k in range(4):
        x = planes[:, :planes.shape[1] - k].contiguous().cuda()
        for imm in imms:
            want = plain(x, imm)
            for xc in (x, misaligned(x)):
                got = kernel(xc, imm)
                diff = (max_abs_diff([got], [want]) if name == "eq_imm"
                        else max_abs_diff(got, want))
                if diff:
                    fail(f"{name} != plain on {what} at W={x.shape[1]} "
                         f"(data pointer % 8 = {xc.data_ptr() % 8}), imm "
                         f"{imm:#x}: max abs diff {diff}")
                worst = max(worst, diff)
    torch.cuda.synchronize()
    return worst


def misaligned(x):
    """A contiguous CUDA copy of ``x`` whose data pointer is 4-byte but not
    8-byte aligned (one word into a larger buffer)."""
    buf = torch.empty(x.numel() + 1, dtype=torch.int32, device="cuda")
    view = buf[1:].view(x.shape)
    view.copy_(x)
    if view.data_ptr() % 8 != 4 or not view.is_contiguous():
        fail("could not make a 4- but not 8-byte aligned view")
    return view


def check_filter_sum(what, fplanes, aplanes, valid, lo, hi) -> int:
    """filter_sum vs filter_sum_torch on the card: count and per-bit
    popcounts exactly. Returns the max abs diff."""
    from repro_torch.kernels import filter_aggregate as kfa
    got = kfa.filter_sum(fplanes, aplanes, valid, lo, hi)
    want = kfa.filter_sum_torch(fplanes, aplanes, valid, lo, hi)
    torch.cuda.synchronize()
    diff = max_abs_diff([g.reshape(-1) for g in got],
                        [w.reshape(-1) for w in want])
    if diff:
        fail(f"filter_sum != plain on {what}: max abs diff {diff}")
    return diff


def eager_programs(db, specs, hosts):
    """(label, relation, instructions) of every relation program an eager
    run of ``specs`` (mask/aggregate scope) and ``hosts`` (host-stage
    specs) steps through, compiled as ``PimDatabase.execute`` compiles
    them."""
    from repro_torch.db import exec as E
    from repro_torch.db.compiler import Compiler
    out = []
    for spec in specs:
        for rel_name, pred in spec.filters.items():
            rel = db.relations[rel_name]
            c, _, _ = db._compile_relation(rel, spec, pred)
            out.append((f"{spec.name}/{rel_name}", rel, list(c.program)))
    for spec in hosts:
        for rel_name, pred, cols in E.split_query(spec)[0]:
            rel = db.relations[rel_name]
            c = Compiler(rel)
            m = (c.compile_filter(pred, with_transform=False)
                 if pred is not None else c.compile_scan_all())
            c.compile_materialize(m, cols)
            out.append((f"{spec.name}/{rel_name}", rel, list(c.program)))
    return out


def check_eager_operands(progs, timing=None):
    """Step an eager ``Engine`` through each program as ``execute`` runs
    it and, before each immediate predicate whose immediate its operand
    can represent, hold eq_imm/cmp_imm/range_mask against their plain
    versions on that operand and immediate: the very inputs the eager
    path hands the kernels (relation planes, derived attributes, masks).
    A program stops after its last immediate predicate. With ``timing``
    (peaks, flush), each operand's own kernel (eq_imm for an (in)equality,
    cmp_imm for an order comparison, as the eager path launches them) is
    also timed on the card and bounded. Returns (max abs diff, operands
    checked, widest operand in bits, {kernel: [(shape, card ms, bound
    ms)]} or None)."""
    from repro_torch.core import engine as eng
    worst = n_ops = widest = 0
    times = {"eq_imm": [], "cmp_imm": []} if timing else None
    for label, rel, instrs in progs:
        last = max((k for k, i in enumerate(instrs) if i.kind in IMM_KINDS),
                   default=-1)
        e = eng.Engine(rel)
        for i in instrs[:last + 1]:
            if i.kind in IMM_KINDS:
                p = e._planes(i.attr)
                if i.imm < 1 << p.shape[0]:
                    widest = max(widest, p.shape[0])
                    worst = max(worst, check_filter_kernels(
                        f"{label} {i.attr} {tuple(p.shape)}", p, [i.imm]))
                    n_ops += 1
                    if timing:
                        times_operand(times, i, p, *timing)
            e.execute(i)
    return worst, n_ops, widest, times


def times_operand(times, ins, planes, peaks, flush) -> None:
    """Card time and bound of the kernel the eager path launches for the
    immediate predicate ``ins`` on ``planes``, appended to ``times``."""
    from repro_torch.kernels import bitwise_filter as kbf
    nb, w = planes.shape
    if ins.kind in ("EqualImm", "NotEqualImm"):
        name, fn = "eq_imm", lambda: kbf.eq_imm(planes, ins.imm)
        nbytes, logic = nb * w * 4 + w * 4, nb * w
    else:
        name, fn = "cmp_imm", lambda: kbf.cmp_imm(planes, ins.imm)
        nbytes, logic = nb * w * 4 + 2 * w * 4, chain_ops(ins.imm, nb) * w
    bound, _ = bound_s(nbytes, logic, 0, peaks)
    times[name].append(((nb, w), cuda_ms(fn, 5, flush, ahead=True),
                        bound * 1e3))


def print_operand_times(times, floor) -> None:
    """Per kernel: launches, summed card time, summed bound and the floor
    times the launches, then the same by operand shape."""
    for name, rows in times.items():
        ms, bound = sum(r[1] for r in rows), sum(r[2] for r in rows)
        print(f"{name} over path d's {len(rows)} operands at SF {MAIN_SF}: "
              f"card {ms:.4f} ms (sum of each launch's median), bound "
              f"{bound:.5f} ms, floor x {len(rows)} = "
              f"{floor['write'] * len(rows):.4f} ms", flush=True)
        shapes = {}
        for shape, t, b in rows:
            n, st, sb = shapes.get(shape, (0, 0.0, 0.0))
            shapes[shape] = (n + 1, st + t, sb + b)
        print(f"  {name} by (bits, words): " + "; ".join(
            f"{shape}: {n} x {st / n:.4f} ms (bound {sb / n:.5f})"
            for shape, (n, st, sb) in sorted(shapes.items())), flush=True)


def phase_filter_kernels_vs_plain() -> dict:
    """eq_imm, cmp_imm, range_mask and filter_sum vs plain: on every
    immediate predicate operand of the eager engine's 34 programs at SF
    0.01, and on random stacks of widths 1-64 and the widest operand the
    engine hands them, at a word count that is a multiple of no block;
    eq_imm and cmp_imm also at W % 4 = 0..3, aligned and not, to width
    1,024; filter_sum over FILTER_SUM_SHAPES x FILTER_SUM_WORDS, from
    threads and streams, and as one kernel a call. Returns the worst
    diffs {"filter": ..., "filter_sum": ...}."""
    from repro_torch.db import database as D
    from repro_torch.db import queries as Q
    from repro_torch.db import tpch

    db = D.PimDatabase(tpch.generate(sf=SMOKE_SF, seed=SEED))
    worst, n_ops, widest, _ = check_eager_operands(
        eager_programs(db, [s.filter_only() for s in Q.all_queries()], []))
    g = torch.Generator().manual_seed(SEED)
    n_words = 100_003                       # a multiple of no block (256)
    for width in sorted(set(FILTER_WIDTHS) | {widest}):
        planes = torch.randint(-(1 << 31), 1 << 31, (width, n_words),
                               dtype=torch.int32, generator=g)
        planes[:, 0] = -1                   # all-ones words
        planes[:, 1] |= -(1 << 31)          # bit 31 set
        planes[:, 2] = 0
        top = (1 << width) - 1
        imms = [0, top, (1 << 31) | 5, top ^ 0x55,
                (1 << width) | (1 << (width + 9)) | 6]
        worst = max(worst, check_filter_kernels(
            f"random width {width}", planes.cuda(), imms))
        worst = max(worst, check_ragged("eq_imm", f"random width {width}",
                                        planes, imms))
    for width in EQ_WIDE:
        planes = torch.randint(-(1 << 31), 1 << 31, (width, 20_001),
                               dtype=torch.int32, generator=g)
        top = (1 << width) - 1
        worst = max(worst, check_ragged(
            "eq_imm", f"random width {width}", planes,
            [0, top, top ^ 0x55, (1 << width) | 6]))
    for width in CMP_WIDTHS:
        planes = torch.randint(-(1 << 31), 1 << 31,
                               (width, 20_001 if width > 64 else n_words),
                               dtype=torch.int32, generator=g)
        planes[:, 0] = -1
        planes[:, 1] |= -(1 << 31)
        top = (1 << width) - 1
        worst = max(worst, check_ragged(
            "cmp_imm", f"random width {width}", planes,
            [0, top, 1 << (width - 1), top ^ 0x55, -7,
             (1 << width) | (1 << (width + 9)) | 6]))
    sum_worst = 0
    gc = torch.Generator(device="cuda").manual_seed(SEED)
    for nf, na in FILTER_SUM_SHAPES:
        for w in FILTER_SUM_WORDS:
            w = w if na * w <= 200_000_000 else 188_416
            fp, ap, valid = random_words(gc, (nf, w), (na, w), (w,))
            for v in (valid, misaligned(valid)):
                for lo, hi in ((3, (1 << nf) - 9), (0, 1 << 31), (9, 3),
                               ((1 << nf) | 7, (1 << nf) - 1)):
                    sum_worst = max(sum_worst, check_filter_sum(
                        f"random ({nf}, {na}) W={w} [{lo:#x}, {hi:#x}) "
                        f"(valid pointer % 8 = {v.data_ptr() % 8})",
                        fp, ap, v, lo, hi))
    fp, ap, valid = random_words(gc, (12, 188_416), (24, 188_416),
                                 (188_416,))
    check_filter_sum_threads(fp, ap, valid, 5, 3000)
    kernels, nodes = filter_sum_kernels(fp, ap, valid, 5, 3000)
    print(f"phase 3 ok: eq_imm/cmp_imm/range_mask == plain on {n_ops} "
          f"eager operands at SF {SMOKE_SF} (widest {widest} bits) and "
          f"widths {sorted(set(FILTER_WIDTHS) | {widest})}; eq_imm at W % 4 "
          f"= 0..3, aligned and not, at those widths and {EQ_WIDE}, cmp_imm "
          f"at widths {CMP_WIDTHS}; filter_sum == plain at (nf, na) "
          f"{list(FILTER_SUM_SHAPES)} x W {list(FILTER_SUM_WORDS)}, "
          f"aligned and not, from 4 threads on "
          f"one stream and on 2 streams; one warm filter_sum call enqueues "
          f"{kernels} CUDA kernel ({nodes} graph node; CUDA graph capture)",
          flush=True)
    return {"filter": worst, "filter_sum": sum_worst}


def random_words(gen, *shapes):
    """Random int32 words on the card, one tensor per shape."""
    return [torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int32,
                          device="cuda", generator=gen) for shape in shapes]


def check_filter_sum_threads(fp, ap, valid, lo, hi, n_threads=4,
                             calls=25) -> None:
    """filter_sum from ``n_threads`` host threads at once on the default
    stream, ``calls`` each, then 20 calls alternating between two streams:
    every result equals plain (the kernel's state is per stream, and each
    launch returns it to zeros)."""
    import threading
    from repro_torch.kernels import filter_aggregate as kfa
    want = kfa.filter_sum_torch(fp, ap, valid, lo, hi)
    results, errors = [], []

    def run():
        try:
            for _ in range(calls):
                results.append(kfa.filter_sum(fp, ap, valid, lo, hi))
        except Exception as e:          # reported below, fails the run
            errors.append(e)
    threads = [threading.Thread(target=run) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for k in range(20):
        with torch.cuda.stream(streams[k % 2]):
            results.append(kfa.filter_sum(fp, ap, valid, lo, hi))
    torch.cuda.synchronize()
    if errors:
        fail(f"filter_sum from {n_threads} threads raised: {errors[0]}")
    for got in results:
        if max_abs_diff([g.reshape(-1) for g in got],
                        [w.reshape(-1) for w in want]):
            fail(f"filter_sum from {n_threads} threads on one stream, or on "
                 "two streams, != plain")


def filter_sum_kernels(fp, ap, valid, lo, hi) -> tuple[int, int]:
    """``(kernel nodes, all nodes)`` of one warm filter_sum call captured
    into a CUDA graph (``kernels.graph_count``: no CUPTI, so the count
    cannot come back empty by chance); the run fails unless the call
    enqueues exactly one kernel and the wrapper counts one launch, or, with
    the method named, when the capture fails."""
    from repro_torch.kernels import filter_aggregate as kfa
    from repro_torch.kernels import graph_count
    before = kfa.launches
    try:
        kernels, nodes = graph_count.kernels_enqueued(
            lambda: kfa.filter_sum(fp, ap, valid, lo, hi))
    except RuntimeError as e:
        fail(f"filter_sum kernel count: {e}")
    if kernels != 1 or kfa.launches != before + 2:
        fail(f"one warm filter_sum call enqueued {kernels} CUDA kernels "
             f"({nodes} graph nodes, {kfa.launches - before - 1} counted "
             f"launches), counted by {graph_count.METHOD}")
    return kernels, nodes


def phase_eager_path(db, fused_results, peaks, flush, floor):
    """Path d: the 19 ``filter_only()`` specs, the two MIN/MAX specs and
    the six host-stage specs on ``engine="eager"`` at SF 1, checked against
    ORACLE (and FUSED's masks and aggregates); eq_imm/cmp_imm launch once
    per representable immediate predicate of the traces, and nothing else
    launches. Then eq_imm/cmp_imm/range_mask against their plain versions
    on every operand and immediate the path handed them, each operand's
    eq_imm/cmp_imm launch timed. Returns (launch counts, worst diff, {name:
    eager result})."""
    from repro_torch.db import database as D
    from repro_torch.db import queries as Q

    specs = [s.filter_only() for s in Q.all_queries()] + minmax_specs()
    hosts = [Q.get_query(n) for n in HOST_SPECS]
    reset_launches()
    results = [db.execute(s, engine="eager") for s in specs]
    host_results = [db.execute(s, engine=D.Engine.EAGER) for s in hosts]
    torch.cuda.synchronize()
    launches = read_launches()

    progs = eager_programs(db, specs, hosts)
    want_eq = want_cmp = 0
    for _, _, instrs in progs:
        eq, cmp = imm_predicates(instrs)
        want_eq, want_cmp = want_eq + eq, want_cmp + cmp
    for spec, eager in zip(specs, results):
        oracle = db.execute(spec, engine=D.Engine.ORACLE)
        fused = fused_results[spec.name]
        if eager.engine is not D.Engine.EAGER:
            fail(f"{spec.name}: engine {eager.engine}")
        for rel, run in eager.relations.items():
            if not (np.array_equal(run.mask, oracle.relations[rel].mask)
                    and np.array_equal(run.mask, fused.relations[rel].mask)):
                fail(f"{spec.name}/{rel}: EAGER mask != ORACLE/FUSED")
        if not eager.aggregates == oracle.aggregates == fused.aggregates:
            fail(f"{spec.name}: EAGER aggregates {eager.aggregates} != "
                 f"ORACLE {oracle.aggregates} / FUSED {fused.aggregates}")
    for spec, eager in zip(hosts, host_results):
        oracle = db.execute(spec, engine=D.Engine.ORACLE)
        if not eager.rows or eager.rows != oracle.rows \
                or eager.materialized_rows != oracle.materialized_rows:
            fail(f"{spec.name}: EAGER rows/materialized != ORACLE")
    want = dict.fromkeys(read_launches(), 0)
    want.update(eq_imm=want_eq, cmp_imm=want_cmp)
    if launches != want:
        fail(f"eager path launches {launches}, expected {want}")
    print(f"phase 4d ok: {len(specs)} specs and {len(hosts)} host-stage "
          f"specs at SF {MAIN_SF} on EAGER == ORACLE (and FUSED); launches "
          f"{ {k: v for k, v in launches.items() if v} }, fused_program and "
          f"materialize 0", flush=True)
    worst, n_ops, widest, times = check_eager_operands(progs,
                                                       (peaks, flush))
    if n_ops != want_eq + want_cmp:
        fail(f"checked {n_ops} eager operands, the path launched "
             f"{want_eq + want_cmp} eq_imm/cmp_imm kernels")
    print(f"phase 4d ok: eq_imm/cmp_imm/range_mask == plain on all {n_ops} "
          f"operands the eager path handed them at SF {MAIN_SF} "
          f"({len(progs)} programs, up to {widest} bits wide)", flush=True)
    print_operand_times(times, floor)
    print("query     eager_ms   (EAGER execute, warm median of 3)")
    for spec in specs + hosts:
        ms = cuda_ms(lambda: db.execute(spec, engine="eager"), 3)
        print(f"{spec.name:9s} {ms:10.3f}", flush=True)
    return launches, worst, {s.name: r for s, r in zip(specs, results)}


def q6_shipdate_range(db) -> tuple[int, int]:
    """``[lo, hi)`` of Q6's ``l_shipdate`` comparisons, from the immediates
    of its compiled lineitem program."""
    from repro_torch.db import queries as Q
    spec = Q.get_query("Q6").filter_only()
    c, _, _ = db._compile_relation(db.relations["lineitem"], spec,
                                   spec.filters["lineitem"])
    lo = hi = None
    for i in c.program:
        if i.kind in IMM_KINDS and i.attr == "l_shipdate":
            if i.kind == "GreaterThanImm":
                lo = i.imm if i.or_equal else i.imm + 1
            elif i.kind == "LessThanImm":
                hi = i.imm + 1 if i.or_equal else i.imm
    if lo is None or hi is None:
        fail(f"Q6 has no l_shipdate range: {list(c.program)}")
    return lo, hi


def kernel_timing(name, fn, plain, nbytes, logic, popc, peaks, flush):
    """Card time (queued behind a spin, cold L2: after the method's write
    flush, and after a read flush, which leaves no dirty lines for the
    kernel's reads to evict), one call's time, the plain version's time
    and the bound of one kernel call."""
    bound, by = bound_s(nbytes, logic, popc, peaks)
    t = {"ms": cuda_ms(fn, 5, flush, ahead=True),
         "read_flush_ms": cuda_ms(fn, 5, flush, ahead=True, read_flush=True),
         "call_ms": cuda_ms(fn, 5, flush),
         "plain_ms": cuda_ms(plain, 3),
         "bound_ms": bound * 1e3, "bound_by": by}
    print(f"{name}: kernel {t['ms']:.4f} ms (after a read flush, no dirty "
          f"lines in L2: {t['read_flush_ms']:.4f} ms), call "
          f"{t['call_ms']:.4f} ms, "
          f"plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.5f} ms "
          f"({by}; {nbytes} bytes, {logic} logic ops, {popc} popcounts)",
          flush=True)
    return t


def chain_ops(imm: int, n_bits: int) -> int:
    """Logic ops per word of one MSB-first comparator chain: 3 for a set
    immediate bit (and-not, or, and), 1 for a clear one."""
    return sum(3 if (imm >> b) & 1 else 1 for b in range(n_bits))


def phase_kernel_api(db, peaks, flush):
    """Path e: the kernel API at SF 1 on lineitem. ``ops.predicate_range``
    over ``l_shipdate`` with Q6's bounds equals numpy over the encoded
    column; ``ops.fused_filter_sum`` with ``l_extendedprice`` gives the
    exact count and sum; ``predicate_eq_imm``/``predicate_cmp_imm`` on
    ``l_quantity`` equal numpy; each launches once. Then the four kernels'
    times at these shapes. Returns their kernels entries."""
    from repro_torch.core import bitslice
    from repro_torch.core import engine as eng
    from repro_torch.kernels import bitwise_filter as kbf
    from repro_torch.kernels import filter_aggregate as kfa
    from repro_torch.kernels import ops

    rel = db.relations["lineitem"]
    n = rel.n_records
    lo, hi = q6_shipdate_range(db)
    ship, price = rel.planes["l_shipdate"], rel.planes["l_extendedprice"]
    qty = rel.planes["l_quantity"]
    imm = 24
    reset_launches()
    rng_mask = ops.predicate_range(ship, lo, hi)
    cnt, pcs = ops.fused_filter_sum(ship, price, rel.valid, lo, hi)
    eq = ops.predicate_eq_imm(qty, imm)
    lt, eq2 = ops.predicate_cmp_imm(qty, imm)
    torch.cuda.synchronize()
    launches = read_launches()
    want = dict.fromkeys(launches, 0)
    want.update(eq_imm=1, cmp_imm=1, range_mask=1, filter_sum=1)
    if launches != want:
        fail(f"kernel API launches {launches}, expected {want}")
    vship = bitslice.unpack_bits(eng.to_words(ship), n)
    vprice = bitslice.unpack_bits(eng.to_words(price), n)
    vqty = bitslice.unpack_bits(eng.to_words(qty), n)
    sel = (vship >= lo) & (vship < hi)
    count, total = kfa.weight_popcounts(cnt, pcs)

    def unpack(m):
        return bitslice.unpack_mask(eng.to_words(m), n)

    if not np.array_equal(unpack(rng_mask), sel):
        fail("predicate_range over l_shipdate != numpy")
    if (count, total) != (int(sel.sum()), int(vprice[sel].sum())):
        fail(f"fused_filter_sum: ({count}, {total}) != numpy "
             f"({int(sel.sum())}, {int(vprice[sel].sum())})")
    if not (np.array_equal(unpack(eq), vqty == imm)
            and np.array_equal(unpack(eq2), vqty == imm)
            and np.array_equal(unpack(lt), vqty < imm)):
        fail("predicate_eq_imm/predicate_cmp_imm on l_quantity != numpy")
    diff = check_filter_kernels("l_shipdate at SF 1", ship, [lo, hi])
    sum_diff = check_filter_sum("Q6 shape at SF 1", ship, price, rel.valid,
                                lo, hi)
    print(f"phase 4e ok: lineitem at SF {MAIN_SF}: l_shipdate in [{lo}, "
          f"{hi}) selects {count} records, SUM(l_extendedprice) {total}; "
          f"eq/cmp on l_quantity == numpy; one launch each", flush=True)

    w = ship.shape[1]
    nf, na = ship.shape[0], price.shape[0]
    chains = chain_ops(lo, nf) + chain_ops(hi, nf) + 2
    cases = {
        "eq_imm": (39, lambda: kbf.eq_imm(ship, hi),
                   lambda: kbf.eq_imm_torch(ship, hi),
                   nf * w * 4 + w * 4, nf * w, 0, diff),
        "cmp_imm": (69, lambda: kbf.cmp_imm(ship, hi),
                    lambda: kbf.cmp_imm_torch(ship, hi),
                    nf * w * 4 + 2 * w * 4, chain_ops(hi, nf) * w, 0, diff),
        "range_mask": (110, lambda: kbf.range_mask(ship, lo, hi),
                       lambda: kbf.range_mask_torch(ship, lo, hi),
                       nf * w * 4 + w * 4, chains * w, 0, diff),
        "filter_sum": (63,
                       lambda: kfa.filter_sum(ship, price, rel.valid, lo, hi),
                       lambda: kfa.filter_sum_torch(ship, price, rel.valid,
                                                    lo, hi),
                       (nf + na + 1) * w * 4, (chains + 1 + 2 * na) * w,
                       (na + 1) * w, sum_diff)}
    entries = []
    for name, (line, fn, plain, nbytes, logic, popc, err) in cases.items():
        shape = f"({nf}+{na}+1, {w})" if name == "filter_sum" \
            else f"({nf}, {w})"
        t = kernel_timing(f"{name} at {shape}", fn, plain, nbytes, logic,
                          popc, peaks, flush)
        src = "filter_aggregate" if name == "filter_sum" else "bitwise_filter"
        entries.append({"name": name, "route": "cuda",
                        "source": CSRC + "bitwise_filter.cu",
                        "replaces": f"src/repro/kernels/{src}.py:{line}",
                        "launches": launches[name], "max_abs_err": err,
                        "ms": t["ms"], "plain_ms": t["plain_ms"],
                        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                        "library_ms": None})
    return entries


def linked_batches():
    """Path f's batches, (label, specs): (i) Q1 + Q6 + Q14 (Q14 with its
    host stage), (ii) path a's specs, (iii) every spec of
    ``queries.all_queries()``, host stages included."""
    from repro_torch.db import queries as Q
    return [("(i) Q1+Q6+Q14", [Q.get_query(n) for n in ("Q1", "Q6", "Q14")]),
            ("(ii) 19 filter_only + 2 MIN/MAX",
             [s.filter_only() for s in Q.all_queries()] + minmax_specs()),
            ("(iii) all_queries()", Q.all_queries())]


def linked_programs(db, specs):
    """(relation, CompiledProgram) of each relation of a batch, linked and
    compiled as ``PimDatabase.dispatch_batch`` links and compiles them."""
    from repro_torch.core import program as prog
    _, rel_programs = db._compile_batch(specs)
    out = []
    for rel_name, programs in rel_programs.items():
        rel = db.relations[rel_name]
        lp = prog.link_programs(programs, relation=rel)
        out.append((rel, prog.compile_program(
            rel, lp.instrs, mask_outputs=lp.mask_outputs,
            query_slots=lp.slots)))
    return out


def same_result(spec, got, want) -> bool:
    """A host-stage spec's rows and materialized counts, else its masks and
    aggregates, equal."""
    if spec.host is not None:
        return (got.rows == want.rows
                and got.materialized_rows == want.materialized_rows)
    return got.aggregates == want.aggregates and all(
        np.array_equal(got.relations[r].mask, want.relations[r].mask)
        for r in spec.filters)


def phase_linked_batches(db, path_a, path_b, flush):
    """Path f: the batches of ``linked_batches`` through ``execute(list)``
    at SF 1. Every result equals the same spec's sequential FUSED result of
    path a or b and its ORACLE result; ``fused_program`` launches once per
    relation the batch touches, ``materialize`` once per host-stage
    relation program, nothing else. Then each relation's linked tape: the
    kernel against plain bit for bit and its card time, beside the summed
    card time of the specs' single programs (paths a and b), and the
    batch's warm execute time beside the specs run one after another now
    and their execute_ms summed from paths a and b. Returns the path's
    fused_program record and its materialize launches."""
    from repro_torch.db import exec as E

    def seq(spec, key):
        return (path_b if spec.host is not None else path_a)[key][spec.name]

    record = {"launches": 0, "max_abs_err": 0, "progs": []}
    mat_launches = 0
    print("batch                            specs launches(seq) "
          "plane_reads(singles) deduped  kernel_ms(singles)  "
          "execute_ms(sequential now/paths a+b)   per relation: programs/"
          "reads/deduped/kernel_ms/entries/slots recorded>scheduled/tile="
          "threads*K/blocks per SM/registers", flush=True)
    for label, specs in linked_batches():
        reset_launches()
        results = db.execute(specs)
        torch.cuda.synchronize()
        launches = read_launches()
        stats = db.last_batch_stats
        linked = linked_programs(db, specs)
        n_host = sum(len(E.split_query(s)[0]) for s in specs
                     if s.host is not None)
        want = dict.fromkeys(launches, 0)
        want.update(fused_program=len(linked), materialize=n_host)
        if launches != want or stats["n_dispatches"] != len(linked):
            fail(f"path f {label}: launches {launches}, expected {want} "
                 f"(n_dispatches {stats['n_dispatches']})")
        for spec, got in zip(specs, results):
            for what, name in (("results", "sequential FUSED"),
                               ("oracle", "ORACLE")):
                if not same_result(spec, got, seq(spec, what)):
                    fail(f"path f {label}: {spec.name} != its {name} result")
        singles = [seq(s, "results").batch_stats for s in specs]
        rels = stats["relations"]
        timed = [fused_timing(cp, rel, flush) for rel, cp in linked]
        record["max_abs_err"] = max([record["max_abs_err"]]
                                    + [t["diff"] for t in timed])
        record["launches"] += launches["fused_program"]
        record["progs"] += timed
        mat_launches += launches["materialize"]
        wall = cuda_ms(lambda: db.execute(specs), 3)
        seq_now = cuda_ms(lambda: [db.execute(s) for s in specs], 3)
        seq_launches = sum(st["n_dispatches"] for st in singles)
        reads = sum(r["plane_reads"] for r in rels.values())
        seq_reads = sum(r["plane_reads"] for st in singles
                        for r in st["relations"].values())
        kernel_ms = sum(t["kernel_ms"] for t in timed)
        seq_kernel_ms = sum(p["kernel_ms"] for s in specs
                            for p in seq(s, "by_query"))
        seq_wall = sum(seq(s, "exec_ms") for s in specs)
        print(f"{label:32s} {len(specs):5d} {stats['n_dispatches']:4d}"
              f"({seq_launches:3d}) {reads:8d}({seq_reads:6d}) "
              f"{sum(r['instrs_deduped'] for r in rels.values()):7d} "
              f"{kernel_ms:9.4f}({seq_kernel_ms:8.4f}) "
              f"{wall:10.3f}({seq_now:10.3f}/{seq_wall:10.3f})  "
              + " ".join(
                  f"{t['relation']}:{rels[t['relation']]['n_programs']}/"
                  f"{rels[t['relation']]['plane_reads']}/"
                  f"{rels[t['relation']]['instrs_deduped']}/"
                  f"{t['kernel_ms']:.4f}/{tape_shape(t)[len(t['relation']) + 1:]}"
                  for t in timed), flush=True)
    print(f"phase 4f ok: {len(linked_batches())} linked batches at SF "
          f"{MAIN_SF} == sequential FUSED and ORACLE; one fused_program "
          f"launch per relation ({record['launches']}), one materialize "
          f"launch per host-stage relation program ({mat_launches}); "
          f"fused_program == plain on {len(record['progs'])} linked tapes",
          flush=True)
    return record, mat_launches


HTAP_ROUNDS, HTAP_BATCH, HTAP_GROW = 6, 64, 32_768


def verify_compile_timing(db) -> None:
    """The static verifier's share of Q1's cold compile at SF 1: the tape
    cache emptied, one ``compile_program`` (verifier and tape recording),
    then ``verify_compile`` alone on the same plans (median of 5)."""
    from repro_torch.analysis import passes
    from repro_torch.core import program as prog
    from repro_torch.db import queries as Q
    spec = Q.get_query("Q1")
    rel = db.relations["lineitem"]
    c, mask_reg, _ = db._compile_relation(rel, spec, spec.filters["lineitem"])
    prog._FN_CACHE.clear()
    t0 = time.perf_counter()
    cp = prog.compile_program(rel, c.program, mask_outputs=(mask_reg,))
    cold_ms = (time.perf_counter() - t0) * 1e3
    times, diags = [], ()
    for _ in range(5):
        t0 = time.perf_counter()
        diags = passes.verify_compile(cp.instrs, rel, cp.analysis, cp.plan,
                                      cp.arith, frozenset((mask_reg,)),
                                      "fused")
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"verify_compile on Q1's lineitem program at SF {MAIN_SF}: "
          f"{statistics.median(times):.3f} ms (median of 5) of a cold "
          f"compile_program of {cold_ms:.3f} ms; n_instrs {len(cp.instrs)}, "
          f"n_diags {len(diags)}", flush=True)


def htap_apply(db, label, mutations, rows, profile=False) -> None:
    """One ``db.apply`` on the card, timed to a synchronisation: its wall
    ms, the bytes the write primitives moved to the card, and each
    mutation's instructions and cells written (``MutationStats``). No
    kernel launches; every plane of each mutated relation stays on the
    card. With ``profile`` the call runs under cProfile (its wall then
    includes the profiler's overhead) and the functions with the most own
    time are printed after the row."""
    import cProfile
    import pstats
    from repro_torch.core import engine as eng
    names = {m.relation for m in mutations}
    n_stats = {n: len(db.dml_state(n).stats) for n in names}
    reset_launches()
    up = eng.upload_bytes
    prof = cProfile.Profile() if profile else None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if prof:
        prof.enable()
    stats = db.apply(mutations)
    torch.cuda.synchronize()
    if prof:
        prof.disable()
    wall = (time.perf_counter() - t0) * 1e3
    if any(read_launches().values()):
        fail(f"path g {label}: db.apply launched {read_launches()}")
    for n in names:
        rel = db.relations[n]
        if not (rel.valid.is_cuda
                and all(p.is_cuda for p in rel.planes.values())):
            fail(f"path g {label}: a plane of {n} left the card")
    muts = "; ".join(f"{st.op} {st.n_rows} rows {st.n_instructions} instrs "
                     f"{st.cells_written} cells"
                     for n in sorted(names)
                     for st in db.dml_state(n).stats[n_stats[n]:])
    total = sum(e["n_instructions"] for e in stats.values())
    cells = sum(e["cells_written"] for e in stats.values())
    print(f"{label:24s} {wall:10.3f} {eng.upload_bytes - up:14d} "
          f"{total:7d} {cells:13d}   {muts}", flush=True)
    if prof:
        st = pstats.Stats(prof)
        top = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:8]
        print(f"  host profile of {label} (cProfile on): total "
              f"{st.total_tt * 1e3:.1f} ms; " + "; ".join(
                  f"{Path(f).name}:{ln}:{fn} {tt * 1e3:.1f} ms"
                  for (f, ln, fn), (_, _, tt, _, _) in top), flush=True)
    rows.append({"label": label, "ms": wall,
                 "bytes": eng.upload_bytes - up, "cells": cells})


def htap_fused(db, spec, label) -> object:
    """``spec`` on FUSED against ORACLE (aggregates, selected-record
    counts; for a host-stage spec its rows and materialized counts), with
    ``fused_program`` launched once per relation program and
    ``materialize`` once per ``Materialize``. Returns the result and its
    launches."""
    from repro_torch.db import database as D
    from repro_torch.db import exec as E
    reset_launches()
    got = db.execute(spec)
    torch.cuda.synchronize()
    launches = read_launches()
    want = dict.fromkeys(launches, 0)
    if spec.host is not None:
        n = len(E.split_query(spec)[0])
        want.update(fused_program=n, materialize=n)
    else:
        want.update(fused_program=len(spec.filters))
    if launches != want:
        fail(f"path g {label} {spec.name}: launches {launches}, expected "
             f"{want}")
    oracle = db.execute(spec, engine=D.Engine.ORACLE)
    if spec.host is not None:
        ok = (got.rows == oracle.rows
              and got.materialized_rows == oracle.materialized_rows)
    else:
        ok = got.aggregates == oracle.aggregates and all(
            int(got.relations[r].mask.sum())
            == int(oracle.relations[r].mask.sum()) for r in spec.filters)
    if not ok:
        fail(f"path g {label}: {spec.name} on FUSED != ORACLE")
    return got, launches


def phase_htap_stream(tables, flush, peaks):
    """Path g: the HTAP stream of ``benchmarks/bench_kernels.py::
    bench_htap_stream`` on the card, on a fresh ``PimDatabase(tables)``
    over path a's SF 1 tables. Returns the path's fused_program record,
    its materialize and eq_imm/cmp_imm launches and its worst diffs."""
    from repro_torch.core import bitslice
    from repro_torch.core import program as prog
    from repro_torch.db import database as D
    from repro_torch.db import exec as E
    from repro_torch.db import queries as Q
    from repro_torch.db.compiler import Compiler
    from repro_torch.dml import (Compact, Delete, Insert, MutableTable,
                                 Update, replay)

    db = D.PimDatabase(tables)
    verify_compile_timing(db)
    d = db.dml_state("lineitem")
    n0 = d.rel.n_records
    cap0 = d.capacity
    spec1, spec6, spec14 = (Q.get_query(n) for n in ("Q1", "Q6", "Q14"))
    q1, q6 = spec1.filter_only(), spec6.filter_only()
    oracle = MutableTable(tables["lineitem"])
    src = {a: np.asarray(c) for a, c in tables["lineitem"].items()}
    rng = np.random.default_rng(7)
    launches = dict.fromkeys(read_launches(), 0)
    rows, prev = [], []
    print(f"path g: lineitem {n0} records, {d.rel.layout.n_words} words a "
          f"plane, {cap0 - n0} spare slots, row_bits "
          f"{d.rel.layout.row_bits}; {HTAP_ROUNDS} rounds of "
          f"{HTAP_BATCH} rows", flush=True)
    print("mutation                    wall_ms  bytes_to_card  instrs "
          "cells_written   per mutation")

    def count(got):
        for k, v in got.items():
            launches[k] += v

    for r in range(HTAP_ROUNDS):
        miss0 = prog.program_cache_stats()["misses"]
        idx = rng.integers(0, n0, HTAP_BATCH)
        batch = {a: c[idx] for a, c in src.items()}
        muts = [Insert("lineitem", batch)]
        if prev:
            muts.append(Delete("lineitem", row_ids=prev))
        htap_apply(db, f"round {r + 1} insert+delete", muts, rows,
                   profile=r == HTAP_ROUNDS - 1)
        new_ids = oracle.insert(batch)
        if prev:
            oracle.delete(row_ids=prev)
        prev = new_ids
        r1, l1 = htap_fused(db, q1, f"round {r + 1}")
        r6, l6 = htap_fused(db, q6, f"round {r + 1}")
        count(l1)
        count(l6)
        print(f"  round {r + 1}: Q1 execute {r1.wall_s * 1e3:.3f} ms, Q6 "
              f"{r6.wall_s * 1e3:.3f} ms (FUSED, the first after the "
              "apply)", flush=True)
        exp = oracle.aggregate(spec6.filters["lineitem"], spec6.aggregates)
        if tuple(r6.aggregates["all"][a.name]
                 for a in spec6.aggregates) != exp:
            fail(f"path g round {r + 1}: Q6 != MutableTable {exp}")
        misses = prog.program_cache_stats()["misses"] - miss0
        if r and misses:
            fail(f"path g round {r + 1}: {misses} tape-cache misses within "
                 "capacity")
    leveled = d.segments.busiest_row_ops()
    unleveled = replay(d.segments.events,
                       bitslice.pad_words(n0) * bitslice.WORD_BITS, n0,
                       "first_fit").busiest_row_ops()
    if leveled > 0.5 * unleveled:
        fail(f"path g: rotate's busiest row {leveled} > 0.5 x first-fit's "
             f"{unleveled}")

    htap_apply(db, "update l_quantity=7",
               [Update("lineitem", {"l_quantity": 7},
                       pred=spec6.filters["lineitem"])], rows)
    oracle.update({"l_quantity": 7}, pred=spec6.filters["lineitem"])
    spare = d.capacity - len(d.slot_of)
    words0 = d.rel.layout.n_words
    idx = rng.integers(0, n0, HTAP_GROW)
    grow = {a: c[idx] for a, c in src.items()}
    htap_apply(db, f"insert {HTAP_GROW} (grow)",
               [Insert("lineitem", grow)], rows)
    oracle.insert(grow)
    if d.segments.grown_tiles != 1 or \
            d.rel.layout.n_words != bitslice.pad_words(n0) + \
            bitslice.TILE_WORDS:
        fail(f"path g: {HTAP_GROW} rows into {spare} spare slots grew "
             f"{d.segments.grown_tiles} tiles to {d.rel.layout.n_words} "
             "words, expected one tile")

    miss0 = prog.program_cache_stats()["misses"]
    r6, l6 = htap_fused(db, q6, "after growth")
    grow_misses = prog.program_cache_stats()["misses"] - miss0
    r14, l14 = htap_fused(db, spec14, "after growth")
    count(l6)
    count(l14)
    exp = oracle.aggregate(spec6.filters["lineitem"], spec6.aggregates)
    if tuple(r6.aggregates["all"][a.name] for a in spec6.aggregates) != exp:
        fail(f"path g after growth: Q6 != MutableTable {exp}")
    reset_launches()
    e6 = db.execute(q6, engine="eager")
    torch.cuda.synchronize()
    le = read_launches()
    (_, _, instrs), = eager_programs(db, [q6], [])
    want_eq, want_cmp = imm_predicates(instrs)
    want = dict.fromkeys(le, 0)
    want.update(eq_imm=want_eq, cmp_imm=want_cmp)
    if le != want:
        fail(f"path g: eager Q6 launched {le}, expected {want}")
    count(le)
    if not (e6.aggregates == r6.aggregates
            == db.execute(q6, engine=D.Engine.ORACLE).aggregates):
        fail("path g: eager Q6 != FUSED/ORACLE")

    # Kernels against plain at path g's shapes (after growth, holes in
    # the valid plane): Q6's and Q14's programs, Q14's Materializes and
    # the eager Q6's operands.
    record = {"launches": 0, "max_abs_err": 0, "progs": []}
    q6_progs = programs(db, [q6])
    for _, rel_, cp in q6_progs:
        record["progs"].append(fused_timing(cp, rel_, flush))
    mat_worst = 0
    for rel_name, pred, cols in E.split_query(spec14)[0]:
        rel_ = db.relations[rel_name]
        c = Compiler(rel_)
        m = (c.compile_filter(pred, with_transform=False)
             if pred is not None else c.compile_scan_all())
        c.compile_materialize(m, cols)
        cp = prog.compile_program(rel_, c.program, mask_outputs=())
        record["progs"].append(fused_timing(cp, rel_, flush))
        planes, mask = materialize_inputs(rel_, cp, c.program[-1])
        diff, _ = check_materialize(f"path g Q14/{rel_name}", planes, mask)
        mat_worst = max(mat_worst, diff)
    eager_worst, n_ops, _, _ = check_eager_operands(
        eager_programs(db, [q6], []))
    record["max_abs_err"] = max(p["diff"] for p in record["progs"])

    htap_apply(db, "compact", [Compact("lineitem")], rows)
    r6c, l6c = htap_fused(db, q6, "after compact")
    count(l6c)
    exp = oracle.aggregate(spec6.filters["lineitem"], spec6.aggregates)
    if tuple(r6c.aggregates["all"][a.name]
             for a in spec6.aggregates) != exp:
        fail(f"path g after compact: Q6 != MutableTable {exp}")
    record["launches"] = launches["fused_program"]

    rep = db.report(r6c)
    print(f"path g wear: rotate's busiest row {leveled:.0f} cell writes "
          f"after the stream, first-fit replay {unleveled:.0f} (ratio "
          f"{leveled / unleveled:.4f} <= 0.5); after the update, growth "
          f"and compact {d.segments.busiest_row_ops():.0f}", flush=True)
    print(f"path g report (Q6 after compact, sf_scale 1): bytes_resident "
          f"{rep.bytes_resident}, bytes_reserved {rep.bytes_reserved}, "
          f"dml_row_ops {rep.dml_row_ops:.0f}, endurance "
          f"{rep.endurance_ops_per_cell_10y:.6g} ops/cell for 10 years; "
          f"lineitem {words0} -> {db.relations['lineitem'].layout.n_words} "
          f"words, watermark {db.relations['lineitem'].n_records}",
          flush=True)
    print(f"phase 4g ok: {HTAP_ROUNDS} rounds of insert {HTAP_BATCH} + "
          f"delete at SF {MAIN_SF}, Q6 == MutableTable and Q1 == ORACLE "
          f"every round, no tape-cache miss after round 1 (Q6 after the "
          f"growth: {grow_misses}); update, growth past {spare} spare "
          f"slots, Q6/"
          f"Q14 FUSED and Q6 EAGER == ORACLE, compact, Q6 == MutableTable; "
          f"launches {launches}; fused_program == plain on "
          f"{len(record['progs'])} programs, materialize on 2, eq/cmp/"
          f"range on {n_ops} operands; {len(rows)} db.apply calls moved "
          f"{sum(r['bytes'] for r in rows)} bytes to the card", flush=True)
    return record, launches, mat_worst, eager_worst


# Path h: the query service (the bench_serve trace of
# benchmarks/bench_kernels.py): 4 waves of 8 requests at concurrency 8.
SERVE_WAVE = ("Q1", "Q6", "Q14", "Q3", "Q12", "Q19", "Q6", "Q1")
SERVE_WAVES, SERVE_CONC, SERVE_WARM = 4, 8, 3


def served_equal(label, specs, results, path_a, path_b) -> None:
    """Each served result's rows and aggregates equal the same spec's
    sequential FUSED result of path a or b and its ORACLE result."""
    for spec, got in zip(specs, results):
        src = path_b if spec.host is not None else path_a
        for want in (src["results"][spec.name], src["oracle"][spec.name]):
            if got.rows != want.rows or got.aggregates != want.aggregates:
                fail(f"path h {label}: {spec.name} served != sequential "
                     f"FUSED / ORACLE ({want.engine.value})")


def serve_launch_check(label, specs, stats, launches) -> None:
    """A replay through a fresh service dispatches every distinct spec of
    its trace once (repeats coalesce or hit the cache): ``fused_program``
    once per relation of each window (the service's ``dispatches``),
    ``materialize`` once per ``Materialize`` of a dispatched host-stage
    spec, nothing else."""
    from repro_torch.db import exec as E
    distinct = {s.name: s for s in specs}
    if stats["batcher"]["items"] != len(distinct):
        fail(f"path h {label}: {stats['batcher']['items']} requests "
             f"dispatched for {len(distinct)} distinct specs")
    want = dict.fromkeys(launches, 0)
    want["fused_program"] = stats["dispatches"]
    want["materialize"] = sum(len(E.split_query(s)[0])
                              for s in distinct.values()
                              if s.host is not None)
    if launches != want:
        fail(f"path h {label}: launches {launches}, expected {want}")


def print_serve_row(label, n, stats, wall, seq_wall) -> None:
    lat = stats["latency_ms"]
    print(f"{label:14s} {n:4d} {wall * 1e3:10.3f} {n / wall:9.3f} "
          f"{n / seq_wall:9.3f} {lat['p50']:9.3f} {lat['p99']:9.3f} "
          f"{stats['dispatches']:5d} {stats['plane_reads']:6d} "
          f"{stats['cache']['hits']:5d} {stats['coalesced']:5d} "
          f"{stats['batcher']['windows']:5d}", flush=True)


def fault_service_scenarios(tables, path_a) -> dict:
    """``tests/test_faults.py``'s two service scenarios on the card, on a
    fresh database over ``tables``: one transient dispatch fault retried
    once; two that exhaust the retries, trip the breaker and degrade two
    windows to EAGER on the card, then a half-open FUSED probe after a
    one-row insert closes it. Counters equal the reference's, results
    equal ORACLE; the retried window launches ``fused_program`` once, the
    degraded windows only ``eq_imm``/``cmp_imm``. Returns the launches."""
    import asyncio
    from repro_torch import dml
    from repro_torch.db import database as D
    from repro_torch.db import queries as Q
    from repro_torch.faults import CircuitBreaker, FaultManager, RetryPolicy
    from repro_torch.serve import QueryService

    fdb = D.PimDatabase(tables)
    q6, q1 = (Q.get_query(n).filter_only() for n in ("Q6", "Q1"))
    total = dict.fromkeys(read_launches(), 0)

    fm = FaultManager(fdb)

    async def retry():
        async with QueryService(fdb, max_wait_s=0.001,
                                fault_manager=fm) as svc:
            fm.model.inject_dispatch_faults(1)
            return await svc.submit(q6), svc

    reset_launches()
    r, svc = asyncio.run(asyncio.wait_for(retry(), 600))
    launches = read_launches()
    got = (svc.n_transient_faults, svc.n_retries, svc.n_fault_recovered,
           svc.n_errors, fm.breaker.state)
    if got != (1, 1, 1, 0, "closed") or \
            r.aggregates != path_a["oracle"]["Q6"].aggregates:
        fail(f"path h retry: (transient, retries, recovered, errors, "
             f"breaker) {got}, expected (1, 1, 1, 0, 'closed'), or Q6 != "
             "ORACLE")
    if launches != {**dict.fromkeys(launches, 0), "fused_program": 1}:
        fail(f"path h retry: launches {launches}")
    for k, v in launches.items():
        total[k] += v
    print(f"path h retry: transient {got[0]}, retries {got[1]}, recovered "
          f"{got[2]}, errors {got[3]}, breaker {got[4]}; Q6 == ORACLE; "
          f"launches {launches}", flush=True)

    fm = FaultManager(fdb, retry=RetryPolicy(max_retries=1,
                                             base_delay_s=0.0),
                      breaker=CircuitBreaker(failure_threshold=1,
                                             cooldown_windows=2))
    take = {a: np.asarray(c[:1]) for a, c in tables["lineitem"].items()}

    async def degrade():
        async with QueryService(fdb, max_wait_s=0.001,
                                fault_manager=fm) as svc:
            fm.model.inject_dispatch_faults(2)
            r6 = await svc.submit(q6)
            r1 = await svc.submit(q1)
            await svc.apply([dml.Insert("lineitem", take)])
            r6b = await svc.submit(q6)
            return r6, r1, r6b, svc

    want_eq = want_cmp = 0
    for _, _, instrs in eager_programs(fdb, [q6, q1], []):
        eq, cmp = imm_predicates(instrs)
        want_eq, want_cmp = want_eq + eq, want_cmp + cmp
    reset_launches()
    t0 = time.perf_counter()
    r6, r1, r6b, svc = asyncio.run(asyncio.wait_for(degrade(), 600))
    wall = time.perf_counter() - t0
    launches = read_launches()
    st = svc.stats()
    got = (svc.n_errors, svc.n_degraded_windows, svc.n_fault_recovered,
           st["breaker"])
    want = (0, 2, 2, {"state": "closed", "trips": 1, "recoveries": 1})
    if got != want:
        fail(f"path h degrade: (errors, degraded, recovered, breaker) {got},"
             f" expected {want}")
    if (r6.engine, r1.engine, r6b.engine) != (D.Engine.EAGER,) * 2 + (
            D.Engine.FUSED,):
        fail("path h degrade: the degraded windows did not run EAGER or the "
             "probe not FUSED")
    if r6.aggregates != path_a["oracle"]["Q6"].aggregates or \
            r1.aggregates != path_a["oracle"]["Q1"].aggregates or \
            r6b.aggregates != fdb.execute(q6, engine=D.Engine.ORACLE
                                          ).aggregates:
        fail("path h degrade: a result != ORACLE")
    want_l = {**dict.fromkeys(launches, 0), "fused_program": 1,
              "eq_imm": want_eq, "cmp_imm": want_cmp}
    if launches != want_l:
        fail(f"path h degrade: launches {launches}, expected {want_l}")
    for k, v in launches.items():
        total[k] += v
    print(f"path h degrade: errors {got[0]}, degraded windows {got[1]}, "
          f"recovered {got[2]}, breaker {got[3]}; EAGER Q6, Q1 and the FUSED "
          f"probe == ORACLE; launches {launches}; {wall:.3f} s", flush=True)
    return total


def phase_query_service(db, path_a, path_b) -> dict:
    """Path h: ``QueryService`` over path a's database on the card (the
    bench_serve trace, then ``DEFAULT_TRACE`` with ``--compare``'s
    parity, then the fault manager's two service scenarios). Returns the
    path's launches."""
    from repro_torch.db import queries as Q
    from repro_torch.launch import serve as launch

    t_path = time.perf_counter()
    trace = [Q.get_query(n) for n in SERVE_WAVE * SERVE_WAVES]
    for name in set(SERVE_WAVE):
        db.execute(Q.get_query(name))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq = [db.execute(s) for s in trace]
    torch.cuda.synchronize()
    seq_wall = time.perf_counter() - t0
    served_equal("sequential loop", trace, seq, path_a, path_b)
    total = dict.fromkeys(read_launches(), 0)
    print(f"path h: {len(trace)} requests ({SERVE_WAVES} x "
          f"{'/'.join(SERVE_WAVE)}), concurrency {SERVE_CONC}, max_window "
          f"{SERVE_CONC}, max_wait 2 ms, max_pending {SERVE_CONC}, a fresh "
          f"QueryService per replay; sequential execute loop "
          f"{seq_wall * 1e3:.3f} ms", flush=True)
    print("replay            n    wall_ms       qps   seq_qps   p50_ms    "
          "p99_ms  disp  reads  hits  coal  wins")
    for i in range(1 + SERVE_WARM):
        label = "cold" if i == 0 else f"warm {i}"
        reset_launches()
        results, stats, wall = launch.serve_trace(
            db, trace, concurrency=SERVE_CONC, max_window=SERVE_CONC,
            max_wait_s=0.002)
        torch.cuda.synchronize()
        launches = read_launches()
        served_equal(label, trace, results, path_a, path_b)
        if stats["errors"] or stats["completed"] != len(trace):
            fail(f"path h {label}: {stats['errors']} errors, "
                 f"{stats['completed']} of {len(trace)} completed")
        serve_launch_check(label, trace, stats, launches)
        for k, v in launches.items():
            total[k] += v
        print_serve_row(label, len(trace), stats, wall, seq_wall)

    specs = launch.parse_trace(launch.DEFAULT_TRACE)
    reset_launches()
    results, stats, wall = launch.serve_trace(db, specs)
    torch.cuda.synchronize()
    launches = read_launches()
    serve_launch_check("DEFAULT_TRACE", specs, stats, launches)
    for k, v in launches.items():
        total[k] += v
    t0 = time.perf_counter()
    seq = [db.execute(s) for s in specs]
    torch.cuda.synchronize()
    seq_wall = time.perf_counter() - t0
    mismatched = [s.name for s, r, q in zip(specs, results, seq)
                  if r.rows != q.rows or r.aggregates != q.aggregates]
    if mismatched:
        fail(f"path h DEFAULT_TRACE: service != sequential for {mismatched}")
    served_equal("DEFAULT_TRACE", specs, results, path_a, path_b)
    print_serve_row("DEFAULT_TRACE", len(specs), stats, wall, seq_wall)
    print(f"path h DEFAULT_TRACE: service {wall * 1e3:.3f} ms, sequential "
          f"execute loop {seq_wall * 1e3:.3f} ms -> speedup "
          f"{seq_wall / wall:.2f}x (bit-parity ok)", flush=True)

    for k, v in fault_service_scenarios(db.tables, path_a).items():
        total[k] += v
    print(f"phase 4h ok: {1 + SERVE_WARM} replays of {len(trace)} and one of "
          f"{len(specs)} requests == sequential FUSED and ORACLE; fault "
          f"scenarios' counters == the reference's; launches {total}; "
          f"{time.perf_counter() - t_path:.1f} s", flush=True)
    return total


def chaos_launch_check(label, rep, launches) -> None:
    """A soak launches ``fused_program`` once per FUSED dispatch (Q1 and
    Q6 touch lineitem alone), ``eq_imm``/``cmp_imm`` only in its degraded
    windows, nothing else (its writes, scrubs and repairs are torch ops)."""
    want = dict.fromkeys(launches, 0)
    want.update(fused_program=rep["dispatches"], eq_imm=launches["eq_imm"],
                cmp_imm=launches["cmp_imm"])
    if launches != want or \
            (launches["eq_imm"] + launches["cmp_imm"] > 0) != \
            (rep["degraded_windows"] > 0):
        fail(f"path i {label}: launches {launches} for "
             f"{rep['dispatches']} dispatches and "
             f"{rep['degraded_windows']} degraded windows")


CHAOS_COUNTERS = ("ok", "parity", "all_detected", "injected",
                  "detected_injected", "detect_latency_rounds",
                  "write_faults", "worn_dead", "repaired_rows",
                  "remapped_rows", "retired_slots", "scrubs", "dispatches",
                  "transient_faults", "retries", "degraded_windows",
                  "recovered_queries", "breaker_state", "breaker_trips",
                  "breaker_recoveries", "wall_s", "qps")


def phase_chaos_soak() -> dict:
    """Path i: ``faults.chaos.run_chaos`` on the card, at sf 0.005 (its
    counters == ``benchmarks/baseline.json``'s ``chaos_soak``) and at SF 1
    (every injected fault detected, parity, the breaker closed after one
    trip and one recovery), with each scrub's wall and the bytes each
    scrub and each verify-after-write copied off the card. Returns the
    path's launches."""
    from repro_torch.faults import chaos
    t_path = time.perf_counter()
    base = json.loads((Path(__file__).resolve().parent
                       / "benchmarks/baseline.json").read_text())
    meta = base["rows"]["chaos_soak"]["meta"]
    total = dict.fromkeys(read_launches(), 0)

    reset_launches()
    t0 = time.perf_counter()
    rep = chaos.run_chaos(sf=base["sf"], device="cuda")
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    launches = read_launches()
    names = {"detected": "detected_injected"}
    keys = ("injected", "detected", "detect_latency_rounds", "write_faults",
            "worn_dead", "remapped_rows", "repaired_rows", "dispatches",
            "transient_faults", "retries", "degraded_windows",
            "recovered_queries", "breaker_trips", "breaker_recoveries")
    got = {k: rep[names.get(k, k)] for k in keys}
    want = {k: meta[k] for k in keys}
    if not rep["ok"] or got != want or rep["breaker_state"] != "closed" \
            or (rep["rounds"], rep["batch"]) != (meta["rounds"],
                                                 meta["batch"]):
        fail(f"path i sf {base['sf']}: report {got} (ok {rep['ok']}, "
             f"breaker {rep['breaker_state']}, violations "
             f"{rep['violations']}) != baseline.json's chaos_soak {want}")
    chaos_launch_check(f"sf {base['sf']}", rep, launches)
    for k, v in launches.items():
        total[k] += v
    print(f"path i sf {base['sf']}: report == baseline.json's chaos_soak "
          f"({', '.join(f'{k} {v}' for k, v in got.items())}), breaker "
          f"closed; soak {rep['wall_s']:.3f} s, call {call_s:.3f} s; "
          f"launches {launches}", flush=True)

    from repro_torch.faults import guard
    managers = []
    spent = dict.fromkeys(("apply", "publish", "dispatch_batch",
                           "_execute_one", "run_baseline"), 0.0)

    def watch(fm):
        """Time the database calls of the soak (on the instance: the
        service, the manager and the soak call these names)."""
        managers.append(fm)
        for name in spent:
            fn = getattr(fm.db, name)

            def timed(*a, _fn=fn, _name=name, **k):
                t = time.perf_counter()
                try:
                    return _fn(*a, **k)
                finally:
                    spent[_name] += time.perf_counter() - t
            setattr(fm.db, name, timed)

    reset_launches()
    bytes0 = guard.readback_bytes
    t0 = time.perf_counter()
    rep = chaos.run_chaos(sf=MAIN_SF, device="cuda", on_manager=watch)
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0
    launches = read_launches()
    fm, = managers
    if not (rep["ok"] and rep["parity"] and rep["all_detected"]
            and rep["detected_injected"] == rep["injected"] == 4
            and rep["breaker_state"] == "closed"
            and (rep["breaker_trips"], rep["breaker_recoveries"]) == (1, 1)):
        fail(f"path i SF {MAIN_SF}: {rep}")
    chaos_launch_check(f"SF {MAIN_SF}", rep, launches)
    for k, v in launches.items():
        total[k] += v
    print(f"path i SF {MAIN_SF}: " + ", ".join(
        f"{k} {rep[k]}" for k in CHAOS_COUNTERS) + f"; call {call_s:.3f} s "
        f"(tables generated inside); launches {launches}", flush=True)
    print(f"path i SF {MAIN_SF} scrubs (wall_ms / bytes off the card): "
          + "; ".join(f"{w * 1e3:.3f} / {b}" for w, b in fm.scrub_log),
          flush=True)
    scrub_s = sum(w for w, _ in fm.scrub_log)
    rest = rep["wall_s"] - scrub_s - sum(
        v for k, v in spent.items() if k != "publish")
    print(f"path i SF {MAIN_SF} soak {rep['wall_s']:.3f} s by call: "
          f"db.apply {spent['apply']:.3f} s, scrubs {scrub_s:.3f} s "
          f"(publish inside both: {spent['publish']:.3f} s), FUSED "
          f"dispatch_batch {spent['dispatch_batch']:.3f} s, degraded EAGER "
          f"queries {spent['_execute_one']:.3f} s, numpy Q1 baseline "
          f"{spent['run_baseline']:.3f} s, the rest (MutableTable oracle, "
          f"service, wear) {rest:.3f} s", flush=True)
    wc = fm.write_check_bytes
    print(f"path i SF {MAIN_SF} verify-after-write: {len(wc)} write "
          f"programs, bytes off the card {sum(wc)} in all, {min(wc)} to "
          f"{max(wc)} each ({sorted(set(wc))}); the integrity layer copied "
          f"{guard.readback_bytes - bytes0} bytes off the card in all",
          flush=True)
    print(f"phase 4i ok: chaos soak at sf {base['sf']} == baseline.json and "
          f"at SF {MAIN_SF} ok with all {rep['injected']} faults detected; "
          f"launches {total}; {time.perf_counter() - t_path:.1f} s",
          flush=True)
    return total


def lint_on_card() -> None:
    """``repro_torch.analysis.lint`` with its database and DML writes on
    the card, at SF 0.002: it prints its totals; 0 errors or the run
    fails."""
    from repro_torch.analysis import lint
    if lint.lint(sf=0.002, device="cuda"):
        fail("repro_torch.analysis.lint on the card found errors")


def phase_cost_model(db, fused, eager) -> None:
    """``db.report`` of the 19 specs at ``sf_scale`` 1000 (SF 1 -> 1000).
    The numbers are the paper's analytical PIM model, not times of this
    card. Both engines record the compiled program as their trace, so the
    FUSED and EAGER reports differ only through the masks' selectivities,
    which path d found equal: their equality checks that ``db.report``
    reads nothing engine-specific, not the eager engine itself."""
    import dataclasses
    from repro_torch.db import queries as Q
    scale = 1000 / MAIN_SF
    print(f"Paper-scale projection (SF {MAIN_SF} x {scale:g}), the paper's "
          "analytical PIM model (Table 3/4 constants), NOT times measured "
          "on this card:")
    print("query     cycles  pim_ms  read_ms  baseline_ms  speedup  "
          "read_reduction  energy_saving  endurance_10y")
    for spec in (q.filter_only() for q in Q.all_queries()):
        rf = db.report(fused[spec.name], sf_scale=scale)
        re_ = db.report(eager[spec.name], sf_scale=scale)
        if dataclasses.asdict(rf) != dataclasses.asdict(re_):
            fail(f"{spec.name}: FUSED cost report {rf} != EAGER {re_}")
        print(f"{spec.name:8s} {rf.cycles['total']:8d} "
              f"{rf.pim_time_s * 1e3:7.3f} {rf.read_time_s * 1e3:8.3f} "
              f"{rf.baseline_time_s * 1e3:12.3f} {rf.speedup:8.2f} "
              f"{rf.read_reduction:15.1f} {rf.energy_saving:14.2f} "
              f"{rf.endurance_ops_per_cell_10y:14.3g}", flush=True)
    print("cost model ok: FUSED and EAGER reports equal for 19 specs (same "
          "traces; masks equal by path d)", flush=True)

def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an "
             "NVIDIA GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}",
          flush=True)

    t0 = time.perf_counter()
    libs = build.build_library()
    print(f"phase 2 ok: built {', '.join(sorted(libs))} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for lib in libs.values():
        print(lib.with_suffix(".log").read_text().strip(), flush=True)

    worst = phase_kernel_vs_plain()
    mat_worst, col_worst = phase_new_kernels_vs_plain()
    filt_worst = phase_filter_kernels_vs_plain()
    peaks = peak_ops_per_s()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    floor = timing_floor(flush)
    db, path_a = phase_main_path(peaks, flush)
    path_b, mat = phase_host_path(db, peaks, flush)
    cols = phase_column_transform(db, peaks, flush)
    eager_launches, eager_worst, eager = phase_eager_path(
        db, path_a["results"], peaks, flush, floor)
    api = phase_kernel_api(db, peaks, flush)
    path_f, mat_f = phase_linked_batches(db, path_a, path_b, flush)
    print_fused_total(f"the {len(path_f['progs'])} linked programs of path f",
                      path_f["progs"], peaks)
    path_g, g_launches, g_mat_worst, g_eager_worst = phase_htap_stream(
        db.tables, flush, peaks)
    print_fused_total(f"the {len(path_g['progs'])} programs of path g "
                      "(after growth)", path_g["progs"], peaks)
    lint_on_card()
    h_launches = phase_query_service(db, path_a, path_b)
    i_launches = phase_chaos_soak()
    phase_cost_model(db, path_a["results"], eager)
    fused = fused_entry([path_a, path_b, path_f, path_g], peaks)
    fused["max_abs_err"] = max(worst, fused["max_abs_err"])
    fused["launches"] += h_launches["fused_program"] + \
        i_launches["fused_program"]
    mat["launches"] += mat_f + g_launches["materialize"] + \
        h_launches["materialize"] + i_launches["materialize"]
    mat["max_abs_err"] = max(mat_worst, mat["max_abs_err"], g_mat_worst)
    for c in cols:
        c["launches"] += (g_launches[c["name"]] + h_launches[c["name"]]
                          + i_launches[c["name"]])
        c["max_abs_err"] = max(col_worst, c["max_abs_err"])
    for a in api:
        a["launches"] += (eager_launches[a["name"]] + g_launches[a["name"]]
                          + h_launches[a["name"]] + i_launches[a["name"]])
        a["max_abs_err"] = max(
            a["max_abs_err"], filt_worst["filter_sum"]
            if a["name"] == "filter_sum" else max(filt_worst["filter"],
                                                  eager_worst,
                                                  g_eager_worst))
    print(json.dumps({"kernels": [fused, mat, *cols, *api]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
