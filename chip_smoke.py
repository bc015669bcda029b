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
      EAGER against ORACLE, kernels == plain at those shapes; then, on a
      fresh sf 0.05 database (Compact at SF 1 took 41-57 s, host work),
      two rounds of insert 64 + delete, ``Compact`` and Q6 against the
      mutable table. ``db.apply`` launches nothing and keeps every
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
   j. record-sharded relations: ``PimDatabase(tables, mesh=make_mesh((2,
      4), ("pod", "data"), device="cuda"))`` over a.'s tables, every
      relation split 8 ways on the one card (lineitem 23,552 words a
      shard). a.'s 21 specs (masks bit-equal, aggregates equal) and the
      six host specs (rows, columns, materialized counts) equal a.'s and
      b.'s single-device results, ``Qavg_empty`` gives None;
      ``fused_program`` launches once per relation program and shard,
      ``materialize`` once per ``Materialize`` and shard. Q1+Q6+Q14+Q19
      linked: ``n_dispatches`` 2, each result equal. The 5-request service
      smoke (``max_window`` 3, ``max_wait_s`` 0.005): 0 errors, 2
      coalesced, results equal. Q6 on EAGER (the gathered view) equals
      FUSED; ``distributed_filter_aggregate`` over lineitem (``cmp_imm``
      on each shard) equals numpy. Each shard's ``fused_program`` and
      ``materialize`` equal their plain versions at SF 1's shard shape
      and on an sf 0.002 mesh database (128 words a shard, shards of
      padding only, a selection of nothing), whose 27 specs equal
      ORACLE. A host profile of Q6 on the mesh. A table per query:
      execute_ms on the mesh against single-device (one warm call each,
      mesh then single; four turns until PR 25, cut for path m's time),
      the shards' card time in turn on one stream against
      the single launch, each side's summed bound, launches. One DML
      round (insert 32, delete 16, update 32 on lineitem), then Q6 equal
      to the mutable table and lineitem sharded again. Where there are
      two or more cards, a mesh over them too; else a line says it was
      not run.
   Then ``repro_torch.examples.tpch_analytics`` at sf 0.01 on the card:
   every row it prints verified; then
   ``repro_torch.examples.analytics_guided_serving``: its admission
   filter over 50,000 bit-sliced requests (``eq_imm``/``cmp_imm`` on the
   card) equal to numpy's count, its qwen2 smoke batch decoded (4, 13).
   k. The LM serving path (``repro_torch.models``, ``launch.serve``), each
      architecture built with bf16 weights from a seeded generator, used
      and freed before the next; one line each: layers run, parameter
      bytes, seconds, tok/s, the gaps below and the card's name and power
      limit. k1: ``serve(qwen2-0.5b, batch=4, prompt_len=1, gen_len=16)``
      at full width and depth, twice (cold, warm; the same tokens): shape
      (4, 17), ids in [0, vocab); teacher-forced decode of the sequence
      against ``forward`` within the reference's bf16 tolerance
      max(0.01 x max|logits|, 0.25). k2: those weights in float32 (TF32
      off), on a (2, 16) batch: decode against forward on the card, then
      forward and 4 greedy decode steps on the card against the CPU, each
      within 1e-3 x max(1, max|logits|), the same greedy tokens. k3: every
      other block pattern at full width, cut in depth (gemma2-9b 2 layers,
      olmoe-1b-7b 2, paligemma-3b 2 with its 256 vision-stub tokens,
      qwen1.5-0.5b 2, stablelm-3b 2, whisper-small 12 + 12 encoding 64
      frames, xlstm-1.3b 8, zamba2-7b 7): forward on (2, 16), 16
      teacher-forced and 16 greedy decode steps, finite logits; for the
      dense and gemma2 patterns the bf16 decode-forward gap is printed
      beside that tolerance and the float32 gap must meet 1e-3 x max(1,
      max|logits|) (at gemma2's head width the reference's own bf16 gap
      exceeds the smoke tolerance: ``tests/test_torch_lm.py::
      test_bf16_decode_gap_at_gemma2_head_width``); then k2's card-against-
      CPU check in float32. llama4-maverick runs in path m3 (one MoE layer
      alone is 32 GB in bf16: it is served on a mesh with its experts
      over ``model``). No kernel of the table runs on path k.
   l. The LM training path (``launch.train``, ``launch.steps``, ``optim``,
      ``checkpoint``, ``data.pipeline``). l1: ``PimDataSelector`` over
      ``CorpusMeta.synthetic(10_000_000, seed=0)`` on the card (47 planes
      x 312,500 words), its admission equal to ``queries.eval_pred`` bit
      for bit, its times and launches; ``train()`` on qwen2-0.5b at full
      width and depth (bf16, remat, AdamW, seeded random weights) at
      batch 4 x 512 for 8 steps, loss and grad norm finite every step,
      ms a step, tok/s and ``max_memory_allocated``; a 4-step run saved
      blocking and restored, every leaf of the parameters and the AdamW
      state bit for bit (seconds, bytes on disk); a run resumed from it
      to step 8 within rtol 2e-4 of the uninterrupted losses. l2: the
      example's lm-12m in float32 at batch 8 x 256, 3 ``train()`` steps
      on the card (an async checkpoint every step, the last restored bit
      for bit) and on the CPU from one seed's weights: losses and grad
      norms within 1e-4 relative, parameters within 1e-4 x max(1,
      max|p|); then one AdamW step of olmoe, gemma2, xlstm, zamba2,
      whisper and paligemma at full width with path k's depth cuts, and
      one Adafactor step at llama4-maverick's smoke size, loss, grad norm
      and parameters finite, each step's time. Only ``eq_imm`` and
      ``cmp_imm`` launch (the admissions), then they are held against
      their plain versions at l1's shapes.
   m. The mesh and dry-run tooling (``launch.mesh``, ``launch.steps``'
      sharded steps, ``distributed.sharding``/``sharded_steps``/
      ``pipeline_parallel``, ``launch.elastic``, ``launch.dryrun``), with
      seeded random weights. m1: ``train(mesh=make_debug_mesh(2, 4))`` on
      qwen2-0.5b at full width and depth (bf16, remat, AdamW, the
      admission) at batch 4 x 512 for 4 steps, the parameters and AdamW
      state the plan's pieces on the one card: warm ms a step, tok/s, the
      plan's bytes a position against the pieces resident, the bytes
      moved between positions a step, ``max_memory_allocated``; then
      lm-12m in float32, 3 steps on the mesh against 3 on one device from
      one seed: losses and grad norms within 1e-5 relative, parameters
      within 1e-5 x max(1, max|p|). m2: ``serve(qwen2-0.5b, batch 4,
      max_len=16384, mesh=(2, 4))``, the K/V cut over the sequence and
      attended piece by piece: its 16 greedy tokens a row equal one
      device's. m3: llama4-maverick-400b-a17b at full width cut to 1
      layer (16.1 B expert weights, 36.7 GB of bf16 pieces), drawn on the
      card and cut into a (1, 4) mesh's pieces, the experts over
      ``model``: 8 greedy steps at batch 4, ids in range, the mesh's
      decode logits against its forward within the reference's bf16
      tolerance, ``max_memory_allocated`` against the plan. m4:
      ``pipeline_apply``, 4 stages x 8 microbatches of 16 x 4,096 float32,
      equal to the direct composition within 1e-5, the bubble fraction.
      m5: lm-12m saved after 2 steps on (2, 4), restored with
      ``remesh_and_restore(..., 4, model_parallel=2)`` onto (2, 2): every
      leaf bit for bit, 2 more steps within rtol 1e-5 of an uninterrupted
      4-step run. m6: ``launch.dryrun.run_cell`` for qwen2-0.5b at the
      four shapes on both production meshes and llama4-maverick at
      ``train_4k`` on 16 x 16, on fake tensors in child processes (no
      card) started before path a: GB a position, fits (80 GB), FLOPs a
      position, the roofline terms and each cell's seconds (two child
      processes, half the cells' time each). Only m1's
      admission launches kernels of the table (``eq_imm``/``cmp_imm``).
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
   over the programs of paths a, b, f and g; launches of paths a-j, the
   examples, l and m), then
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
                rel, c.program, mask_outputs=(mask_reg,), mesh=db.mesh,
                shard_axes=db.shard_axes)))
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
            cp = prog.compile_program(rel, c.program, mask_outputs=(),
                                      mesh=db.mesh, shard_axes=db.shard_axes)
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
COMPACT_SF = 0.05


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
    from repro_torch.db import tpch
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

    # Compact runs on its own sf 0.05 database: at SF 1 it alone took
    # 41-57 s of this script's 1,200 s budget on an H100 (host work).
    small = D.PimDatabase(tpch.generate(sf=COMPACT_SF, seed=SEED))
    s_oracle = MutableTable(small.tables["lineitem"])
    s_src = {a: np.asarray(c) for a, c in small.tables["lineitem"].items()}
    s_prev = []
    for r in range(2):
        idx = rng.integers(0, len(s_src["l_quantity"]), HTAP_BATCH)
        batch = {a: c[idx] for a, c in s_src.items()}
        muts = [Insert("lineitem", batch)]
        if s_prev:
            muts.append(Delete("lineitem", row_ids=s_prev))
        htap_apply(small, f"sf {COMPACT_SF} round {r + 1}", muts, rows)
        new_ids = s_oracle.insert(batch)
        if s_prev:
            s_oracle.delete(row_ids=s_prev)
        s_prev = new_ids
    htap_apply(small, f"sf {COMPACT_SF} compact", [Compact("lineitem")],
               rows)
    r6c, l6c = htap_fused(small, q6, "after compact")
    count(l6c)
    exp = s_oracle.aggregate(spec6.filters["lineitem"], spec6.aggregates)
    if tuple(r6c.aggregates["all"][a.name]
             for a in spec6.aggregates) != exp:
        fail(f"path g after compact: Q6 != MutableTable {exp}")
    record["launches"] = launches["fused_program"]

    rep = db.report(r6)
    print(f"path g wear: rotate's busiest row {leveled:.0f} cell writes "
          f"after the stream, first-fit replay {unleveled:.0f} (ratio "
          f"{leveled / unleveled:.4f} <= 0.5); after the update and growth "
          f"{d.segments.busiest_row_ops():.0f}; the sf {COMPACT_SF} "
          f"database after its compact "
          f"{small.dml_state('lineitem').segments.busiest_row_ops():.0f}",
          flush=True)
    print(f"path g report (Q6 after the growth, sf_scale 1): bytes_resident "
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
          f"Q14 FUSED and Q6 EAGER == ORACLE; compact at sf {COMPACT_SF}, "
          f"Q6 == MutableTable; "
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


# Path j: record-sharded relations on a mesh of the one card.
MESH_SHAPE, MESH_AXES = (2, 4), ("pod", "data")
MESH_BATCH = ("Q1", "Q6", "Q14", "Q19")


def mesh_result_equal(label, spec, got, want) -> None:
    """Rows, columns, materialized counts, aggregates and masks equal."""
    if (got.rows, got.columns, got.materialized_rows, got.aggregates) != \
            (want.rows, want.columns, want.materialized_rows,
             want.aggregates):
        fail(f"path j {label}: {spec.name} != the single-device result")
    for rel in want.relations:
        if not np.array_equal(got.relations[rel].mask,
                              want.relations[rel].mask):
            fail(f"path j {label}: {spec.name}/{rel} mask != single-device")


def shard_programs_check(label, dbm, specs, flush, peaks, hosts=False,
                         time_them=False) -> tuple[dict, int]:
    """Each shard's ``fused_program`` (and, for host-stage specs, its
    ``materialize``) against the plain version at the shard's shape, bit
    for bit. With ``time_them``: per spec the card time of the shards'
    launches in turn on one stream and the sum of their bounds. Returns
    ({spec: (kernel_ms, bound_ms, materialize ms)}, worst diff)."""
    from repro_torch.core import program as prog
    from repro_torch.kernels import materialize as km
    from repro_torch.kernels import program as kp
    rows = host_programs(dbm) if hosts else [
        (n, rel, cp, None) for n, rel, cp in programs(dbm, specs)]
    out, worst = {}, 0
    for name, rel, cp, ins in rows:
        stacks = [prog.stack_sources(cp, rel, s) for s in range(rel.n_shards)]
        mats = []
        for s, st in enumerate(stacks):
            got = kp.fused_program(st, cp.tape)
            d = max_abs_diff(got, kp.fused_program_torch(st, cp.tape))
            if d:
                fail(f"path j {label}: fused_program != plain on {name}/"
                     f"{rel.name} shard {s} ({tuple(st.shape)})")
            worst = max(worst, d)
            if ins is not None:
                planes, valid = rel.shards()[s]
                mask = (valid if ins.mask == "__valid__"
                        else got[0][cp.kernel_masks.index(ins.mask)])
                mp = [planes[a] for a in ins.attrs]
                worst = max(worst, check_materialize(
                    f"path j {label} {name}/{rel.name} shard {s}", mp,
                    mask)[0])
                mats.append((mp, mask))
        if not time_them:
            continue
        logic, popc = cp.tape.word_ops()
        bound = sum(bound_s((cp.tape.n_rows + cp.tape.n_masks)
                            * st.shape[1] * 4, logic * st.shape[1],
                            popc * st.shape[1], peaks)[0] for st in stacks)
        k_ms = cuda_ms(lambda: [kp.fused_program(st, cp.tape)
                                for st in stacks], 5, flush, ahead=True)
        m_ms = (cuda_ms(lambda: [km.materialize(p, m) for p, m in mats], 5,
                        flush, ahead=True) if mats else 0.0)
        prev = out.get(name, (0.0, 0.0, 0.0))
        out[name] = (prev[0] + k_ms, prev[1] + bound * 1e3, prev[2] + m_ms)
    return out, worst


def phase_mesh_path(db, path_a, path_b, flush, peaks) -> dict:
    """Path j: ``PimDatabase(tables, mesh=make_mesh((2, 4), ("pod",
    "data"), device="cuda"))`` over path a's tables, each relation split 8
    ways on the one card. Path a's 21 specs, the six host specs, a linked
    batch, the 5-request service smoke and Q6 on EAGER equal the
    single-device results; a DML round then Q6 equals the mutable table;
    ``distributed_filter_aggregate`` on lineitem equals numpy; each shard's
    kernels equal plain at SF 1's shard shape and at sf 0.002's (128
    words a shard, shards of padding only, shards selecting nothing).
    Returns the path's launches and worst diffs."""
    import asyncio
    tables = db.tables
    from repro_torch import dml
    from repro_torch.core import distributed as dist
    from repro_torch.db import database as D
    from repro_torch.db import exec as E
    from repro_torch.db import queries as Q
    from repro_torch.db import tpch
    from repro_torch.serve import QueryService

    t_path = time.perf_counter()
    total = dict.fromkeys(read_launches(), 0)

    def count(launches):
        for k, v in launches.items():
            total[k] += v

    mesh = dist.make_mesh(MESH_SHAPE, MESH_AXES, device="cuda")
    t0 = time.perf_counter()
    dbm = D.PimDatabase(tables, mesh=mesh)
    torch.cuda.synchronize()
    li = dbm.relations["lineitem"]
    print(f"path j: mesh {MESH_SHAPE} {MESH_AXES} on one card, "
          f"{li.n_shards} shards; pack, copy and split "
          f"{time.perf_counter() - t0:.1f} s; lineitem {li.layout.n_words} "
          f"words, {li.shard_valid[0].shape[0]} a shard", flush=True)
    n_sh = li.n_shards

    specs = [s.filter_only() for s in Q.all_queries()] + minmax_specs()
    reset_launches()
    results = [dbm.execute(s) for s in specs]
    torch.cuda.synchronize()
    launches = read_launches()
    n_programs = sum(len(s.filters) for s in specs)
    want = dict.fromkeys(launches, 0)
    want["fused_program"] = n_programs * n_sh
    if launches != want:
        fail(f"path j specs: launches {launches}, expected {want}")
    count(launches)
    for spec, got in zip(specs, results):
        mesh_result_equal("specs", spec, got, path_a["results"][spec.name])

    hosts = [Q.get_query(n) for n in HOST_SPECS]
    reset_launches()
    h_results = [dbm.execute(s) for s in hosts]
    torch.cuda.synchronize()
    launches = read_launches()
    want = dict.fromkeys(launches, 0)
    want["fused_program"] = want["materialize"] = N_HOST_PROGRAMS * n_sh
    if launches != want:
        fail(f"path j host specs: launches {launches}, expected {want}")
    count(launches)
    for spec, got in zip(hosts, h_results):
        mesh_result_equal("host specs", spec, got,
                          path_b["results"][spec.name])
    from repro_torch.db.compiler import Agg, Cmp, Col, Lit
    avg = Q.QuerySpec("Qavg_empty", "full",
                      filters={"customer": Cmp("gt", Col("c_acctbal"),
                                               Lit(1 << 40))},
                      agg_relation="customer",
                      aggregates=[Agg("avg", Col("c_acctbal"), "avg_bal")])
    reset_launches()
    if dbm.execute(avg).aggregates != {"all": {"avg_bal": None}}:
        fail("path j: Qavg_empty on the mesh is not None")
    count(read_launches())
    print(f"path j ok: {len(specs)} specs and {len(hosts)} host-stage specs "
          f"== single-device (masks, aggregates, rows, materialized); "
          f"Qavg_empty None; fused_program {n_programs} + "
          f"{N_HOST_PROGRAMS} programs x {n_sh} shards", flush=True)

    batch = [Q.get_query(n) for n in MESH_BATCH]
    reset_launches()
    b_results = dbm.execute(batch)
    torch.cuda.synchronize()
    launches = read_launches()
    stats = dbm.last_batch_stats
    rels = {r for s in batch for r in s.pim_relations()}
    want = dict.fromkeys(launches, 0)
    want["fused_program"] = len(rels) * n_sh
    want["materialize"] = n_sh * sum(len(E.split_query(s)[0])
                                     for s in batch if s.host is not None)
    if stats["n_dispatches"] != 2 or launches != want:
        fail(f"path j batch: n_dispatches {stats['n_dispatches']}, "
             f"launches {launches}, expected 2 and {want}")
    count(launches)
    for spec, got in zip(batch, b_results):
        src = path_b if spec.host is not None else path_a
        mesh_result_equal("batch", spec, got, src["results"][spec.name])

    trace = [Q.get_query(n) for n in ("Q1", "Q6", "Q14", "Q6", "Q1")]

    async def serve():
        async with QueryService(dbm, max_window=3, max_wait_s=0.005) as svc:
            res = await asyncio.gather(*[svc.submit(s) for s in trace])
            return res, svc.stats()

    reset_launches()
    served, sstats = asyncio.run(asyncio.wait_for(serve(), 300))
    torch.cuda.synchronize()
    count(read_launches())
    if sstats["errors"] != 0 or sstats["coalesced"] != 2:
        fail(f"path j service: {sstats['errors']} errors, "
             f"{sstats['coalesced']} coalesced (expected 0 and 2)")
    for spec, got in zip(trace, served):
        src = path_b if spec.host is not None else path_a
        mesh_result_equal("service", spec, got, src["results"][spec.name])
    q6 = Q.get_query("Q6")
    reset_launches()
    e6 = dbm.execute(q6, engine="eager")
    count(read_launches())
    mesh_result_equal("eager", q6, e6, path_a["results"]["Q6"])
    print(f"path j ok: batch {'+'.join(MESH_BATCH)} n_dispatches "
          f"{stats['n_dispatches']}, fused_program {len(rels) * n_sh}, "
          f"materialize {want['materialize']}; service 0 errors, "
          f"{sstats['coalesced']} coalesced, {sstats['dispatches']} "
          f"dispatches; Q6 EAGER on the gathered view == FUSED", flush=True)

    # distributed_filter_aggregate: cmp_imm on each shard, int64 combine.
    sd = li.shard_planes
    lo, hi = 8000, 8365
    run = dist.distributed_filter_aggregate(
        mesh, dist.make_sum_where_program(lo, hi), MESH_AXES)
    reset_launches()
    pcs = run(tuple(p["l_shipdate"] for p in sd),
              tuple(p["l_extendedprice"] for p in sd), li.shard_valid)
    got = sum(int(pcs[b]) << b for b in range(pcs.shape[0]))
    launches = read_launches()
    count(launches)
    cols = tables["lineitem"]
    sel = (cols["l_shipdate"] >= lo) & (cols["l_shipdate"] < hi)
    if got != int(cols["l_extendedprice"][sel].sum()) or \
            launches["cmp_imm"] != 2 * n_sh:
        fail(f"path j distributed_filter_aggregate: {got} != numpy or "
             f"cmp_imm launches {launches['cmp_imm']} != {2 * n_sh}")

    # Kernels against plain at the shards' shapes, and the times.
    timed, d1 = shard_programs_check("SF 1", dbm, specs, flush, peaks,
                                     time_them=True)
    h_timed, d2 = shard_programs_check("SF 1", dbm, hosts, flush, peaks,
                                       hosts=True, time_them=True)
    small = D.PimDatabase(tpch.generate(sf=0.002, seed=SEED), mesh=mesh)
    sv = small.relations["lineitem"].shard_valid
    pad = sum(not bool(v.any()) for v in sv)
    if sv[0].shape[0] != 128 or not pad:
        fail(f"path j sf 0.002: {sv[0].shape[0]} words a shard, {pad} "
             "shards of padding only (expected 128 and some)")
    _, d3 = shard_programs_check("sf 0.002", small, specs, flush, peaks)
    _, d4 = shard_programs_check("sf 0.002", small, hosts, flush, peaks,
                                 hosts=True)
    host_profile(dbm, specs[1])
    for spec in specs + hosts:
        got = small.execute(spec)
        want_r = small.execute(spec, engine=D.Engine.ORACLE)
        if (got.rows, got.aggregates) != (want_r.rows, want_r.aggregates):
            fail(f"path j sf 0.002: {spec.name} != ORACLE")
    print(f"path j ok: fused_program and materialize == plain on every "
          f"shard of {len(specs) + len(hosts)} specs at SF {MAIN_SF} "
          f"({li.shard_valid[0].shape[0]} words a shard) and at sf 0.002 "
          f"(128 words a shard, {pad} of {n_sh} lineitem shards padding "
          f"only, Qmm_empty selecting nothing); sf 0.002 == ORACLE; "
          f"distributed_filter_aggregate == numpy", flush=True)

    # execute_ms of both databases, one warm call each (mesh, then
    # single), to a host read-back: cut from four turns (mesh, single,
    # single, mesh) to two in PR 25, for path m's time.
    def wall_ms(d, spec) -> float:
        torch.cuda.synchronize()
        t = time.perf_counter()
        d.execute(spec)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    print("path j: the execute_ms table times each database once a spec "
          "(cut from two turns each, for path m)", flush=True)
    print("query     mesh_execute_ms  single_execute_ms  shards_kernel_ms  "
          "single_kernel_ms  shards_bound_ms  single_bound_ms  "
          "shards_mat_ms  launches")
    for spec in specs + hosts:
        m1, s1 = (wall_ms(d, spec) for d in (dbm, db))
        ps = (path_b if spec.host is not None else path_a)["by_query"][
            spec.name]
        k_ms, b_ms, m_ms = (timed if spec.host is None else h_timed)[
            spec.name]
        sb = sum(bound_s(p["bytes"], p["logic"], p["popc"], peaks)[0]
                 for p in ps) * 1e3
        n_launch = len(ps) * n_sh * (2 if spec.host is not None else 1)
        print(f"{spec.name:9s} {m1:15.3f} {s1:18.3f} "
              f"{k_ms:17.4f} {sum(p['kernel_ms'] for p in ps):17.4f} "
              f"{b_ms:16.5f} {sb:16.5f} {m_ms:14.4f} {n_launch:9d}",
              flush=True)

    # One DML round on the mesh, then Q6 against the mutable table.
    spec6 = Q.get_query("Q6")
    oracle = dml.MutableTable(dbm.tables["lineitem"])
    live = dbm.dml_state("lineitem").live_ids()
    take = {a: np.asarray(c[:32]) for a, c in dbm.tables["lineitem"].items()}
    reset_launches()
    t0 = time.perf_counter()
    dbm.apply([dml.Insert("lineitem", take),
               dml.Delete("lineitem", row_ids=live[:16]),
               dml.Update("lineitem", {"l_quantity": 9},
                          row_ids=live[16:48])])
    torch.cuda.synchronize()
    apply_ms = (time.perf_counter() - t0) * 1e3
    oracle.insert(take)
    oracle.delete(row_ids=list(range(16)))
    oracle.update({"l_quantity": 9}, row_ids=list(range(16, 48)))
    r6 = dbm.execute(spec6)
    count(read_launches())
    exp = oracle.aggregate(spec6.filters["lineitem"], spec6.aggregates)
    if tuple(r6.aggregates["all"][a.name] for a in spec6.aggregates) != exp:
        fail(f"path j DML: Q6 {r6.aggregates} != MutableTable {exp}")
    rel = dbm.relations["lineitem"]
    if not isinstance(rel, dist.ShardedRelation) or rel.n_shards != n_sh:
        fail("path j DML: publish did not shard lineitem again")
    print(f"path j ok: DML round (insert 32, delete 16, update 32) on the "
          f"mesh {apply_ms:.3f} ms, re-sharded {rel.n_shards} ways, Q6 == "
          f"MutableTable", flush=True)

    n_cards = torch.cuda.device_count()
    if n_cards > 1:
        cards = dist.make_mesh((n_cards,), ("data",),
                               devices=[f"cuda:{i}" for i in range(n_cards)])
        dbc = D.PimDatabase(tables, mesh=cards)
        for name in ("Q1", "Q6", "Q14"):
            spec = Q.get_query(name)
            src = path_b if spec.host is not None else path_a
            mesh_result_equal("distinct cards", spec, dbc.execute(spec),
                              src["results"][name])
        print(f"path j ok: mesh over {n_cards} distinct cards, Q1/Q6/Q14 "
              "== single-device", flush=True)
    else:
        print("path j: mesh over distinct cards not run (one GPU)",
              flush=True)
    print(f"phase 4j ok: launches {total}; "
          f"{time.perf_counter() - t_path:.1f} s", flush=True)
    return {"launches": total, "worst": max(d1, d2, d3, d4)}


def phase_example() -> dict:
    """The examples on the card: ``repro_torch.examples.tpch_analytics.main``
    at sf 0.01 (every row it prints must be verified), then
    ``analytics_guided_serving.main`` (its admission mask over 50,000
    requests through ``eq_imm``/``cmp_imm`` must equal numpy's, its qwen2
    smoke batch decodes). Returns their launches, summed."""
    from repro_torch.examples import analytics_guided_serving as ags
    from repro_torch.examples import tpch_analytics
    t0 = time.perf_counter()
    reset_launches()
    out = tpch_analytics.main(["--sf", "0.01"])
    torch.cuda.synchronize()
    launches = read_launches()
    if not out["ok"]:
        fail(f"examples.tpch_analytics at sf 0.01: not every row verified "
             f"({[n for n, ok in out['rows'] if not ok]})")
    print(f"phase example ok: repro_torch.examples.tpch_analytics --sf 0.01 "
          f"on the card, {len(out['rows'])} rows, Q3 end to end, the batch, "
          f"the served stream and the HTAP round verified; launches "
          f"{launches}; {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    reset_launches()
    served = ags.main([])
    torch.cuda.synchronize()
    served_launches = read_launches()
    q = ags.make_queue()
    want = int((np.isin(q["tier"], (2, 3)) & (q["prompt_len"] <= 4096)
                & (q["rate_bucket"] < 80)).sum())
    if served["admitted"] != want or served["shape"] != (4, 13):
        fail(f"examples.analytics_guided_serving: admitted "
             f"{served['admitted']} (numpy {want}), decoded "
             f"{served['shape']} (want (4, 13))")
    if not served_launches["eq_imm"] or not served_launches["cmp_imm"]:
        fail(f"examples.analytics_guided_serving: the admission filter did "
             f"not reach eq_imm and cmp_imm ({served_launches})")
    print(f"phase example ok: repro_torch.examples.analytics_guided_serving "
          f"on the card, {served['admitted']} of {ags.N_REQ} admitted == "
          f"numpy, decoded {served['shape']}; launches {served_launches}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return {k: v + served_launches[k] for k, v in launches.items()}


# -- path k: the LM serving path ----------------------------------------------
# k3's architectures at full width, each cut in depth to fit the time limit
# (None: all layers). llama4-maverick runs in path m3, on a mesh: one of
# its MoE layers alone holds 3 x 128 x 5,120 x 8,192 expert weights (32 GB
# in bf16).
LM_CUTS = (("gemma2-9b", 2), ("olmoe-1b-7b", 2), ("paligemma-3b", 2),
           ("qwen1.5-0.5b", 2), ("stablelm-3b", 2), ("whisper-small", None),
           ("xlstm-1.3b", 8), ("zamba2-7b", 7))
LM_B, LM_S, LM_FRAMES, LM_STEPS, LM_CARD_CPU_STEPS = 2, 16, 64, 16, 4


def lm_bf16_bound(want: torch.Tensor) -> float:
    """The reference's bf16 decode-vs-forward tolerance."""
    return max(0.01 * float(want.float().abs().max()), 0.25)


def lm_max_diff(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float().cpu() - want.float().cpu()).abs().max())


def lm_inputs(cfg, gen):
    """(B, S) token ids and the frontend stub's input (vision: the
    ``n_frontend_tokens`` patch embeddings; audio: 64 frames), drawn on
    the card."""
    tokens = torch.randint(0, cfg.vocab, (LM_B, LM_S), generator=gen,
                           device="cuda")
    n = {"vision_stub": cfg.n_frontend_tokens,
         "audio_stub": LM_FRAMES}.get(cfg.frontend)
    extra = None if n is None else torch.randn(
        (LM_B, n, cfg.d_model), generator=gen, device="cuda")
    return tokens, extra


def lm_decode_vs_forward(model, tokens, label, bound=None) -> float:
    """Teacher-forced decode logits against ``forward`` on ``tokens`` (no
    frontend): max |diff|, which must be at most ``bound`` where one is
    given (else it is only printed)."""
    from repro_torch.models.lm import decode_logits
    err = lm_max_diff(decode_logits(model, tokens), model.forward(tokens))
    if bound is not None and not err <= bound:
        fail(f"path k {label}: decode logits differ from forward by {err} "
             f"(bound {bound})")
    return err


def lm_card_vs_cpu(model, tokens, extra, label, dvf=False):
    """Cast ``model`` to float32 (bf16 -> float32 is exact), run forward and
    ``LM_CARD_CPU_STEPS`` greedy decode steps on the card, move it to the
    CPU and run them again: logits within 1e-3 x max(1, max|logits|), the
    same greedy tokens. With ``dvf``, first decode == forward on the card
    in float32 within 1e-3 x max(1, max|logits|). Returns (the card-CPU
    |diff| over max(1, max|.|), the float32 decode-forward |diff| over
    max(1, max|logits|) or None)."""
    import dataclasses
    from repro_torch.launch.serve import greedy_decode
    from repro_torch.models.lm import decode_logits
    model.float()
    model.cfg = dataclasses.replace(model.cfg, dtype="float32")
    encdec = model.cfg.block_pattern == "encdec"
    f32_dvf = None
    if dvf:
        scale = max(1.0, float(model.forward(tokens).abs().max()))
        f32_dvf = lm_decode_vs_forward(model, tokens, f"{label} float32",
                                       1e-3 * scale) / scale
    sides = {}
    for dev in ("cuda", "cpu"):
        model.to(dev)
        tok = tokens.to(dev)
        ex = None if extra is None else extra.to(dev)
        cross = model.encode(ex)[1] if encdec else None
        fwd = model.forward(tok, ex)
        seq, _ = greedy_decode(model, tok[:, :1], 1 + LM_CARD_CPU_STEPS,
                               cross=cross)
        dec = decode_logits(model, torch.from_numpy(seq[:, :-1]).to(dev),
                            cross=cross)
        sides[dev] = (fwd.cpu(), seq, dec.cpu())
    if not np.array_equal(sides["cuda"][1], sides["cpu"][1]):
        fail(f"path k {label}: greedy tokens differ, card "
             f"{sides['cuda'][1].tolist()} CPU {sides['cpu'][1].tolist()}")
    worst = 0.0
    for i, what in ((0, "forward"), (2, "decode")):
        want = sides["cpu"][i]
        scale = max(1.0, float(want.abs().max()))
        err = lm_max_diff(sides["cuda"][i], want)
        if not err <= 1e-3 * scale:
            fail(f"path k {label}: float32 {what} logits on the card differ "
                 f"from the CPU's by {err} (bound {1e-3 * scale})")
        worst = max(worst, err / scale)
    return worst, f32_dvf


def lm_row(label, cfg, layers, nbytes, seconds, tps, bf16, f32, cvc,
           card) -> None:
    """One line of path k's table. ``bf16``: decode-forward max |diff| and
    the reference's bf16 tolerance; ``f32``: the float32 decode-forward
    |diff| over max(1, max|logits|); ``cvc``: card against CPU, the same
    scale."""
    b16 = "-" if bf16 is None else f"{bf16[0]:.4f}/{bf16[1]:.4f}"
    f32 = "-" if f32 is None else f"{f32:.3e}"
    print(f"{label:4s} {cfg.name:26s} {layers:>6s} {nbytes / 1e9:8.3f} "
          f"{seconds:7.1f} {tps:8.1f} {b16:>15s} {f32:>10s} {cvc:10.3e}  "
          f"{card}", flush=True)


@torch.inference_mode()
def phase_lm(card: str) -> None:
    """Path k: ``launch.serve.serve`` on qwen2-0.5b at full width and depth
    in bf16 (k1: shape, ids, tok/s, decode == forward at the bf16
    tolerance), the same weights in float32 on the card against the CPU
    (k2), then every other block pattern at full width, cut in depth (k3:
    forward on (2, 16), 16 teacher-forced and 16 greedy decode steps,
    finite logits; for dense and gemma2 decode == forward in float32, the
    bf16 gap printed beside the reference's tolerance (ROADMAP C11); card
    against CPU in float32). No kernel of the table runs here: the launch
    counts stay 0.
    """
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import greedy_decode, serve
    from repro_torch.models import LM
    from repro_torch.models.lm import decode_logits
    torch.backends.cuda.matmul.allow_tf32 = False
    t_path = time.perf_counter()
    reset_launches()
    print("path k: the LM serving path on the card, bf16 weights drawn from "
          "a seeded generator; card vs CPU in float32", flush=True)
    print("path config                     layers param_GB  wall_s    "
          "tok_s   bf16_dvf/tol    f32_dvf card_vs_cpu  card", flush=True)

    t0 = time.perf_counter()
    cfg = get_config("qwen2-0.5b")
    seq, tps = serve(cfg, batch=4, prompt_len=1, gen_len=LM_STEPS)
    if seq.shape != (4, 1 + LM_STEPS) or not (
            (seq >= 0) & (seq < cfg.vocab)).all():
        fail(f"path k1: serve gave {seq.shape} ids in "
             f"[{seq.min()}, {seq.max()}] (want (4, 17) in [0, "
             f"{cfg.vocab}))")
    again, tps_warm = serve(cfg, batch=4, prompt_len=1, gen_len=LM_STEPS)
    if not np.array_equal(again, seq):
        fail("path k1: a second serve from the same seed decoded other "
             "tokens")
    print(f"path k1: serve qwen2-0.5b batch 4, {LM_STEPS} steps: {tps:.1f} "
          f"tok/s cold (the first call), {tps_warm:.1f} warm; the same "
          f"tokens", flush=True)
    model = LM(cfg)                       # serve's weights: seed 0 on cuda
    head = torch.from_numpy(seq[:, :LM_STEPS]).cuda()
    bound = lm_bf16_bound(model.forward(head))
    bf16 = (lm_decode_vs_forward(model, head, "k1 qwen2-0.5b", bound), bound)
    layers = f"{cfg.n_layers}/{cfg.n_layers}"
    lm_row("k1", cfg, layers, model.param_bytes(), time.perf_counter() - t0,
           tps_warm, bf16, None, float("nan"), card)
    t0 = time.perf_counter()
    tokens, _ = lm_inputs(cfg, torch.Generator(device="cuda").manual_seed(
        SEED))
    cvc, f32 = lm_card_vs_cpu(model, tokens, None, "k2 qwen2-0.5b",
                              dvf=True)
    lm_row("k2", cfg, layers, model.param_bytes(), time.perf_counter() - t0,
           float("nan"), None, f32, cvc, card)
    del model
    torch.cuda.empty_cache()

    for arch, cut in LM_CUTS:
        t0 = time.perf_counter()
        full = get_config(arch)
        cfg = full if cut is None else dataclasses.replace(full,
                                                           n_layers=cut)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        model = LM(cfg, generator=gen)
        tokens, extra = lm_inputs(cfg, gen)
        logits = model.forward(tokens, extra)
        n_out = LM_S + (cfg.n_frontend_tokens
                        if cfg.frontend == "vision_stub" else 0)
        if logits.shape != (LM_B, n_out, cfg.vocab) or \
                not bool(torch.isfinite(logits).all()):
            fail(f"path k3 {arch}: forward logits {tuple(logits.shape)}, "
                 f"finite {bool(torch.isfinite(logits).all())}")
        cross = (model.encode(extra)[1] if cfg.block_pattern == "encdec"
                 else None)
        dec = decode_logits(model, tokens, cross=cross)
        if not bool(torch.isfinite(dec).all()):
            fail(f"path k3 {arch}: decode logits not finite")
        seq, tps = greedy_decode(model, tokens[:, :1], 1 + LM_STEPS,
                                 cross=cross)
        if not ((seq >= 0) & (seq < cfg.vocab)).all():
            fail(f"path k3 {arch}: greedy ids out of [0, {cfg.vocab})")
        causal = cfg.block_pattern in ("dense", "gemma2")
        bf16 = None
        if causal:
            bound = lm_bf16_bound(model.forward(tokens))
            bf16 = (lm_decode_vs_forward(model, tokens, f"k3 {arch}"), bound)
        nbytes = model.param_bytes()
        cvc, f32 = lm_card_vs_cpu(model, tokens, extra, f"k3 {arch}",
                                  dvf=causal)
        lm_row("k3", cfg, f"{cfg.n_layers}/{full.n_layers}", nbytes,
               time.perf_counter() - t0, tps, bf16, f32, cvc, card)
        del model, logits, dec
        torch.cuda.empty_cache()
    print("path k: llama4-maverick-400b-a17b runs in path m3 (one MoE layer "
          "holds 16.1 B expert weights, 32 GB bf16: served with its experts "
          "over a mesh's model axis)", flush=True)
    launches = read_launches()
    if any(launches.values()):
        fail(f"path k launched a kernel of the table: {launches}")
    print(f"phase 4k ok: qwen2-0.5b served at full width and depth, "
          f"{len(LM_CUTS)} more architectures at full width; "
          f"{time.perf_counter() - t_path:.1f} s", flush=True)


# -- path l: the LM training path ---------------------------------------------
# l1: qwen2-0.5b at full width and depth, batch 4 x 512 tokens; the
# admission at 10 M records (47 planes x 312,500 words). l2: the example's
# lm-12m at its default batch (8 x 256) card against CPU, then one step of
# every other block pattern at k3's cuts (LM_CUTS) and llama4's smoke size.
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_RESUME_AT = 4, 512, 8, 4
MESH_LM = (2, 4)
ADMIT_N = 10_000_000
L2_STEPS = 3
L2_ARCHS = ("olmoe-1b-7b", "gemma2-9b", "xlstm-1.3b", "zamba2-7b",
            "whisper-small", "paligemma-3b")


def train_finite(label, history) -> None:
    for h in history:
        if not (np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])):
            fail(f"path {label}: step {h['step']} loss {h['loss']} grad "
                 f"norm {h['grad_norm']}")


def same_tree(label, got, want) -> None:
    """Every leaf of two checkpoint trees equal bit for bit."""
    from repro_torch.checkpoint import checkpoint as ckpt
    g, w = ckpt._flatten(got), ckpt._flatten(want)
    if list(g) != list(w):
        fail(f"path {label}: restored leaves {list(g)[:4]} != saved "
             f"{list(w)[:4]}")
    for k, v in w.items():
        if (v is None) != (g[k] is None) or (
                v is not None and (g[k].dtype != v.dtype
                                   or not torch.equal(g[k], v))):
            fail(f"path {label}: restored leaf {k} differs from the saved one")


def phase_admission(card):
    """l1's admission: ``PimDataSelector`` over ``CorpusMeta.synthetic(
    10_000_000, seed=0)`` on the card, equal to ``queries.eval_pred`` bit
    for bit; its build and admit times and launches. Returns the
    selector (its planes are checked against plain after the path)."""
    from repro_torch.data.pipeline import (CorpusMeta, PimDataSelector,
                                           default_selection)
    from repro_torch.db import queries
    meta = CorpusMeta.synthetic(ADMIT_N, seed=0)
    t0 = time.perf_counter()
    sel = PimDataSelector(meta)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    times = []
    for _ in range(3):
        before = read_launches()
        t0 = time.perf_counter()
        mask = sel.admit()
        times.append((time.perf_counter() - t0) * 1e3)
    after = read_launches()
    launches = {k: after[k] - before[k] for k in after}
    cols = {"length": meta.length, "quality": meta.quality,
            "domain": meta.domain, "dedup_bucket": meta.dedup_bucket}
    want = queries.eval_pred(cols, default_selection())
    if not np.array_equal(mask, want):
        fail(f"path l1: admission differs from numpy on "
             f"{int((mask != want).sum())} of {ADMIT_N} records")
    planes = sum(p.shape[0] for p in sel.rel.planes.values())
    words = sel.rel.valid.shape[0]
    nbytes = sum(p.numel() * 4 for p in sel.rel.planes.values())
    print(f"path l1 admission: {ADMIT_N:,} records, {planes} planes x "
          f"{words:,} words ({nbytes / 1e6:.1f} MB on the card), "
          f"{int(mask.sum()):,} admitted == numpy; bit-slice and upload "
          f"{build_ms:.1f} ms, admit {times[0]:.1f} ms cold, "
          f"{times[1]:.1f} / {times[2]:.1f} ms warm (to the host mask); "
          f"eq_imm {launches['eq_imm']} + cmp_imm {launches['cmp_imm']} "
          f"launches an admit; {card}", flush=True)
    return sel


def phase_train_qwen2(card) -> None:
    """l1's training: ``train()`` on qwen2-0.5b at full width and depth
    (bf16, remat, AdamW), 8 steps uninterrupted; 4 steps, a blocking save
    and a restore bit for bit; a run resumed from it to step 8 within rtol
    2e-4 of the uninterrupted losses."""
    import shutil
    import tempfile
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.configs.common import ShapeConfig
    from repro_torch.launch.train import train
    from repro_torch.models import convert
    cfg = get_config("qwen2-0.5b")
    shape = ShapeConfig("l1", TRAIN_S, TRAIN_B, "train")
    kw = dict(log_every=0)
    torch.cuda.reset_peak_memory_stats()
    full = []
    t0 = time.perf_counter()
    model, state, losses_full = train(cfg, shape, steps=TRAIN_STEPS,
                                      history=full, **kw)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    train_finite("l1", full)
    n_params = sum(p.numel() for p in model.parameters())
    del model, state
    torch.cuda.empty_cache()
    warm = statistics.median(h["seconds"] for h in full[1:])
    print(f"path l1: train qwen2-0.5b ({n_params / 1e6:.1f} M parameters, "
          f"bf16, remat, AdamW) batch {TRAIN_B} x {TRAIN_S}, "
          f"{TRAIN_STEPS} steps in {wall:.1f} s: step 1 "
          f"{full[0]['seconds'] * 1e3:.1f} ms, warm median "
          f"{warm * 1e3:.1f} ms ({TRAIN_B * TRAIN_S / warm:.0f} tok/s); "
          f"max_memory_allocated {peak / 1e9:.2f} GB; losses "
          f"{[round(x, 4) for x in losses_full]}, grad norms "
          f"{[round(h['grad_norm'], 3) for h in full]}; {card}", flush=True)

    root = Path(__file__).resolve().parent
    ckdir = tempfile.mkdtemp(prefix=".smoke_ckpt_", dir=root)
    try:
        model, state, losses_a = train(cfg, shape, steps=TRAIN_RESUME_AT,
                                       **kw)
        tree = {"params": convert.reference_params(model), "opt": state}
        t0 = time.perf_counter()
        ckpt.save(ckdir, TRAIN_RESUME_AT, tree, blocking=True)
        save_s = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in Path(ckdir).rglob("*")
                     if f.is_file())
        t0 = time.perf_counter()
        step, back = ckpt.restore(ckdir, tree)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if step != TRAIN_RESUME_AT:
            fail(f"path l1: restored step {step}")
        same_tree("l1", back, tree)
        n_leaves = sum(v is not None for v in ckpt._flatten(tree).values())
        del model, state, tree, back
        torch.cuda.empty_cache()
        resumed = []
        _, _, losses_b = train(cfg, shape, steps=TRAIN_STEPS,
                               ckpt_dir=ckdir, ckpt_every=TRAIN_STEPS * 2,
                               history=resumed, **kw)
        train_finite("l1 resumed", resumed)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.empty_cache()
    tail = np.asarray(losses_full[TRAIN_RESUME_AT:])
    rel = float(np.max(np.abs(np.asarray(losses_b) - tail) / np.abs(tail)))
    if len(losses_b) != TRAIN_STEPS - TRAIN_RESUME_AT or not rel <= 2e-4:
        fail(f"path l1: resumed losses {losses_b} against uninterrupted "
             f"{tail.tolist()} (max rel {rel}, rtol 2e-4)")
    rel_a = float(np.max(np.abs(np.asarray(losses_a)
                                - losses_full[:TRAIN_RESUME_AT])
                         / np.abs(losses_full[:TRAIN_RESUME_AT])))
    print(f"path l1 checkpoint: step {TRAIN_RESUME_AT}, {n_leaves} leaves "
          f"(params and AdamW state), {nbytes:,} bytes on disk; blocking "
          f"save {save_s:.2f} s, restore to the card {restore_s:.2f} s, "
          f"every leaf equal bit for bit; resumed steps "
          f"{TRAIN_RESUME_AT + 1}-{TRAIN_STEPS} within {rel:.2e} of the "
          f"uninterrupted losses (rtol 2e-4; the 4-step run's own losses "
          f"within {rel_a:.2e}); {card}", flush=True)


def phase_train_patterns(card) -> None:
    """l2: the example's lm-12m (float32, batch 8 x 256) for 3 ``train()``
    steps on the card and on the CPU from one seed's weights (async
    checkpoints every step on the card, the last restored bit for bit);
    then one train step of each other block pattern at full width, cut in
    depth as in path k, and one Adafactor step at llama4-maverick's smoke
    size."""
    import dataclasses
    import shutil
    import tempfile
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.configs.common import ShapeConfig
    from repro_torch.examples.train_lm import SMALL
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.train import train
    from repro_torch.models import LM, convert
    from repro_torch.optim import optimizers as opt
    cfg = dataclasses.replace(SMALL, dtype="float32")
    shape = ShapeConfig("l2", 256, 8, "train")
    root = Path(__file__).resolve().parent
    ckdir = tempfile.mkdtemp(prefix=".smoke_ckpt_", dir=root)
    sides = {}
    try:
        for dev in ("cuda", "cpu"):
            hist = []
            t0 = time.perf_counter()
            model, state, _ = train(
                cfg, shape, steps=L2_STEPS, log_every=0, device=dev,
                generator=torch.Generator().manual_seed(SEED),
                ckpt_dir=ckdir if dev == "cuda" else None, ckpt_every=1,
                history=hist)
            train_finite(f"l2 lm-12m {dev}", hist)
            sides[dev] = (hist, {n: p.detach().cpu() for n, p in
                                 model.named_parameters()},
                          time.perf_counter() - t0)
            if dev == "cuda":
                tree = {"params": convert.reference_params(model),
                        "opt": state}
                step, back = ckpt.restore(ckdir, tree)
                if step != L2_STEPS:
                    fail(f"path l2: newest checkpoint is step {step}")
                same_tree("l2 lm-12m", back, tree)
            del model, state
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    worst = 0.0
    for a, b in zip(*(sides[d][0] for d in ("cuda", "cpu"))):
        for k in ("loss", "grad_norm"):
            rel = abs(a[k] - b[k]) / abs(b[k])
            if not rel <= 1e-4:
                fail(f"path l2 lm-12m step {b['step']}: {k} card {a[k]} "
                     f"CPU {b[k]} (rtol 1e-4)")
            worst = max(worst, rel)
    pworst = 0.0
    for name, want in sides["cpu"][1].items():
        scale = max(1.0, float(want.abs().max()))
        err = float((sides["cuda"][1][name] - want).abs().max())
        if not err <= 1e-4 * scale:
            fail(f"path l2 lm-12m: parameter {name} card against CPU "
                 f"{err} (bound {1e-4 * scale})")
        pworst = max(pworst, err / scale)
    cards = [h["seconds"] * 1e3 for h in sides["cuda"][0]]
    cpus = [h["seconds"] * 1e3 for h in sides["cpu"][0]]
    print(f"path l2: lm-12m float32 batch 8 x 256, {L2_STEPS} train() "
          f"steps, card ms {[round(x, 1) for x in cards]} against CPU ms "
          f"{[round(x, 1) for x in cpus]}: losses and grad norms within "
          f"{worst:.2e} relative (1e-4), parameters within {pworst:.2e} x "
          f"max(1, max|p|) (1e-4); async checkpoint every step, step "
          f"{L2_STEPS} restored bit for bit; {card}", flush=True)

    print("path l2 pattern                    optimizer layers param_GB "
          "step_ms     loss  grad_norm  card", flush=True)
    cuts = dict(LM_CUTS)
    runs = [(a, get_config(a), cuts[a]) for a in L2_ARCHS]
    llama = "llama4-maverick-400b-a17b"
    runs.append((llama, dataclasses.replace(
        get_smoke_config(llama), optimizer=get_config(llama).optimizer),
        None))
    shape = ShapeConfig("l2", LM_S, LM_B, "train")
    for arch, full, cut in runs:
        cfg = full if cut is None else dataclasses.replace(full,
                                                           n_layers=cut)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        model = LM(cfg, generator=gen)
        tokens, extra = lm_inputs(cfg, gen)
        labels = torch.randint(0, cfg.vocab, tokens.shape, generator=gen,
                               device="cuda")
        step = steps_mod.build_train_step(cfg, shape, model)
        state = opt.make_optimizer(cfg.optimizer)[0](
            convert.reference_params(model))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, {"tokens": tokens, "labels": labels,
                                "extra": extra})
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        finite = all(bool(torch.isfinite(p).all())
                     for p in model.parameters())
        if not (np.isfinite(loss) and np.isfinite(gn) and finite
                and int(state.step) == 1):
            fail(f"path l2 {arch}: loss {loss}, grad norm {gn}, parameters "
                 f"finite {finite}")
        print(f"l2   {arch:29s} {cfg.optimizer:9s} {cfg.n_layers:>3d}/"
              f"{full.n_layers:<3d} {model.param_bytes() / 1e9:7.3f} "
              f"{ms:8.1f} {loss:8.4f} {gn:10.4f}  {card}", flush=True)
        del model, state, m
        torch.cuda.empty_cache()


def phase_train(card) -> dict:
    """Path l: the LM training path (``launch.train``, ``launch.steps``,
    ``optim``, ``checkpoint``, ``data.pipeline``) on the card. Only
    ``eq_imm`` and ``cmp_imm`` of the table run here (the admissions);
    they are then held against their plain versions at l1's 10 M-record
    shapes. Returns the path's launches and the kernels' max diff."""
    torch.backends.cuda.matmul.allow_tf32 = False
    t_path = time.perf_counter()
    reset_launches()
    sel = phase_admission(card)
    phase_train_qwen2(card)
    phase_train_patterns(card)
    launches = read_launches()
    others = {k: v for k, v in launches.items()
              if k not in ("eq_imm", "cmp_imm") and v}
    if others or not launches["eq_imm"] or not launches["cmp_imm"]:
        fail(f"path l launched {launches}: want eq_imm and cmp_imm only")
    planes = sel.rel.planes
    worst = max(check_filter_kernels("path l1 domain", planes["domain"],
                                     (0, 1, 2, 3, 5, 8, 13)),
                check_filter_kernels("path l1 length", planes["length"],
                                     (128,)),
                check_filter_kernels("path l1 quality", planes["quality"],
                                     (60,)))
    del sel
    torch.cuda.empty_cache()
    print(f"phase 4l ok: admission at {ADMIT_N:,} records, qwen2-0.5b "
          f"trained at full width and depth, checkpointed and resumed, "
          f"{len(L2_ARCHS) + 2} more configs' train steps; eq_imm/cmp_imm "
          f"== plain at l1's shapes; launches {launches}; "
          f"{time.perf_counter() - t_path:.1f} s", flush=True)
    return {"launches": launches, "worst": worst}


# -- path m: the mesh and dry-run tooling --------------------------------------
# m1/m2 on a (2, 4) mesh of the one card, m3 on (1, 4); m6's dry-run cells
# run on fake tensors in two background processes started before path a
# (the first four cells take about as long as the other five).
M1_STEPS, M3_STEPS, M2_SLOTS = 4, 8, 16384
M4_STAGES, M4_MICRO, M4_MB, M4_D = 4, 8, 16, 4096
DRYRUN_CELLS = [("qwen2-0.5b", s, mp) for s in
                ("train_4k", "prefill_32k", "decode_32k", "long_500k")
                for mp in (False, True)] + \
    [("llama4-maverick-400b-a17b", "train_4k", False)]


def start_dryruns():
    """m6: ``launch.dryrun.run_cell`` for ``DRYRUN_CELLS`` in two child
    processes (CPU only, fake tensors: no card), each a half of the cells
    by their time, its output to a temporary file; returned to be read
    after path m."""
    import atexit
    import os
    import tempfile
    halves = (DRYRUN_CELLS[:4], DRYRUN_CELLS[4:])
    runs = []
    for cells in halves:
        out = tempfile.TemporaryFile(mode="w+")
        code = (
            "import json, sys, time\n"
            "sys.path.insert(0, 'src')\n"
            "from repro_torch.launch.dryrun import run_cell\n"
            f"for arch, shape, multi in {cells!r}:\n"
            "    t0 = time.perf_counter()\n"
            "    d = run_cell(arch, shape, multi)\n"
            "    d['wall_s'] = time.perf_counter() - t0\n"
            "    print('CELL ' + json.dumps(d, default=float), flush=True)\n")
        proc = subprocess.Popen(
            [sys.executable, "-c", code],
            cwd=Path(__file__).resolve().parent, stdout=out,
            stderr=subprocess.STDOUT, text=True,
            env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
        atexit.register(lambda p=proc: p.poll() is None and p.kill())
        runs.append((proc, out))
    return runs, time.perf_counter()


def mesh_m1(card) -> None:
    """m1: ``train(mesh=make_debug_mesh(2, 4))`` on qwen2-0.5b at full
    width and depth (bf16, remat, AdamW, the admission) at l1's batch;
    then lm-12m in float32, 3 steps on the mesh against 3 on one device
    from one seed's weights."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.configs.common import ShapeConfig
    from repro_torch.distributed import sharded_steps as ss
    from repro_torch.distributed.sharding import ShardStore, tree_items
    from repro_torch.examples.train_lm import SMALL
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.train import train
    from repro_torch.models.convert import reference_params
    cfg = get_config("qwen2-0.5b")
    shape = ShapeConfig("m1", TRAIN_S, TRAIN_B, "train")
    mesh = make_debug_mesh(*MESH_LM)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    hist = []
    t0 = time.perf_counter()
    params, state, losses = train(cfg, shape, steps=M1_STEPS, log_every=0,
                                  history=hist, mesh=mesh)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    train_finite("m1", hist)
    fn = steps_mod.build_train_step(cfg, shape, mesh=mesh).fn
    n_sl = len(fn.mm.batch_slices(TRAIN_B))
    parts = ss.plan_parts(fn.mm, "train", TRAIN_B // n_sl, TRAIN_S,
                          fn.o_struct, fn.o_shard)
    resident = ShardStore(mesh).resident_bytes({"params": params,
                                                "opt": state})
    warm = statistics.median(h["seconds"] for h in hist[1:])
    n_pos = len(mesh.devices)
    print(f"path m1: train qwen2-0.5b (bf16, remat, AdamW) on a {MESH_LM} "
          f"mesh of the card, batch {TRAIN_B} x {TRAIN_S}, {M1_STEPS} steps "
          f"in {wall:.1f} s: step 1 {hist[0]['seconds'] * 1e3:.1f} ms, warm "
          f"median {warm * 1e3:.1f} ms ({TRAIN_B * TRAIN_S / warm:.0f} "
          f"tok/s); plan {sum(parts.values()) / 1e9:.3f} GB a position x "
          f"{n_pos} = {sum(parts.values()) * n_pos / 1e9:.3f} GB ("
          + ", ".join(f"{k} {v / 1e9:.3f}" for k, v in parts.items())
          + f"); resident params + AdamW pieces "
          f"{sum(resident.values()) / 1e9:.3f} GB; moved between positions "
          f"{hist[-1]['moved_bytes'] / 1e9:.3f} GB a step; "
          f"max_memory_allocated {peak / 1e9:.2f} GB; losses "
          f"{[round(x, 4) for x in losses]}; {card}", flush=True)
    del params, state
    torch.cuda.empty_cache()

    small = dataclasses.replace(SMALL, dtype="float32")
    shape = ShapeConfig("m1b", 256, 8, "train")
    sides = {}
    for where in ("mesh", "card"):
        hist = []
        out = train(small, shape, steps=L2_STEPS, log_every=0,
                    use_pim_selector=False, history=hist,
                    generator=torch.Generator().manual_seed(SEED),
                    mesh=mesh if where == "mesh" else None)
        tree = (fn.mm.gather_tree(out[0]) if where == "mesh" else
                reference_params(out[0]))
        sides[where] = (hist, dict(tree_items(tree)))
    worst = 0.0
    for a, b in zip(sides["mesh"][0], sides["card"][0]):
        for k in ("loss", "grad_norm"):
            rel = abs(a[k] - b[k]) / abs(b[k])
            if not rel <= 1e-5:
                fail(f"path m1 lm-12m step {b['step']}: {k} mesh {a[k]} one "
                     f"device {b[k]} (rtol 1e-5)")
            worst = max(worst, rel)
    pworst = 0.0
    for path, want in sides["card"][1].items():
        got = sides["mesh"][1][path]
        scale = max(1.0, float(want.abs().max()))
        err = float((got.float() - want.float()).abs().max())
        if not err <= 1e-5 * scale:
            fail(f"path m1 lm-12m: {path} mesh against one device {err} "
                 f"(bound {1e-5 * scale})")
        pworst = max(pworst, err / scale)
    print(f"path m1 lm-12m: float32 batch 8 x 256, {L2_STEPS} steps on the "
          f"{MESH_LM} mesh against one device: losses and grad norms within "
          f"{worst:.2e} relative (1e-5), parameters within {pworst:.2e} x "
          f"max(1, max|p|) (1e-5); {card}", flush=True)


def mesh_m2(card) -> None:
    """m2: ``serve`` of qwen2-0.5b at batch 4 with a 16,384-slot cache on
    the (2, 4) mesh (the K/V cut over the sequence): its 16 greedy tokens
    a row equal one device's."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import ShardingRules
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.serve import serve
    cfg = get_config("qwen2-0.5b")
    mesh = make_debug_mesh(*MESH_LM)
    spec = ShardingRules(mesh, cfg).kv_cache_spec(
        (cfg.n_layers, 4, M2_SLOTS, cfg.n_kv_heads, cfg.head_dim))
    if spec[2] != "model":
        fail(f"path m2: the cache spec {spec} does not cut the sequence")
    t0 = time.perf_counter()
    seq_m, tps_m = serve(cfg, 4, 1, LM_STEPS, mesh=mesh, max_len=M2_SLOTS)
    t_m = time.perf_counter() - t0
    seq_s, tps_s = serve(cfg, 4, 1, LM_STEPS, max_len=M2_SLOTS)
    if not np.array_equal(seq_m, seq_s):
        fail(f"path m2: mesh tokens {seq_m.tolist()} != one device's "
             f"{seq_s.tolist()}")
    print(f"path m2: serve qwen2-0.5b batch 4, {LM_STEPS} steps, "
          f"{M2_SLOTS}-slot cache {spec} on the {MESH_LM} mesh: {tps_m:.1f} "
          f"tok/s ({t_m:.1f} s with the weights' draw and cut) against "
          f"{tps_s:.1f} on one device; the same greedy tokens; {card}",
          flush=True)


def mesh_m3(card) -> None:
    """m3: llama4-maverick-400b-a17b at full width, cut to 1 layer, its
    weights drawn on the card (an expert stack a block of experts at a
    time) and cut into a (1, 4) mesh's pieces, the experts over
    ``model``; 8 greedy steps at batch 4, ids in range; decode logits
    against the mesh's forward within the reference's bf16 tolerance."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharded_steps as ss
    from repro_torch.distributed.sharding import ShardStore
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.serve import _greedy, mesh_serving
    full = get_config("llama4-maverick-400b-a17b")
    cfg = dataclasses.replace(full, n_layers=1)
    mesh = make_debug_mesh(1, 4)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step, params, cache, tokens = mesh_serving(cfg, mesh, 4, 1 + M3_STEPS)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if step.mm.expert[("blocks", "moe", "w_gate")] is None:
        fail("path m3: the expert stacks are not over model")
    seq, tps = _greedy(lambda c, t, p: step(params, c, t, p), cache, tokens,
                       1 + M3_STEPS, "cuda")
    if seq.shape != (4, 1 + M3_STEPS) or not (
            (seq >= 0) & (seq < cfg.vocab)).all():
        fail(f"path m3: greedy ids {seq.shape} in [{seq.min()}, "
             f"{seq.max()}] (want (4, {1 + M3_STEPS}) in [0, {cfg.vocab}))")
    head = torch.from_numpy(seq[:, :M3_STEPS]).cuda()
    fwd = ss.MeshPrefillStep(step.mm)(params, head)
    c2 = step.init_cache(4, M3_STEPS)
    dec = torch.cat([step(params, c2, head[:, t:t + 1], t)[0]
                     for t in range(M3_STEPS)], dim=1)
    bound = lm_bf16_bound(fwd)
    gap = lm_max_diff(dec, fwd)
    if not gap <= bound:
        fail(f"path m3: decode logits differ from forward by {gap} (bound "
             f"{bound})")
    peak = torch.cuda.max_memory_allocated()
    parts = ss.plan_parts(step.mm, "decode", 4, 1 + M3_STEPS,
                          cache_struct=step.mm.model.init_cache(
                              4, 1 + M3_STEPS))
    held = sum(ShardStore(mesh).resident_bytes({"p": params}).values())
    experts = 3 * cfg.moe.n_experts * cfg.d_model * cfg.moe.d_ff_expert
    print(f"path m3: llama4-maverick-400b-a17b at full width, 1 of "
          f"{full.n_layers} layers ({experts / 1e9:.1f} B expert weights), "
          f"{held / 1e9:.2f} GB of bf16 pieces on a (1, 4) mesh of the card, "
          f"experts over model: drawn and cut in {build_s:.1f} s; {M3_STEPS} "
          f"greedy steps at batch 4 {tps:.2f} tok/s, ids in range; bf16 "
          f"decode-forward gap {gap:.4f} (tolerance {bound:.4f}); "
          f"max_memory_allocated {peak / 1e9:.2f} GB against the plan's "
          f"{sum(parts.values()) * 4 / 1e9:.2f} GB (4 positions x "
          f"{sum(parts.values()) / 1e9:.3f}); {card}", flush=True)
    del step, params, cache, fwd, dec, c2
    torch.cuda.empty_cache()


def mesh_m4(card) -> None:
    """m4: ``pipeline_apply``, 4 stages on a (1, 4) mesh of the card, 8
    microbatches of 16 x 4,096 in float32, against the direct
    composition within 1e-5."""
    from repro_torch.distributed.pipeline_parallel import (bubble_fraction,
                                                           pipeline_apply)
    from repro_torch.launch.mesh import make_debug_mesh
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    ws = torch.randn((M4_STAGES, M4_D, M4_D), generator=gen,
                     device="cuda") / M4_D ** 0.5
    xs = torch.randn((M4_MICRO, M4_MB, M4_D), generator=gen, device="cuda")

    def stage(w, x):
        return torch.tanh(x @ w["w"])
    mesh = make_debug_mesh(1, M4_STAGES)
    pipeline_apply(mesh, stage, {"w": ws}, xs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = pipeline_apply(mesh, stage, {"w": ws}, xs)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    y = xs
    for s in range(M4_STAGES):
        y = torch.tanh(y @ ws[s])
    err = lm_max_diff(got, y)
    if not err <= 1e-5:
        fail(f"path m4: pipeline_apply differs from the composition by {err}")
    print(f"path m4: pipeline_apply {M4_STAGES} stages x {M4_MICRO} "
          f"microbatches of {M4_MB} x {M4_D} float32 on a (1, {M4_STAGES}) "
          f"mesh of the card: {ms:.2f} ms warm, == the direct composition "
          f"within {err:.2e} (1e-5); bubble fraction "
          f"{bubble_fraction(M4_STAGES, M4_MICRO):.4f}; {card}", flush=True)


def mesh_m5(card) -> None:
    """m5: lm-12m saved after 2 steps on the (2, 4) mesh, restored with
    ``remesh_and_restore(..., n_surviving=4, model_parallel=2)``: every
    leaf bit for bit; 2 further steps give an uninterrupted 4-step run's
    losses."""
    import dataclasses
    import shutil
    import tempfile
    from repro_torch.configs.common import ShapeConfig
    from repro_torch.data.pipeline import TokenBatcher
    from repro_torch.distributed.sharding import gather, tree_items
    from repro_torch.examples.train_lm import SMALL
    from repro_torch.launch import input_specs
    from repro_torch.launch import steps as steps_mod
    from repro_torch.launch.elastic import remesh_and_restore
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.train import train
    from repro_torch.optim import optimizers as opt
    cfg = dataclasses.replace(SMALL, dtype="float32")
    shape = ShapeConfig("m5", 256, 8, "train")
    kw = dict(log_every=0, use_pim_selector=False,
              mesh=make_debug_mesh(*MESH_LM))
    _, _, full = train(cfg, shape, steps=4,
                       generator=torch.Generator().manual_seed(SEED), **kw)
    root = Path(__file__).resolve().parent
    ckdir = tempfile.mkdtemp(prefix=".smoke_ckpt_", dir=root)
    try:
        params, state, _ = train(
            cfg, shape, steps=2, ckpt_dir=ckdir, ckpt_every=2,
            generator=torch.Generator().manual_seed(SEED), **kw)
        p_struct = input_specs.params_struct(cfg)
        o_struct = opt.make_optimizer(cfg.optimizer)[0](p_struct)
        t0 = time.perf_counter()
        step, p2, o2, mesh2 = remesh_and_restore(
            ckdir, cfg, shape, 4, p_struct, o_struct, model_parallel=2)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    n = 0
    for (path, a), (_, b) in zip(tree_items({"params": p2, "opt": o2}),
                                 tree_items({"params": params,
                                             "opt": state})):
        x, y = gather(a), gather(b)
        if x.dtype != y.dtype or not torch.equal(x, y):
            fail(f"path m5: restored leaf {path} differs from the saved one")
        n += 1
    fn = steps_mod.build_train_step(cfg, shape, mesh=mesh2).fn
    batcher = TokenBatcher(cfg.vocab, shape.global_batch, shape.seq_len, None)
    batcher.cursor = step
    losses = []
    for _ in range(2):
        batch = steps_mod.to_device(batcher.next_batch(), "cuda")
        p2, o2, m = fn(p2, o2, batch)
        losses.append(float(m["loss"]))
    rel = float(np.max(np.abs(np.asarray(losses) - full[2:])
                       / np.abs(full[2:])))
    if not rel <= 1e-5:
        fail(f"path m5: resumed losses {losses} against {full[2:]} (rtol "
             "1e-5)")
    print(f"path m5: lm-12m saved at step 2 on {MESH_LM}, restored onto the "
          f"{mesh2.shape} mesh of 4 survivors in {restore_s:.2f} s, {n} "
          f"leaves bit for bit; steps 3-4 within {rel:.2e} of the "
          f"uninterrupted losses (rtol 1e-5); {card}", flush=True)


def collect_dryruns(dry) -> None:
    """m6: the background dry-run's cells: GB a position, fits (80 GB),
    FLOPs a position and the dominant roofline term, each cell's wall."""
    runs, t_start = dry
    cells, rcs, texts = [], [], []
    for proc, out in runs:
        rcs.append(proc.wait(timeout=900))
        out.seek(0)
        texts.append(out.read())
        out.close()
        cells += [json.loads(ln[5:]) for ln in texts[-1].splitlines()
                  if ln.startswith("CELL ")]
    if any(rcs) or len(cells) != len(DRYRUN_CELLS):
        fail(f"path m6: the dry-run processes exited {rcs} with {len(cells)} "
             f"of {len(DRYRUN_CELLS)} cells:\n" + "\n".join(
                 t[-2000:] for t in texts))
    print("path m6 arch                       shape        mesh      GB/pos  "
          "fits   TFLOP/pos  dominant    compute_s  memory_s  coll_s  "
          "method        wall_s", flush=True)
    for d in cells:
        if d["status"] == "skipped":
            print(f"m6   {d['arch']:26s} {d['shape']:12s} {d['mesh']:8s} "
                  f"skipped: {d['reason'][:60]}", flush=True)
            continue
        if d["status"] != "ok":
            fail(f"path m6 {d['arch']} {d['shape']}: {d}")
        fc, rl = d["full_compile"], d["roofline"]
        print(f"m6   {d['arch']:26s} {d['shape']:12s} {d['mesh']:8s} "
              f"{fc['bytes_per_device'] / 1e9:8.2f} {str(fc['fits']):6s} "
              f"{d['costs']['flops_per_dev'] / 1e12:10.3f}  "
              f"{rl['dominant']:10s} {rl['compute_s']:9.4f} "
              f"{rl['memory_s']:9.4f} {rl['collective_s']:7.4f}  "
              f"{d['roofline_method']:12s} {d['wall_s']:7.1f}", flush=True)
    print(f"path m6: {len(cells)} dry-run cells on fake tensors (H100 "
          f"constants) in {len(runs)} processes beside the card's paths; "
          f"{time.perf_counter() - t_start:.1f} s from their start to here",
          flush=True)


def phase_mesh_lm(card, dry) -> dict:
    """Path m: the mesh and dry-run tooling on the card (m1-m5), and the
    dry-run cells (m6). Only m1's admission launches kernels of the table
    (``eq_imm``/``cmp_imm``, as l1's). Returns the path's launches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    t_path = time.perf_counter()
    reset_launches()
    times = {}
    for name, fn in (("m1", mesh_m1), ("m2", mesh_m2), ("m3", mesh_m3),
                     ("m4", mesh_m4), ("m5", mesh_m5)):
        t0 = time.perf_counter()
        fn(card)
        times[name] = round(time.perf_counter() - t0, 1)
    launches = read_launches()
    others = {k: v for k, v in launches.items()
              if k not in ("eq_imm", "cmp_imm") and v}
    if others:
        fail(f"path m launched {launches}: want eq_imm and cmp_imm only")
    t0 = time.perf_counter()
    collect_dryruns(dry)
    times["m6 wait"] = round(time.perf_counter() - t0, 1)
    print(f"phase 4m ok: qwen2-0.5b trained and served on a {MESH_LM} mesh "
          f"of the card, llama4-maverick at full width served with its "
          f"experts over model, pipeline and elastic restore checked, "
          f"{len(DRYRUN_CELLS)} dry-run cells; launches {launches}; seconds "
          f"{times}; {time.perf_counter() - t_path:.1f} s", flush=True)
    return {"launches": launches}


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
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}",
          flush=True)

    dry = start_dryruns()
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
    path_j = phase_mesh_path(db, path_a, path_b, flush, peaks)
    ex_launches = phase_example()
    phase_lm(card)
    path_l = phase_train(card)
    path_m = phase_mesh_lm(card, dry)
    j_launches = {k: v + ex_launches[k]
                  for k, v in path_j["launches"].items()}
    phase_cost_model(db, path_a["results"], eager)
    fused = fused_entry([path_a, path_b, path_f, path_g], peaks)
    fused["max_abs_err"] = max(worst, fused["max_abs_err"],
                               path_j["worst"])
    fused["launches"] += h_launches["fused_program"] + \
        i_launches["fused_program"] + j_launches["fused_program"]
    mat["launches"] += mat_f + g_launches["materialize"] + \
        h_launches["materialize"] + i_launches["materialize"] + \
        j_launches["materialize"]
    mat["max_abs_err"] = max(mat_worst, mat["max_abs_err"], g_mat_worst,
                             path_j["worst"])
    for c in cols:
        c["launches"] += (g_launches[c["name"]] + h_launches[c["name"]]
                          + i_launches[c["name"]] + j_launches[c["name"]])
        c["max_abs_err"] = max(col_worst, c["max_abs_err"])
    for a in api:
        a["launches"] += (eager_launches[a["name"]] + g_launches[a["name"]]
                          + h_launches[a["name"]] + i_launches[a["name"]]
                          + j_launches[a["name"]]
                          + path_l["launches"][a["name"]]
                          + path_m["launches"][a["name"]])
        a["max_abs_err"] = max(
            a["max_abs_err"], filt_worst["filter_sum"]
            if a["name"] == "filter_sum" else max(filt_worst["filter"],
                                                  eager_worst,
                                                  g_eager_worst,
                                                  path_l["worst"]))
    print(json.dumps({"kernels": [fused, mat, *cols, *api]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
