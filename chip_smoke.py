"""Quickest proof that the PyTorch/CUDA port runs on an NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases (any failure exits non-zero before the last line):

1. Device: require CUDA; print the card's name and power limit.
2. Build: compile ``src/repro_torch/kernels/csrc/fused_program.cu`` with
   nvcc from the checkout's sources; print the seconds and the compiler's
   resource report.
3. Kernel vs plain, TPC-H SF 0.01: the CUDA kernel equals its plain
   PyTorch version (``fused_program_torch``) bit for bit on all 34
   relation programs of the 19 TPC-H specs, on two MIN/MAX programs (over
   a derived expression; over an empty selection) and on a multi-block
   relation whose record count is a multiple of neither 32 nor the block.
4. Main path, TPC-H SF 1: ``PimDatabase(tables).execute(spec)`` for the
   19 ``filter_only()`` specs and the two MIN/MAX specs on the FUSED
   engine, every mask and aggregate equal to ``Engine.ORACLE``; the
   kernel's launch count must equal the number of relation programs run.
   Then, for each of those programs at its SF 1 shape, the kernel against
   its plain version bit for bit (masks, popcounts and per-block MIN/MAX
   candidates), and per query: the warm median of ``execute`` and the
   kernel's own time (CUDA events), the stacking copy, the bound and what
   sets it, and the tapes' length and slot count.
5. One ``{"kernels": [...]}`` JSON line, then ``{"ok": true, ...}`` last.

Seeds fix the data; nothing is read from outside the checkout.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
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
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/fused_program.cu"
REPLACES = "src/repro/kernels/program.py:147"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int, flush: torch.Tensor | None = None) -> float:
    """Median milliseconds of ``fn`` between two CUDA events, after one
    warm-up call; ``flush`` is overwritten before each timed call so the
    50 MB L2 cache starts cold."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
    t = cp.tape.block
    if n % 32 == 0 or n % t == 0 or rel.layout.n_words <= t:
        fail(f"multi-block case is not ragged: n={n}, block={t}")
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


def phase_main_path(peaks):
    """The 19 specs and the two MIN/MAX specs at SF 1 on FUSED, checked
    against ORACLE; then kernel vs plain at every program's SF 1 shape and
    the per-query and per-kernel timings. Returns the kernels entry."""
    from repro_torch.core import program as prog
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
    for spec, fused in zip(run, results):
        oracle = db.execute(spec, engine=D.Engine.ORACLE)
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

    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    per_prog = {}
    worst = 0
    for name, rel, cp in programs(db, run):
        stacked = prog.stack_sources(cp, rel)
        diff = max_abs_diff(kp.fused_program(stacked, cp.tape),
                            kp.fused_program_torch(stacked, cp.tape))
        if diff:
            fail(f"kernel != plain on {name}/{rel.name} at SF {MAIN_SF}: "
                 f"max abs diff {diff}")
        worst = max(worst, diff)
        w = stacked.shape[1]
        logic, popc = cp.tape.word_ops()
        per_prog.setdefault(name, []).append({
            "relation": rel.name,
            "kernel_ms": cuda_ms(lambda: kp.fused_program(stacked, cp.tape),
                                 5, flush),
            "plain_ms": cuda_ms(
                lambda: kp.fused_program_torch(stacked, cp.tape), 2),
            "stack_ms": cuda_ms(lambda: prog.stack_sources(cp, rel), 5,
                                flush),
            "bytes": (cp.tape.n_rows + cp.tape.n_masks) * w * 4,
            "logic": logic * w, "popc": popc * w,
            "tape_len": len(cp.tape), "n_slots": cp.tape.n_slots,
            "block": cp.tape.block})
    print(f"phase 4 ok: kernel == plain on {sum(map(len, per_prog.values()))}"
          f" programs at SF {MAIN_SF}", flush=True)

    print("query   execute_ms  kernel_ms busy_%  stack_ms   plain_ms  "
          "bound_ms bound_by   tape_len/n_slots/block per relation")
    for spec in run:
        ps = per_prog[spec.name]
        exec_ms = cuda_ms(lambda: db.execute(spec), 3)
        kernel_ms = sum(p["kernel_ms"] for p in ps)
        bounds = [bound_s(p["bytes"], p["logic"], p["popc"], peaks)
                  for p in ps]
        by = {b for _, b in bounds}
        print(f"{spec.name:9s} {exec_ms:11.3f} {kernel_ms:10.4f} "
              f"{100 * kernel_ms / exec_ms:6.2f} "
              f"{sum(p['stack_ms'] for p in ps):9.4f} "
              f"{sum(p['plain_ms'] for p in ps):10.3f} "
              f"{sum(b for b, _ in bounds) * 1e3:9.5f} "
              f"{by.pop() if len(by) == 1 else 'mixed':10s} "
              + " ".join(f"{p['relation']}:{p['tape_len']}/{p['n_slots']}/"
                         f"{p['block']}" for p in ps), flush=True)
    for name in ("Q6", "Q12"):
        host_profile(db, next(s for s in specs if s.name == name))

    progs = [p for ps in per_prog.values() for p in ps]
    total_s, total_by = bound_s(sum(p["bytes"] for p in progs),
                                sum(p["logic"] for p in progs),
                                sum(p["popc"] for p in progs), peaks)
    return {"name": "fused_program", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": REPLACES,
            "launches": launches, "max_abs_err": worst,
            "ms": sum(p["kernel_ms"] for p in progs),
            "plain_ms": sum(p["plain_ms"] for p in progs),
            "bound_ms": total_s * 1e3, "bound_by": total_by,
            "library_ms": None}


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an "
             "NVIDIA GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import program as kp

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}",
          flush=True)

    t0 = time.perf_counter()
    lib = kp.build_library()
    print(f"phase 2 ok: built {lib.name} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(lib.with_suffix(".log").read_text().strip(), flush=True)

    worst = phase_kernel_vs_plain()
    entry = phase_main_path(peak_ops_per_s())
    entry["max_abs_err"] = max(worst, entry["max_abs_err"])
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
