"""The guarded TPC-H deployment (configuration ``tpch-sf1-guarded``): the
``tpch`` tables and database, every device relation guarded by the
program's ``FaultManager``, and device faults injected in rounds while the
query streams run (TPC-H 3.0.1 Clause 3.5, which induces each failure it
lists a stated number of times and sets no rate).

The configuration's ``faults`` key is the plan: the guarded relations,
the number of rounds in the window, and per round the number of cell
flips, ghost valid-bit flips, stuck-at-1 cells and dispatch outages. The
``FaultManager`` keeps the program's default retry policy, circuit
breaker and endurance budget; an outage is as many queued transient
dispatch faults as it takes to trip that breaker (``outage_faults``). A
round is one job on the program's dispatch thread,
``QueryService.scrub(inject=strike)``: the strike injects the round's
faults, then the scrub finds and repairs them before any query window
runs. The rounds fall at 1/(n+1), 2/(n+1), ... of the window; they are
an open loop: each is called at its time, whatever the dispatch thread
is doing, and runs in that thread's order.

Where a round's faults land (drawn from ``--seed`` and the round):

* cell flips in the data planes of live rows, each flip's relation and
  attribute in proportion to the planes x words they store, its plane and
  live slot uniformly; no (relation, attribute, slot) twice in a round,
  since two flips of one slot's planes cancel in its parity;
* ghost valid-bit flips and stuck-at-1 cells in lineitem's empty slots
  past its last row, on distinct slots and never on a slot an earlier
  stuck cell retired: a hard fault is repaired by retiring its slot, and
  no row moves (the comparison judges a read-only relation's masks with
  generated row ``r`` in slot ``r``).

``load`` runs one warm-up round at set-up (a strike and its scrub, then
every template under ``pimbench/queries`` in the PIM scope until the
round's dispatch faults are used up and the breaker is closed again), so
the EAGER engine's one-off costs are set-up. ``checks`` holds the program
to the fault semantics from the deployment's own plan, the scrub reports
the program returned, and the planes read back from the card after the
window, never from the ``FaultManager``'s own bookkeeping:

* ``faults_undetected``: planned faults missing from their round's scrub
  report;
* ``faults_false_alarms``: reported coordinates that no round injected;
* ``faults_misclassified``: a flip reported hard, or a stuck cell
  reported soft;
* ``guarded_rows_wrong``: after the window, rows of a guarded relation
  whose values read back from its bit-planes differ from the generated
  rows (or whose valid bit is clear), and empty slots up to the capacity
  whose valid bit is set.

Each limit is 0. ``Run.deployment`` keeps every round's plan, report and
counters (``rounds``, the warm-up first), and ``checks`` prints a
summary line to standard error.
"""
from __future__ import annotations

import asyncio
import inspect
import sys
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.faults import DeviceFaultModel, FaultManager
from repro_torch.faults.guard import VALID
from repro_torch.serve import QueryService

from .. import adapter, templates
from . import tpch

STREAM = 3105        # the fault plan's own random stream, beside --seed
MAX_WARMUP_PASSES = 6

# The deployment's functions are handed nothing of each other's but the
# tables and the database: the seed goes from ``generate`` to ``load``, and
# the deployment's state from ``load`` to the window, keyed by the object
# handed on and popped where it is taken.
_SEEDS: Dict[int, int] = {}
_LOADED: Dict[int, dict] = {}


def generate(config, seed):
    tables = tpch.generate(config, seed)
    _SEEDS[id(tables)] = int(seed)
    return tables


def load(tables, config, device):
    if "inject" not in inspect.signature(QueryService.scrub).parameters:
        raise RuntimeError(
            "this program's QueryService.scrub takes no inject=: it cannot "
            "inject a round's faults and scrub them as one job on the "
            "dispatch thread, which the tpch-guarded deployment needs")
    seed = _SEEDS.pop(id(tables))
    plan = config["faults"]
    db = tpch.load(tables, config, device)
    fm = FaultManager(db, model=DeviceFaultModel(seed=seed))
    for rel in plan["guarded"]:
        fm.guard_relation(rel)
    state = {"fm": fm, "tables": tables, "seed": seed, "plan": plan,
             "layout": layout_of(db, tables, plan["guarded"]),
             "retired": set(), "open": None}
    state["warmup"] = asyncio.run(_warmup_round(db, state))
    _LOADED[id(db)] = state
    return db


def service_kwargs(db, config):
    return {"fault_manager": _LOADED[id(db)]["fm"]}


def window_tasks(svc, db, config, t_end, record):
    state = _LOADED.pop(id(db))
    n = int(state["plan"]["rounds"])
    t0 = time.perf_counter()
    record["rounds"] = [state["warmup"]]
    record["live"] = state
    state.update(db=db, svc=svc)

    async def call(rec):
        rec["report"] = plain_report(
            await svc.scrub(inject=_strike(state, svc, rec)))
        rec["t_done"] = time.perf_counter()

    async def rounds():
        calls = []
        for k in range(1, n + 1):
            due = t0 + k * (t_end - t0) / (n + 1)
            await asyncio.sleep(max(0.0, due - time.perf_counter()))
            rec = {"k": k, "warmup": False, "t_call": time.perf_counter()}
            record["rounds"].append(rec)
            calls.append(asyncio.ensure_future(call(rec)))
        await asyncio.gather(*calls)

    return [rounds()]


def checks(run):
    d = run.deployment
    live = d.pop("live")
    fm, svc = live["fm"], live["svc"]
    if live["open"] is not None:
        _close_round(live["open"], svc, fm)
    d["breaker_at_close"] = fm.breaker.state
    rounds = d["rounds"]
    out = fault_checks(rounds)
    out["guarded_rows_wrong"] = sum(
        rows_wrong(live["tables"][rel], *stored_slots(live["db"], rel))
        for rel in live["plan"]["guarded"])
    print(summary(rounds, d["breaker_at_close"]), file=sys.stderr)
    return {name: (value, 0) for name, value in out.items()}


# -- the plan -----------------------------------------------------------------
def layout_of(db, tables, guarded) -> Dict[str, dict]:
    """Per guarded relation: rows generated, words a plane, slots reserved,
    and each attribute's planes."""
    out = {}
    for rel in guarded:
        d = db.dml_state(rel)
        out[rel] = {"n_rows": len(next(iter(tables[rel].values()))),
                    "words": int(d.rel.layout.n_words),
                    "capacity": int(d.capacity),
                    "attrs": {a: int(p.shape[0])
                              for a, p in d.rel.planes.items()}}
    return out


def plan_round(layout, plan, seed: int, k: int, retired) -> dict:
    """Round ``k``'s faults (0 is the warm-up). ``retired``: slots of
    lineitem that earlier stuck cells retired, which no fault may hit."""
    rng = np.random.default_rng([seed, STREAM, k])
    pool = [(rel, a, nb) for rel in plan["guarded"]
            for a, nb in layout[rel]["attrs"].items()]
    weight = np.array([nb * layout[rel]["words"] for rel, _, nb in pool],
                      float)
    flips, hit = [], set()
    while len(flips) < int(plan["cell_flips"]):
        rel, a, nb = pool[int(rng.choice(len(pool), p=weight / weight.sum()))]
        slot = int(rng.integers(layout[rel]["n_rows"]))
        plane = int(rng.integers(nb))
        if (rel, a, slot) not in hit:
            hit.add((rel, a, slot))
            flips.append([rel, a, slot, plane])
    li = layout["lineitem"]
    taken = set(retired)

    def empty_slot() -> int:
        while True:
            s = int(rng.integers(li["n_rows"], li["capacity"]))
            if s not in taken:
                taken.add(s)
                return s

    ghosts = [["lineitem", VALID, empty_slot()]
              for _ in range(int(plan["ghost_valid_flips"]))]
    attrs = list(li["attrs"].items())
    bits = np.array([nb for _, nb in attrs], float)
    stuck = []
    for _ in range(int(plan["stuck_cells"])):
        a, nb = attrs[int(rng.choice(len(attrs), p=bits / bits.sum()))]
        stuck.append(["lineitem", a, empty_slot(), int(rng.integers(nb))])
    return {"flips": flips, "ghosts": ghosts, "stuck": stuck,
            "dispatch_outages": int(plan["dispatch_outages"])}


def outage_faults(fm) -> int:
    """Transient dispatch faults in one outage: every attempt of
    ``failure_threshold`` windows in a row fails, so each exhausts its
    retries and the breaker trips."""
    return (fm.retry.max_retries + 1) * fm.breaker.failure_threshold


def _strike(state, svc, rec):
    """The round's injection, run on the dispatch thread just before its
    scrub: it closes the round before (its counters now), then injects."""
    fm = state["fm"]

    def strike():
        rec["t_inject"] = time.perf_counter()
        if state["open"] is not None:
            _close_round(state["open"], svc, fm)
        state["open"] = rec
        rec["before"] = _counters(svc, fm)
        p = plan_round(state["layout"], state["plan"], state["seed"],
                       rec["k"], state["retired"])
        p["dispatch_faults"] = p["dispatch_outages"] * outage_faults(fm)
        rec["plan"] = p
        for rel, a, slot, plane in p["flips"]:
            fm.inject_flip(rel, a, slot, plane)
        for rel, a, slot in p["ghosts"]:
            fm.inject_flip(rel, a, slot, 0)
        for rel, a, slot, plane in p["stuck"]:
            fm.inject_stuck(rel, a, slot, plane, 1)
            state["retired"].add(slot)
        fm.model.inject_dispatch_faults(p["dispatch_faults"])
    return strike


def _counters(svc, fm) -> dict:
    return {"eager_windows": svc.n_degraded_windows,
            "trips": fm.breaker.n_trips,
            "recoveries": fm.breaker.n_recoveries,
            "transient_faults": svc.n_transient_faults}


def _close_round(rec, svc, fm) -> None:
    """What the round's dispatch faults did, up to now: windows on EAGER,
    trips, recoveries; ``used_up`` once none is queued and the breaker is
    closed again."""
    now = _counters(svc, fm)
    for key, v in now.items():
        rec[key] = v - rec["before"][key]
    rec["faults_left"] = fm.model.dispatch_faults_queued
    rec["breaker"] = fm.breaker.state
    rec["used_up"] = rec["faults_left"] == 0 and rec["breaker"] == "closed"


async def _warmup_round(db, state) -> dict:
    fm = state["fm"]
    temps = [templates.load_template(p.stem)
             for p in sorted(templates.QUERY_DIR.glob("*.json"))]
    rng = np.random.default_rng([state["seed"], STREAM, 0])
    rec = {"k": 0, "warmup": True, "t_call": time.perf_counter()}
    async with QueryService(db, fault_manager=fm) as svc:
        rec["report"] = plain_report(
            await svc.scrub(inject=_strike(state, svc, rec)))
        rec["t_done"] = time.perf_counter()
        for _ in range(MAX_WARMUP_PASSES):
            if fm.model.dispatch_faults_queued == 0 \
                    and fm.breaker.state == "closed":
                break
            qs = [templates.bind(t, "pim", templates.draw_params(t, rng))
                  for t in temps]
            await asyncio.gather(*[svc.submit(adapter.query_spec(q))
                                   for q in qs])
        _close_round(rec, svc, fm)
    state["open"] = None
    if not rec["used_up"]:
        raise RuntimeError(f"the warm-up round's dispatch faults were not "
                           f"used up: {rec}")
    return rec


def plain_report(report) -> Dict[str, dict]:
    """A scrub report as plain lists: ``{relation: {"corrupt": [[plane,
    slot], ...], "soft": [slot, ...], "hard": [slot, ...]}}``."""
    return {rel: {"corrupt": [[a, int(s)] for a, s in r["corrupt"]],
                  "soft": [int(s) for s in r["soft"]],
                  "hard": [int(s) for s in r["hard"]]}
            for rel, r in report.items()}


# -- the checks ---------------------------------------------------------------
def _planned(rec) -> List[tuple]:
    """(relation, plane, slot, hard) of every cell fault the round planned."""
    p = rec.get("plan")
    if p is None:           # a round called whose job never ran
        return []
    return ([(rel, a, s, False) for rel, a, s, _ in p["flips"]]
            + [(rel, a, s, False) for rel, a, s in p["ghosts"]]
            + [(rel, a, s, True) for rel, a, s, _ in p["stuck"]])


def fault_checks(rounds) -> Dict[str, int]:
    """``faults_undetected``, ``faults_false_alarms`` and
    ``faults_misclassified`` over every round's plan and scrub report."""
    undetected = misclassified = 0
    planned, reported = set(), set()
    for rec in rounds:
        rep = rec.get("report", {})
        for rel, r in rep.items():
            reported |= {(rel, a, s) for a, s in r["corrupt"]}
        for rel, a, s, hard in _planned(rec):
            planned.add((rel, a, s))
            r = rep.get(rel, {"corrupt": [], "soft": [], "hard": []})
            if [a, s] not in r["corrupt"]:
                undetected += 1
            elif (s in r["soft"]) if hard else (s in r["hard"]):
                misclassified += 1
    return {"faults_undetected": undetected,
            "faults_false_alarms": len(reported - planned),
            "faults_misclassified": misclassified}


def stored_slots(db, rel: str):
    """What the card stores for ``rel``: its rows' values up to the
    watermark (``adapter.stored_rows``), and the valid bit of every slot
    up to the capacity, read back from the bit-planes."""
    cols, _ = adapter.stored_rows(db, rel)
    r = db.relations[rel]
    cap = int(r.layout.n_words) * 32
    valid = adapter._unpack(r.valid.cpu().numpy()[None], cap).astype(bool)
    return cols, valid


def rows_wrong(generated: Dict[str, np.ndarray],
               stored: Dict[str, np.ndarray], valid: np.ndarray) -> int:
    """Generated rows the card does not store as they are (a value
    altered, the valid bit clear, past the watermark, an attribute
    missing), plus empty slots whose valid bit is set."""
    n = len(next(iter(generated.values())))
    m = min(n, min((len(v) for v in stored.values()), default=0))
    bad = np.ones(n, bool)
    bad[:m] = False
    for a, g in generated.items():
        v = stored.get(a)
        if v is None:
            bad[:] = True
            break
        bad[:m] |= np.asarray(v[:m]) != np.asarray(g[:m])
    k = min(n, valid.size)
    bad[:k] |= ~valid[:k]
    bad[k:] = True
    return int(np.count_nonzero(bad)) + int(np.count_nonzero(valid[n:]))


def summary(rounds, breaker_at_close: Optional[str]) -> str:
    window = [r for r in rounds if not r["warmup"]]
    planned = sum(len(_planned(r)) for r in rounds)
    found = sum(len(r["corrupt"]) for rec in rounds
                for r in rec.get("report", {}).values())

    def each(key):
        return ",".join(str(r.get(key, "-")) for r in window)
    return (f"faults rounds={len(rounds)} window_rounds={len(window)} "
            f"planned={planned} reported={found} "
            f"used_up={sum(1 for r in window if r.get('used_up'))}/"
            f"{len(window)} eager_windows={each('eager_windows')} "
            f"trips={each('trips')} recoveries={each('recoveries')} "
            f"breaker_at_close={breaker_at_close}")
