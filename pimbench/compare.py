"""The comparison that decides ``correct``.

Every query submitted in the window is judged: its answer against the
reference's at the state it may have seen. In a read-only cell that is the
one state; in the refresh cell a query may see any state from the last
refresh acknowledged before it was submitted to the last one begun before
its answer came, and it is judged at the state among those where it
differs least (a query that saw an acknowledged refresh too late differs
at every one of them).

Numbers, each with the limit 0 (the configuration's answers are exact):

* ``unanswered``: queries that reached the program, and refreshes of the
  window, that raised or gave no answer within 60 s of the close;
* ``mask_bits_wrong``: record slots whose selection bit differs, over
  every mask. A relation the refreshes do not touch holds generated row
  ``r`` in slot ``r`` (the rows are loaded in order); for a mutable one,
  :func:`locate` finds the slot of each of the reference's rows from the
  rows the program stores after the window, and the reference's
  selection is laid out in those slots;
* ``storage_rows_wrong``: of a mutable relation after the last refresh,
  rows the reference holds that the program does not store (or stores
  altered), and rows the program keeps valid that the reference does not
  hold: every acknowledged insert read back, every delete gone;
* ``agg_wrong``: aggregate values unequal (or missing, or extra);
* ``rows_wrong``: end-to-end result rows unequal (or missing, or extra);
* ``refresh_rows_gap``: rows a refresh changed by the program's count
  against the reference's, summed;
* ``empty_window``: 1 when no query completed in the window.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np


def _mask_diff(got: np.ndarray, ref: np.ndarray) -> int:
    n = min(got.size, ref.size)
    return (int(np.count_nonzero(got[:n] != ref[:n]))
            + int(np.count_nonzero(got[n:])) + int(np.count_nonzero(ref[n:])))


def _agg_diff(got: Dict, ref: Dict) -> int:
    wrong = 0
    for label in set(got) | set(ref):
        g, r = got.get(label), ref.get(label)
        if g is None or r is None:
            wrong += len(g or r or {}) or 1
            continue
        for name in set(g) | set(r):
            if name not in g or name not in r or g[name] != r[name]:
                wrong += 1
    return wrong


def _rows_diff(got: Dict, ref: Dict) -> int:
    if tuple(got["columns"]) != tuple(ref["columns"]):
        return max(len(got["rows"]), len(ref["rows"]), 1)
    n = min(len(got["rows"]), len(ref["rows"]))
    wrong = sum(1 for i in range(n)
                if tuple(got["rows"][i]) != tuple(ref["rows"][i]))
    return wrong + abs(len(got["rows"]) - len(ref["rows"]))


def _row_hash(cols: Sequence[np.ndarray]) -> np.ndarray:
    h = np.full(len(cols[0]), 0x9E3779B97F4A7C15, np.uint64)
    for c in cols:
        h ^= np.asarray(c).astype(np.uint64)
        h *= np.uint64(0xBF58476D1CE4E5B9)
        h ^= h >> np.uint64(31)
    return h


def locate(ref: Dict[str, np.ndarray], n_base: int, live: np.ndarray,
           stored: Dict[str, np.ndarray], valid: np.ndarray
           ) -> Tuple[np.ndarray, int]:
    """Where the program keeps each reference row of one mutable relation,
    from the rows it stores once the last refresh is applied: ``(slot,
    wrong)``, ``slot[r]`` the slot of reference row ``r`` (-1 where it is
    not found) and ``wrong`` the ``storage_rows_wrong`` of the relation.

    ``ref`` is the reference's rows (the ``n_base`` generated ones first,
    then every inserted one), ``live`` those present at the last state.
    A generated row stays in the slot it was loaded into, and a refresh
    never moves a row, so an inserted row is found by its content among
    the valid slots that do not hold their generated row."""
    names = sorted(ref)
    n_ref, n_slots = len(live), len(valid)
    slot = np.full(n_ref, -1, np.int64)
    nb = min(n_base, n_slots)
    slot[:nb] = np.arange(nb)
    same = valid[:nb].copy()
    for c in names:
        same &= stored[c][:nb] == ref[c][:nb]
    wrong = (int(np.count_nonzero(live[:n_base]))
             - int(np.count_nonzero(live[:nb] & same))      # lost or altered
             + int(np.count_nonzero(~live[:nb] & same)))    # deleted, visible
    claimed = np.zeros(n_slots, bool)
    claimed[:nb] = same
    cand = np.flatnonzero(valid & ~claimed)
    new = np.flatnonzero(live[n_base:]) + n_base
    free: Dict[int, List[int]] = {}
    for h, s in zip(_row_hash([stored[c][cand] for c in names]).tolist(),
                    cand.tolist()):
        free.setdefault(h, []).append(s)
    for h, r in zip(_row_hash([ref[c][new] for c in names]).tolist(),
                    new.tolist()):
        if free.get(h):
            slot[r] = free[h].pop()
    found = new[slot[new] >= 0]
    same = np.ones(found.size, bool)
    for c in names:
        same &= stored[c][slot[found]] == ref[c][found]
    slot[found[~same]] = -1
    claimed[slot[found[same]]] = True
    wrong += (new.size - int(np.count_nonzero(same))        # not read back
              + int(np.count_nonzero(valid & ~claimed)))    # extra rows
    return slot, wrong


def to_slots(mask: np.ndarray, slot: np.ndarray, n_slots: int) -> Tuple[
        np.ndarray, int]:
    """A selection over reference rows laid out in the program's slots;
    also the number of selected rows that have no slot."""
    s = slot[np.flatnonzero(mask)]
    out = np.zeros(max(n_slots, int(s.max()) + 1 if s.size else 0), bool)
    out[s[s >= 0]] = True
    return out, int(np.count_nonzero(s < 0))


def answer_in_slots(ans: Dict, slots: Dict[str, np.ndarray]) -> Dict:
    """A reference answer with the masks of mutable relations laid out in
    the program's slots (a control put in the program's place)."""
    if "masks" not in ans or not slots:
        return ans
    masks = dict(ans["masks"])
    for rel, slot in slots.items():
        if rel in masks:
            masks[rel] = to_slots(masks[rel], slot, 0)[0]
    return dict(ans, masks=masks)


def diff(got: Dict, ref: Dict, slots: Dict[str, np.ndarray] = {}
         ) -> Dict[str, int]:
    """The numbers by which one answer departs from the reference's;
    ``slots`` ({mutable relation: slot of each reference row}) lays the
    reference's masks of those relations out as the program stores them."""
    out = {"mask_bits_wrong": 0, "agg_wrong": 0, "rows_wrong": 0}
    if "rows" in ref:
        out["rows_wrong"] = _rows_diff(got, ref)
        return out
    gm, rm = got.get("masks", {}), ref["masks"]
    for rel in set(gm) | set(rm):
        if rel not in gm or rel not in rm:
            out["mask_bits_wrong"] += int(np.count_nonzero(
                gm.get(rel, rm.get(rel)))) or 1
            continue
        g, want = np.asarray(gm[rel], bool), rm[rel]
        if rel in slots:
            want, lost = to_slots(want, slots[rel], g.size)
            out["mask_bits_wrong"] += lost
        out["mask_bits_wrong"] += _mask_diff(g, want)
    out["agg_wrong"] = _agg_diff(got.get("aggs", {}), ref["aggs"])
    return out


def judge(records: List, answer_of: Callable, reference_at: Callable,
          slots: Dict[str, np.ndarray] = {}, threads: int = 4
          ) -> Tuple[Dict[str, int], int, Dict[Tuple[str, int], dict]]:
    """Judge every answered record. ``answer_of(rec)`` is the answer to
    judge, ``reference_at(q, state)`` the reference's; ``rec.states`` the
    states it may have seen; ``slots`` as :func:`diff` takes it. Returns (numbers, records wrong, the
    reference's answers by (query key, state))."""
    need = {}
    for rec in records:
        if rec.answered:
            for s in rec.states:
                need[(rec.q.key, s)] = rec.q
    with ThreadPoolExecutor(max_workers=threads) as pool:
        futs = {k: pool.submit(reference_at, q, k[1])
                for k, q in need.items()}
        refs = {k: f.result() for k, f in futs.items()}
    totals = {k: 0 for k in ("mask_bits_wrong", "agg_wrong", "rows_wrong")}
    n_wrong = 0
    for rec in records:
        if not rec.answered:
            continue
        got = answer_of(rec)
        best = None
        for s in rec.states:
            d = diff(got, refs[(rec.q.key, s)], slots)
            if best is None or sum(d.values()) < sum(best.values()):
                best = d
        if any(best.values()):
            n_wrong += 1
        for k, v in best.items():
            totals[k] += v
    return totals, n_wrong, refs
