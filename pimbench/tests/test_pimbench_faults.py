"""A fault planted underneath a run whose harness runs as on the card,
at a CPU size, makes the run incorrect: half of the records left out,
an answer altered where it is produced, a refreshed relation's records
selected in the right number but not the right ones, a refresh
acknowledged that left the state unchanged. (The exchange between chips does not exist: every
cell runs on one card.)"""
import time

import numpy as np
import pytest

from pimbench.tests._small import run_small as _run, sound as _sound


def _wrap_dispatch(db, alter):
    inner = db.dispatch_batch

    def dispatch_batch(specs):
        pendings, stats = inner(specs)
        alter(pendings)
        return pendings, stats
    db.dispatch_batch = dispatch_batch


def _half_the_records(pendings):
    """Half of every relation's records left out of the answer."""
    for p in pendings:
        if p.result is not None:
            for rr in p.result.relations.values():
                rr.mask = rr.mask.copy()
                rr.mask[rr.mask.size // 2:] = False
        else:
            for rel, t in list(p.materialized.items()):
                p.materialized[rel] = t.take(slice(0, t.n_rows // 2))


def _one_answer_altered(pendings):
    """The first answer of each window altered where it is produced: an
    aggregate or a selection bit on the device stage."""
    p = pendings[0]
    if p.result is not None:
        for group in p.result.aggregates.values():
            for name, v in group.items():
                if isinstance(v, int):
                    group[name] = v + 1
                    return
        for rr in p.result.relations.values():
            rr.mask = rr.mask.copy()
            rr.mask[0] = not rr.mask[0]
            return


def _same_count_other_records(pendings):
    """The refreshed relations' selections moved one slot on: as many
    records as the reference selects, but other ones."""
    for p in pendings:
        if p.result is not None:
            for rel, rr in p.result.relations.items():
                if rel in ("orders", "lineitem"):
                    rr.mask = np.roll(np.asarray(rr.mask, bool), 1)


def _wrap_finish(db):
    """Every end-to-end answer's first row altered where the host stage
    produces it."""
    inner = db.finish_query

    def finish_query(pending):
        res = inner(pending)
        if res.rows:
            row = list(res.rows[0])
            row[-1] = (row[-1] or 0) + 1
            res.rows = [tuple(row)] + list(res.rows[1:])
        return res
    db.finish_query = finish_query


FAULTS = {
    ("sf1-filter-streams", "half"): lambda db: _wrap_dispatch(
        db, _half_the_records),
    ("sf1-filter-streams", "altered"): lambda db: _wrap_dispatch(
        db, _one_answer_altered),
    ("sf1-join-streams", "half"): lambda db: _wrap_dispatch(
        db, _half_the_records),
    ("sf1-join-streams", "altered"): _wrap_finish,
    ("sf1-refresh-mixed", "same_count"): lambda db: _wrap_dispatch(
        db, _same_count_other_records),
}


@pytest.mark.parametrize("cell_name,fault", sorted(FAULTS))
def test_a_fault_in_the_timed_path_makes_the_run_incorrect(cell_name, fault):
    _, checks, _, failed, _ = _run(cell_name, hook=FAULTS[(cell_name, fault)])
    assert not _sound(checks, failed), checks


def test_a_refresh_that_leaves_the_state_unchanged_makes_the_run_incorrect():
    def hook(db):
        def apply(mutations):
            time.sleep(0.05)             # about a real refresh's time here
            return {}                    # acknowledged, nothing applied
        db.apply = apply
    _, checks, _, failed, _ = _run("sf1-refresh-mixed", hook=hook)
    assert checks["refresh_rows_gap"] > 0
    assert checks["storage_rows_wrong"] > 0, checks
    assert checks["mask_bits_wrong"] + checks["agg_wrong"] > 0, checks
    assert not _sound(checks, failed)
