"""Port: the query compiler emits the reference's instruction streams.

For every relation program of the 19 TPC-H specs (34 programs), the
port's ``Compiler`` — a copy pointed at the port's engine — must emit an
instruction stream equal field by field to ``repro.db.compiler``'s, with
equal canonical predicate hashes and Table-4 cycle counts.
"""
import dataclasses

import pytest

from repro_torch.db import compiler as tc
from repro_torch.db import database as tdb
from repro_torch.db import queries as tq
from repro_torch.db import tpch as ttpch

SF, SEED = 0.002, 123


@pytest.fixture(scope="module")
def tables():
    return ttpch.generate(sf=SF, seed=SEED)


@pytest.fixture(scope="module")
def dbs(tables):
    pytest.importorskip("jax")
    from repro.db import database as rdb
    return tdb.PimDatabase(tables, device="cpu"), rdb.PimDatabase(tables)


def _programs(db, spec):
    for rel_name, pred in spec.filters.items():
        c, mask_reg, groups = db._compile_relation(db.relations[rel_name],
                                                   spec, pred)
        yield rel_name, pred, c.program, mask_reg, groups


def test_thirty_four_relation_programs():
    assert len(tq.all_queries()) == 19
    assert sum(len(s.filters) for s in tq.all_queries()) == 34


@pytest.mark.parametrize("qname", [q.name for q in tq.all_queries()])
def test_instruction_streams_equal_reference(dbs, qname):
    from repro.db import compiler as rc
    from repro.db import queries as rq
    tdb_, rdb_ = dbs
    mine = list(_programs(tdb_, tq.get_query(qname)))
    theirs = list(_programs(rdb_, rq.get_query(qname)))
    assert [m[0] for m in mine] == [t[0] for t in theirs]
    for (rel, tpred, tprog, tmask, tgroups), (_, rpred, rprog, rmask,
                                               rgroups) in zip(mine, theirs):
        assert tc.canonical_hash(tpred) == rc.canonical_hash(rpred), rel
        assert tc.struct_key(tc.canonicalize(tpred)) == \
            rc.struct_key(rc.canonicalize(rpred))
        assert (tmask, tgroups) == (rmask, rgroups)
        assert len(tprog) == len(rprog) > 0
        for a, b in zip(tprog, rprog):
            assert type(a).__name__ == type(b).__name__
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
            assert a.cycles() == b.cycles()
            assert a.row_write_ops() == b.row_write_ops()
