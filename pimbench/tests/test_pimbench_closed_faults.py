"""The closed-loop filter cell (``sf1-filter-streams-32``) judges what its
timed path produces as the open-loop one does: half of the records left
out, or an answer altered where it is produced, makes the run incorrect
(the faults of ``test_pimbench_faults.py``, planted under this cell)."""
import pytest

from pimbench.tests._small import run_small as _run, sound as _sound
from pimbench.tests.test_pimbench_faults import (_half_the_records,
                                                 _one_answer_altered,
                                                 _wrap_dispatch)


@pytest.mark.parametrize("alter", [_half_the_records, _one_answer_altered],
                         ids=["half", "altered"])
def test_a_fault_in_the_closed_loop_filter_cell_makes_it_incorrect(alter):
    _, checks, attempted, failed, _ = _run(
        "sf1-filter-streams-32", hook=lambda db: _wrap_dispatch(db, alter))
    assert attempted > 0 and not _sound(checks, failed), checks
