"""On a card: a short traced run of each cell is correct and its trace
holds the kernels the cell drives."""
import pytest

from pimbench import harness
from pimbench.run import cell_metrics
from pimbench.tests import _small


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", ["sf1-filter-streams",
                                       "sf1-refresh-mixed",
                                       "sf1-join-streams",
                                       "sf1-filter-streams-32"])
def test_a_short_traced_run_on_the_card_is_correct(card, cell_name):
    bench, cell, config, traffic = _small.cell(cell_name, sf=0.01)
    run, checks, attempted, failed, dev = harness.run_cell(
        cell, config, traffic, _small.SEED, 1.0, True, device=card)
    assert attempted > 0 and failed == 0 and not any(checks.values()), checks
    assert dev["platform"] == "gpu" and 0 < dev["busy_s"] <= dev["window_s"]
    assert run.trace.kernel_count("fused_program") > 0
    metrics = harness.read_metrics(run, cell_metrics(bench, cell, True))
    assert 0 < metrics["fused_program_roofline"]["value"] <= 100
