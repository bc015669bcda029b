"""The comparison fails what it must: each control (a reference that
breaks a stated guarantee) judged in the program's place, at a CPU
size, while the program itself passes."""
import pytest

from pimbench.tests._small import run_small as _run, sound as _sound

# Queries whose answers leave float32's mantissa at sf 0.002: a short
# window under load still answers some of them.
EXACT_SUMS = {"sf1-filter-streams": ("Q1", "Q6", "Q22_sub"),
              "sf1-filter-streams-32": ("Q1", "Q6", "Q22_sub"),
              "sf1-refresh-mixed": ("Q1", "Q6", "Q22_sub"),
              "sf1-join-streams": ("Q3", "Q10", "Q14")}


@pytest.mark.parametrize("cell_name", sorted(EXACT_SUMS))
def test_program_is_sound_and_every_control_fails(cell_name):
    run, checks, attempted, failed, _ = _run(cell_name, controls=True,
                                             only=EXACT_SUMS[cell_name])
    assert attempted > 0 and _sound(checks, failed), checks
    for name, nums in run.controls.items():
        assert nums["judged"] > 0
        assert nums["records_wrong"] > 0, (name, nums)
    if cell_name == "sf1-join-streams":
        assert run.controls["float32"]["rows_wrong"] > 0
    else:
        assert run.controls["float32"]["agg_wrong"] > 0
    if cell_name == "sf1-refresh-mixed":
        stale = run.controls["stale"]
        assert stale["mask_bits_wrong"] + stale["agg_wrong"] > 0
