"""Shared helpers: cells at a size a CPU test run holds, run on the CPU."""
import functools
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

SF = 0.002
SEED = 2 ** 31 + 17


def cell(name, sf=SF):
    from pimbench.run import load_cell
    bench, cell, config, traffic = load_cell(name)
    return bench, cell, dict(config, scale_factor=sf), traffic


@functools.lru_cache(maxsize=None)
def tables(sf=SF, seed=SEED):
    from pimbench import tpch_gen
    t = tpch_gen.generate(sf=sf, seed=seed)
    for cols in t.values():
        for v in cols.values():
            v.flags.writeable = False
    return t


SECONDS = 1.5


def run_small(cell_name, hook=None, controls=False, only=None):
    """``harness.run_cell`` of a cell at sf 0.002 on the CPU, with two
    clients, for ``SECONDS``; ``only`` keeps those templates of the mix."""
    from pimbench import control, harness
    _, the_cell, config, traffic = cell(cell_name)
    traffic = dict(traffic, clients=2)
    if only is not None:
        traffic = dict(traffic, templates=[
            t for t in traffic["templates"] if t["query"] in only])
    if cell_name == "sf1-refresh-mixed":
        # 150 orders a refresh at sf 0.002, so one refresh moves answers.
        traffic = dict(traffic, refresh=dict(traffic["refresh"],
                                             orders_per_sf=75_000))
    return harness.run_cell(
        the_cell, config, traffic, SEED, SECONDS, False, device="cpu",
        program_hook=hook,
        controls=control.controls_for(traffic) if controls else None)


def sound(checks, failed):
    return failed == 0 and not any(checks.values())
