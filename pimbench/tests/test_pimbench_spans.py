"""The readers of the program's spans (``repro_torch.core.spans``).

On the CPU a traced run of each cell at sf 0.002 reports every span
metric in the cells ``BENCHMARK.json`` lists it for and in no other; each
time lies inside the window; an untraced run records no span, and its
result line holds the end-to-end metrics alone. On a card every
``fused_program`` kernel of a short traced run lies inside a
``db.launch`` span: the spans and the device trace share one clock."""
import pytest

from pimbench import harness
from pimbench.run import cell_metrics
from pimbench.tests import _small

CELLS = ("sf1-filter-streams", "sf1-refresh-mixed", "sf1-join-streams")
SPAN_METRICS = ("queue_wait_ms", "host_queue_ms", "compile_ms", "readback_ms",
                "readback_bytes_per_query", "unpack_ms", "selectivity_ms",
                "publish_ms")


def _run(cell_name, trace, device="cpu", sf=_small.SF, seconds=_small.SECONDS):
    from repro_torch.core import spans
    bench, cell, config, traffic = _small.cell(cell_name, sf=sf)
    traffic = dict(traffic, clients=2)
    spans.clear()
    out = harness.run_cell(cell, config, traffic, _small.SEED, seconds,
                           trace, device=device)
    return bench, cell, out


def _entries(bench):
    by_name = {m["name"]: m for m in bench["per_layer"]}
    return [by_name[n] for n in SPAN_METRICS]


@pytest.fixture(scope="module")
def traced():
    """Each cell's traced run with its span metrics and its result line's
    per-layer metrics, read before the next run clears the spans."""
    from repro_torch.core import program as prog
    out = {}
    for c in CELLS:
        bench, cell, res = _run(c, True)
        out[c] = (bench, res, harness.read_metrics(res[0], _entries(bench)),
                  harness.read_metrics(res[0], cell_metrics(bench, cell,
                                                            True)))
    # Leave the process's tape cache no warmer than these runs found it:
    # later tests in this process time their windows cold.
    prog._FN_CACHE.clear()
    return out


@pytest.mark.parametrize("cell_name", CELLS)
def test_a_traced_run_reports_each_span_metric_where_listed(traced,
                                                             cell_name):
    bench, (run, checks, attempted, failed, _), got, reported = \
        traced[cell_name]
    assert attempted > 0 and _small.sound(checks, failed), checks
    listed = {m["name"] for m in _entries(bench)
              if cell_name in m["workloads"]}
    assert set(got) == listed
    assert {k: v for k, v in reported.items() if k in listed} == got
    window_ms = 1e3 * (run.t_end - run.t_start)
    for name, v in got.items():
        if name.endswith("_ms"):
            assert 0 < v["value"] <= window_ms, (name, v)
        else:
            assert v["value"] > 0 and v["unit"] == "bytes/query"


def test_an_untraced_run_records_no_span_and_reports_end_to_end_only():
    from repro_torch.core import spans
    bench, cell, (run, checks, _, failed, _) = _run("sf1-refresh-mixed",
                                                    False)
    assert _small.sound(checks, failed), checks
    assert spans.spans() == []
    assert harness.read_metrics(run, _entries(bench)) == {}
    line = harness.read_metrics(run, cell_metrics(bench, cell, False))
    assert set(line) == {"qps", "refresh_rows_per_s", "setup_s"}


@pytest.mark.cuda
def test_fused_program_kernels_lie_inside_launch_spans(card):
    from repro_torch.core import spans
    _, _, (run, checks, _, failed, _) = _run(
        "sf1-filter-streams", True, device=card, sf=0.01, seconds=2.0)
    assert _small.sound(checks, failed), checks
    launches = [s for s in spans.spans() if s.name == "db.launch"]
    kernels = [(s, t) for name, s, t in run.trace.events
               if "fused_program" in name]
    assert kernels and launches
    slack = 2e-4
    for s, t in kernels:
        assert any(sp.start - slack <= s and t <= sp.end + slack
                   for sp in launches), (s, t)
