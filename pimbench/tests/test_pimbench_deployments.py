"""A configuration's deployment module (``pimbench/deployments/<name>.py``):
the ``tpch`` one is what a configuration without a ``"deployment"`` key
runs, and a deployment may hand the program's services what it needs, run
tasks in the window and add checks, but never take the place of a base
check. Probe deployments are installed under ``pimbench.deployments`` by
these tests alone."""
import asyncio
import sys
import types

import numpy as np
import pytest

from pimbench import harness, run as run_py, tpch_gen
from pimbench.deployments import tpch
from pimbench.tests import _small


@pytest.mark.parametrize("seed", [7, _small.SEED])
def test_tpch_generates_what_the_frozen_generator_does(seed):
    _, _, config, _ = _small.cell("sf1-filter-streams")
    got = tpch.generate(config, seed)
    want = tpch_gen.generate(sf=_small.SF, seed=seed)
    assert list(got) == list(want)
    for rel, cols in want.items():
        assert list(got[rel]) == list(cols)
        for name, v in cols.items():
            assert got[rel][name].dtype == v.dtype
            np.testing.assert_array_equal(got[rel][name], v)


def test_a_configuration_without_a_deployment_runs_tpch():
    _, _, config, _ = _small.cell("sf1-filter-streams")
    assert "deployment" not in config
    assert harness.deployment_of(config) is tpch


def _probe(name, **functions):
    """A deployment ``name`` that is ``tpch`` but for ``functions``."""
    mod = types.ModuleType(f"pimbench.deployments.{name}")
    for fn in ("generate", "load", "service_kwargs", "window_tasks",
               "checks"):
        setattr(mod, fn, functions.get(fn, getattr(tpch, fn)))
    return mod


@pytest.fixture
def install(monkeypatch):
    def put(name, **functions):
        monkeypatch.setitem(sys.modules, f"pimbench.deployments.{name}",
                            _probe(name, **functions))
    return put


def _run(deployment):
    """The filter cell's Q1, Q6 and Q22_sub at sf 0.002 on the CPU, two
    closed-loop clients, under ``deployment``."""
    _, cell, config, traffic = _small.cell("sf1-filter-streams-32")
    traffic = dict(traffic, clients=2, templates=[
        t for t in traffic["templates"] if t["query"] in ("Q1", "Q6",
                                                         "Q22_sub")])
    return harness.run_cell(cell, dict(config, deployment=deployment),
                            traffic, _small.SEED, _small.SECONDS, False,
                            device="cpu")


def test_a_deployment_drives_a_fault_manager_and_scrubs_in_the_window(
        install):
    from repro_torch.faults import FaultManager
    managers = {}

    def load(tables, config, device):
        db = tpch.load(tables, config, device)
        fm = FaultManager(db)
        for rel in ("orders", "lineitem"):
            fm.guard_relation(rel)
        managers[id(db)] = fm
        return db

    def service_kwargs(db, config):
        return {"fault_manager": managers[id(db)]}

    def window_tasks(svc, db, config, t_end, record):
        async def scrub_twice():
            record["scrubs"] = []
            for _ in range(2):
                await asyncio.sleep(0.2)
                record["scrubs"].append(await svc.scrub())
        return [scrub_twice()]

    def checks(run):
        (fm,) = managers.values()
        return {"undetected_faults": (len(fm.undetected()), 0)}

    install("probe_guarded", load=load, service_kwargs=service_kwargs,
            window_tasks=window_tasks, checks=checks)
    run, checks, attempted, failed, _ = _run("probe_guarded")
    (fm,) = managers.values()
    assert fm.n_scrubs == 2 and set(fm.guards) == {"orders", "lineitem"}
    assert run.deployment["scrubs"] == [{}, {}]      # nothing corrupt
    assert attempted > 0 and failed == 0
    base = {k: v for k, v in checks.items() if k in run_py.LIMITS}
    assert set(base) >= {"unanswered", "mask_bits_wrong", "agg_wrong",
                         "rows_wrong", "empty_window"}
    assert not any(base.values()), checks
    assert checks["undetected_faults"] == 0
    assert run.limits == {"undetected_faults": 0}
    limits = run_py.limits_of(run)
    assert limits == {**run_py.LIMITS, "undetected_faults": 0}
    assert run_py.is_correct(checks, failed, limits)


def test_a_deployment_check_over_its_limit_makes_the_run_incorrect(install):
    install("probe_failing", checks=lambda run: {"probe_wrong": (1, 0)})
    run, checks, attempted, failed, _ = _run("probe_failing")
    assert attempted > 0 and failed == 0
    assert not any(v for k, v in checks.items() if k in run_py.LIMITS)
    assert checks["probe_wrong"] == 1
    assert not run_py.is_correct(checks, failed, run_py.limits_of(run))


@pytest.mark.parametrize("name", ["agg_wrong", "storage_rows_wrong"])
def test_a_deployment_may_not_name_a_base_check(install, name):
    """``run.py`` refuses a base check's name, whether this cell computes
    it (``agg_wrong``) or only a refresh cell does."""
    install("probe_clash", checks=lambda run: {name: (0, 0)})
    with pytest.raises(ValueError, match=name):
        run, *_ = _run("probe_clash")
        run_py.limits_of(run)
