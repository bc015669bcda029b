"""The TPC-H deployment, the one a configuration without a ``"deployment"``
key runs: the frozen generator's tables loaded into a ``PimDatabase`` with
the configuration's wear policy, a bare ``QueryService``, nothing in the
window beside the clients and the refresh stream, and no checks beyond
the base ones.

A deployment module has these five functions, which ``harness.run_cell``
calls in this order:

* ``generate(config, seed) -> tables``, at set-up, before the arrays are
  frozen read-only; the reference is judged on these tables.
* ``load(tables, config, device) -> db``, at set-up.
* ``service_kwargs(db, config) -> dict``, the keyword arguments of every
  ``QueryService`` the harness builds (warm-up and window).
* ``window_tasks(svc, db, config, t_end, record) -> [coroutine]``, started
  beside the clients and the refresh stream, awaited and cancelled with
  them at the close. ``record`` is a dict that the harness keeps as
  ``Run.deployment``, for the checks and the metric readers.
* ``checks(run) -> {name: (value, limit)}``, after the comparison: added
  to the base checks, never in place of one.
"""
from repro_torch.db.database import PimDatabase

from .. import tpch_gen


def generate(config, seed):
    return tpch_gen.generate(sf=float(config["scale_factor"]), seed=seed)


def load(tables, config, device):
    return PimDatabase({r: dict(c) for r, c in tables.items()}, device=device,
                       wear_policy=config["wear_policy"])


def service_kwargs(db, config):
    return {}


def window_tasks(svc, db, config, t_end, record):
    return []


def checks(run):
    return {}
