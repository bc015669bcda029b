"""Query front end, TPC-H data and the PimDatabase entry point.

Public surface: ``PimDatabase.execute`` with :class:`Engine` and
:class:`QueryResult` is the query API, :func:`cost_report` the paper-scale
projection of a result.
"""
from .database import (  # noqa: F401
    Engine,
    PimDatabase,
    QueryResult,
    avg_value,
    cost_report,
)

__all__ = ["Engine", "PimDatabase", "QueryResult", "avg_value",
           "cost_report"]
