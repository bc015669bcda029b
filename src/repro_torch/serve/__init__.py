"""Async query-serving frontend over cross-query linked dispatches.

The counterpart of ``repro.serve``. ``QueryService.submit(spec)`` ->
awaitable QueryResult; admission windows coalesce concurrent submissions
into one linked dispatch per relation (one ``fused_program`` launch per
relation on the card), a version-keyed result cache answers repeats, and
host stages drain on a worker pool.
"""
from .batcher import AdmissionBatcher  # noqa: F401
from .cache import ResultCache, spec_cache_key  # noqa: F401
from .service import QueryService  # noqa: F401

__all__ = [
    "AdmissionBatcher",
    "QueryService",
    "ResultCache",
    "spec_cache_key",
]
