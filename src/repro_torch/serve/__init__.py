"""The query-serving front end's result cache.

The counterpart of ``repro.serve``'s first module: the version-keyed
:class:`ResultCache` and its :func:`spec_cache_key`. The service and its
admission batcher are not ported yet (ROADMAP A12).
"""
from .cache import ResultCache, spec_cache_key  # noqa: F401

__all__ = ["ResultCache", "spec_cache_key"]
